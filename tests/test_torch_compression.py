"""The port's compression codecs and int8 quantization against the
reference's (deeplearning4j_tpu_torch.ndarray.compression vs
deeplearning4j_tpu.ndarray.compression), on the CPU.

Mirrors tests/test_compression.py. Each codec's payload (and sidecar)
equals the reference's byte for byte on the same input, size-0 inputs
and all-below-threshold inputs included; decompress gives the
reference's array exactly. ``threshold_encode_fixed`` equals the
reference's (lax.top_k) on inputs with tied magnitudes: same indices in
the same order, values, dense message and residual, bitwise. The int8
weight quantizer matches the reference's q and scale exactly, and a
trained port network keeps its predictions under Int8Inference.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.ndarray import compression as JC
from deeplearning4j_tpu.ndarray import Nd4j as JNd4j
from deeplearning4j_tpu_torch.ndarray import compression as PC
from deeplearning4j_tpu_torch.ndarray import (
    BasicNDArrayCompressor, CompressedNDArray, Int8Inference, Nd4j,
)

torch.set_num_threads(2)
CPU = "cpu"


def payload_bytes(ca):
    p = ca.payload
    return p if isinstance(p, bytes) else np.ascontiguousarray(p).tobytes()


def extra_bytes(ca):
    e = ca.extra
    if e is None:
        return b""
    if isinstance(e, dict):
        return b"".join(k.encode() + np.asarray(e[k]).tobytes()
                        for k in sorted(e))
    return np.asarray(e).tobytes()


INPUTS = {
    "randn": np.random.RandomState(0).randn(17, 9).astype(np.float32),
    "f64": np.random.RandomState(1).randn(5, 4),
    "zeros": np.zeros((64, 64), np.float32),
    "empty": np.zeros((0, 3), np.float32),
    "ints": np.random.RandomState(2).randint(-5, 5, (10, 10)),
    "ties": np.array([0.5, -0.5, 0.25, 0.5, -0.25, 0.0], np.float32),
    "below": np.full((4,), 1e-5, np.float32),
}
CASES = [(algo, name) for algo in ("GZIP", "FLOAT16", "INT8", "THRESHOLD",
                                   "NOOP")
         for name in INPUTS
         if not (algo in ("FLOAT16", "INT8", "THRESHOLD") and name == "ints")]


class TestCodecs:
    def setup_method(self):
        self.c = Nd4j.getCompressor()
        self.c.setDefaultCompression("GZIP")
        self.jc = JNd4j.getCompressor()
        self.jc.setDefaultCompression("GZIP")

    def test_singleton_and_catalog(self):
        assert self.c is BasicNDArrayCompressor.getInstance()
        assert self.c.getAvailableCompressors() == \
            self.jc.getAvailableCompressors()

    @pytest.mark.parametrize("algo,name", CASES)
    def test_payload_equals_reference_bytewise(self, algo, name):
        x = INPUTS[name]
        threshold = 0.3
        ca = self.c.compress(Nd4j.create(x, device=CPU, dtype=x.dtype),
                             algo, threshold=threshold)
        ja = self.jc.compress(x, algo, threshold=threshold)
        assert isinstance(ca, CompressedNDArray) and ca.isCompressed()
        assert (ca.algo, ca.shape, ca.dtype) == (ja.algo, ja.shape, ja.dtype)
        assert payload_bytes(ca) == payload_bytes(ja)
        assert extra_bytes(ca) == extra_bytes(ja)
        assert ca.compressedBytes() == ja.compressedBytes()
        assert ca.ratio() == ja.ratio()
        back = self.c.decompress(ca, device=CPU).toNumpy()
        want = self.jc.decompress(ja).toNumpy()
        assert back.dtype == want.dtype
        np.testing.assert_array_equal(back, want)

    def test_cross_decompress(self):
        x = INPUTS["randn"]
        for algo in ("GZIP", "FLOAT16", "INT8", "THRESHOLD", "NOOP"):
            ja = self.jc.compress(x, algo)
            np.testing.assert_array_equal(
                self.c.decompress(ja, device=CPU).toNumpy(),
                self.jc.decompress(ja).toNumpy())

    def test_bounded_loss_and_ratios(self):
        x = np.random.RandomState(1).randn(64, 16).astype("float32")
        ca = self.c.compress(torch.from_numpy(x), "INT8")
        back = self.c.decompress(ca, device=CPU).toNumpy()
        step = np.abs(x).max() / 127.0
        assert np.abs(back - x).max() <= step / 2 + 1e-7
        assert ca.ratio() == pytest.approx(0.25, abs=0.01)
        assert self.c.compress(x, "FLOAT16").ratio() == pytest.approx(0.5)
        assert self.c.compress(np.zeros((64, 64), "f4")).ratio() < 0.05

    def test_default_algo_switch_and_errors(self):
        self.c.setDefaultCompression("INT8")
        try:
            assert self.c.getDefaultCompression() == "INT8"
            assert self.c.compress(np.ones((2, 2), "float32")).algo == "INT8"
        finally:
            self.c.setDefaultCompression("GZIP")
        with pytest.raises(ValueError, match="unknown compressor"):
            self.c.setDefaultCompression("LZ4")
        with pytest.raises(ValueError, match="float"):
            self.c.compress(np.ones((2, 2), np.int32), "FLOAT16")
        with pytest.raises(ValueError, match="threshold must be"):
            self.c.compress(np.ones(2, np.float32), "THRESHOLD",
                            threshold=0.0)


@pytest.mark.parametrize("case", ["ties", "all_tied", "random", "zeros",
                                  "cap_all"])
def test_threshold_encode_fixed_equals_reference(case):
    rs = np.random.RandomState(3)
    flat, tau, cap = {
        # tied magnitudes: lax.top_k takes the lower index first
        "ties": (np.array([0.5, -0.5, 0.25, 0.5, -0.25, 0.0, 0.5, -0.1],
                          np.float32), 0.3, 5),
        "all_tied": (np.full(9, -0.75, np.float32), 0.5, 4),
        "random": (rs.randn(1000).astype(np.float32), 1.0, 64),
        "zeros": (np.zeros(16, np.float32), 0.1, 3),
        "cap_all": (np.round(rs.randn(40), 1).astype(np.float32), 0.5, 40),
    }[case]
    ji, jv, jd, jr = JC.threshold_encode_fixed(jnp.asarray(flat),
                                               jnp.asarray(tau, jnp.float32),
                                               cap)
    pi, pv, pd, pr = PC.threshold_encode_fixed(torch.from_numpy(flat),
                                               tau, cap)
    assert pi.dtype == torch.int32
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    for got, want in ((pv, jv), (pd, jd), (pr, jr)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal((pd + pr).numpy(), flat)
    assert PC.threshold_cap(len(flat), 0.1) == JC.threshold_cap(len(flat),
                                                                0.1)


def test_quantize_dequantize_tree_matches_reference():
    W = np.random.RandomState(0).randn(128, 64).astype("float32")
    W[:, 3] = 0.0    # an all-zero channel takes scale 1
    params = [{"W": W, "b": np.zeros(64, "float32")}]
    jq = JC.quantize_int8(params)
    pq = PC.quantize_int8([{k: torch.from_numpy(v) for k, v in p.items()}
                           for p in params])
    assert isinstance(pq[0]["W"], PC.QLeaf)
    assert pq[0]["W"].q.dtype == torch.int8
    assert not isinstance(pq[0]["b"], PC.QLeaf)
    np.testing.assert_array_equal(pq[0]["W"].q.numpy(),
                                  np.asarray(jq[0]["W"].q))
    np.testing.assert_array_equal(pq[0]["W"].scale.numpy(),
                                  np.asarray(jq[0]["W"].scale))
    np.testing.assert_array_equal(PC.dequantize(pq)[0]["W"].numpy(),
                                  np.asarray(JC.dequantize(jq)[0]["W"]))
    assert PC.quantized_bytes(pq) == tuple(int(v) for v in
                                           JC.quantized_bytes(jq))


def test_quantized_network_accuracy_delta():
    """Train a small classifier, quantize, measure the delta: the int8
    path stays within 2 points of fp32 top-1 and agrees with fp32 on
    >95% of predictions (the reference's bar)."""
    import deeplearning4j_tpu_torch.nn as PN

    rng = np.random.RandomState(0)
    x = rng.randn(512, 10).astype("float32")
    y_idx = np.argmax(x @ rng.randn(10, 4), axis=1)
    y = np.eye(4, dtype="float32")[y_idx]
    conf = (PN.NeuralNetConfiguration.Builder().seed(7)
            .updater(PN.Adam(5e-3)).weightInit(PN.WeightInit.XAVIER)
            .activation("relu").list()
            .layer(PN.DenseLayer(nOut=32))
            .layer(PN.DenseLayer(nOut=16))
            .layer(PN.OutputLayer(nOut=4, activation="softmax",
                                  lossFunction="mcxent"))
            .setInputType(PN.InputType.feedForward(10)).build())
    net = PN.MultiLayerNetwork(conf, device=CPU).init()
    xt = Nd4j.create(x, device=CPU)
    for _ in range(150):
        net.fit(xt, y)
    fp_pred = net.output(xt).argMax(1).toNumpy()
    fp_acc = (fp_pred == y_idx).mean()
    assert fp_acc > 0.9
    q = Int8Inference(net)
    q_pred = q.output(x).argMax(1).toNumpy()
    assert (q_pred == fp_pred).mean() > 0.95
    assert abs((q_pred == y_idx).mean() - fp_acc) < 0.02
    assert q.memoryRatio() < 0.35
