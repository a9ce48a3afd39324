"""The port's weight-only int8 inference against the reference's
(``deeplearning4j_tpu/nn/quantize.py``): ``q`` and the scales, carried
to the reference's layout, equal the reference's bit for bit (each
weight quantized along its own output axis: OIHW conv, a
deconvolution's [in, out, kh, kw], dense [in, out]); the int8 forward's
logits are within 1e-5 relative of the reference's int8 forward.
Mirrors ``tests/test_quantize.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deeplearning4j_tpu.nn import quantize as jq
from deeplearning4j_tpu_torch.nn import quantize as pq
from deeplearning4j_tpu_torch.nn.multilayer import params_to_reference

from _torch_parity import pair, rel

torch.set_num_threads(1)


def test_leaf_quantization_matches_the_reference():
    rng = np.random.RandomState(0)
    for w in (rng.randn(16, 8).astype("float32") * 3.0,
              np.zeros((4, 4), np.float32),
              np.array([1.0, -2.0, 0.5], np.float32),
              rng.randn(3, 3, 2, 5).astype("float32")):
        jqv, jsv = jq.quantize_leaf_int8(jnp.asarray(w))
        q, s = pq.quantize_leaf_int8(torch.from_numpy(w))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
        np.testing.assert_array_equal(s.numpy().reshape(-1),
                                      np.asarray(jsv).reshape(-1))
        deq = q.float() * s
        assert (deq - torch.from_numpy(w)).abs().max() <= s.max() / 2 + 1e-7


def _qcnn(M):
    return (M.NeuralNetConfiguration.Builder().seed(2).activation("relu")
            .list()
            .layer(M.ConvolutionLayer(nOut=6, kernelSize=(3, 3),
                                      stride=(1, 1)))
            .layer(M.BatchNormalization())
            .layer(M.Deconvolution2D(nOut=4, kernelSize=(2, 2),
                                     stride=(2, 2)))
            .layer(M.SubsamplingLayer(kernelSize=(2, 2), stride=(2, 2)))
            .layer(M.DenseLayer(nOut=32))
            .layer(M.OutputLayer(nOut=5, activation="softmax",
                                 lossFunction="MCXENT"))
            .setInputType(M.InputType.convolutional(10, 10, 2)).build())


def test_network_quantization_matches_the_reference_bitwise():
    """Per output channel on each weight's own axis: OIHW conv (axis 0),
    a deconvolution's [in, out, kh, kw] (axis 1), dense [in, out]."""
    jn, pn = pair(_qcnn)
    jqp, jsc = jq.quantize_params_int8(jn._params)
    qp, sc = pq.int8_infer_fn(pn)[1:]
    # q carried to the reference's layout, and each scale flattened
    got_q = params_to_reference(pn.layers, [
        {k: t.float() if t.dtype == torch.int8 else t for k, t in p.items()}
        for p in qp])
    for i, (jp, js) in enumerate(zip(jqp, jsc)):
        for k in jp:
            want = np.asarray(jp[k])
            np.testing.assert_array_equal(got_q[i][k].astype(want.dtype),
                                          want)
            assert (qp[i][k].dtype == torch.int8) == (want.dtype == np.int8)
            np.testing.assert_array_equal(sc[i][k].numpy().reshape(-1),
                                          np.asarray(js[k]).reshape(-1))
    assert pq.param_bytes(qp) == jq.param_bytes(jqp)
    assert pq.param_bytes(pn._params) == jq.param_bytes(jn._params)


def test_int8_forward_matches_the_reference_int8_forward():
    jn, pn = pair(_qcnn)
    x = np.random.RandomState(3).rand(8, 2, 10, 10).astype("float32")
    jinfer, jqp, jsc = jq.int8_infer_fn(jn)
    want = np.asarray(jinfer(jqp, jsc, jnp.asarray(x)))
    infer, qp, sc = pq.int8_infer_fn(pn)
    got = infer(qp, sc, torch.from_numpy(x)).numpy()
    assert rel(got, want) <= 1e-5
    # int8 weights move the logits a little off the f32 forward
    o32 = pn.output(x).toNumpy()
    assert np.mean(got.argmax(-1) == o32.argmax(-1)) >= 0.75
    deq = pq.dequantize_params(qp, sc, torch.float32)
    assert deq[0]["W"].dtype == torch.float32
    assert qp[1]["gamma"].dtype == torch.float32   # vectors pass through
