"""Port parity for MultiLayerNetwork (deeplearning4j_tpu_torch/nn/
multilayer.py) on zoo LeNet (1x28x28, 10 classes, batch 8) against the
JAX reference: both built by their own zoo classes through ``list()``,
the reference's initial parameters carried into the port by
``load_reference_params`` (``params_from_reference``); inputs are seeded
numpy float32.

Tolerances (f32):
- output max abs 1e-6; loss rel 1e-5; each gradient rel L2 1e-4 (the
  convolutions and the dense products sum in another order).
- 5 Adam steps through ``fit(DataSetIterator(shuffle=True))``: each
  step's loss rel 1e-5, every parameter within 1e-4 of its tensor's
  max-abs, and the batch order equal to the reference's.
- bf16 compute (fp32 master weights): loss rel 1e-2 and each gradient
  rel L2 5e-2. The two frameworks round the bf16 conv/matmul outputs at
  different places (observed: loss equal, gradients up to 2.0e-2 rel L2).
"""

import numpy as np
import pytest
import torch

import jax

import deeplearning4j_tpu.zoo as JZ
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.dataset import DataSetIterator as JIterator
from deeplearning4j_tpu.ndarray import DataType as JDataType
import deeplearning4j_tpu_torch.nn as P
import deeplearning4j_tpu_torch.zoo as PZ
from deeplearning4j_tpu_torch.ndarray import INDArray
from deeplearning4j_tpu_torch.data import DataSet, DataSetIterator
from deeplearning4j_tpu_torch.nn.multilayer import params_to_reference

torch.set_num_threads(1)

B, CLASSES = 8, 10


def data(n=B, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 784)).astype(np.float32)
    y = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, n)]
    return x, y


def pair(dtype_name="FLOAT"):
    jn = JZ.LeNet(numClasses=CLASSES,
                  dataType=getattr(JDataType, dtype_name)).init()
    pn = PZ.LeNet(numClasses=CLASSES, dataType=getattr(P.DataType,
                                                       dtype_name),
                  device="cpu").init()
    pn.load_reference_params(jax.tree.map(np.asarray, jn._params),
                             jax.tree.map(np.asarray, jn._states))
    return jn, pn


def rel_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.fixture(scope="module")
def f32_pair():
    return pair()


def test_lenet_output_loss_and_gradients_match(f32_pair):
    jn, pn = f32_pair
    x, y = data()
    jg, js = jn.computeGradientAndScore(x, y)
    pg, ps = pn.computeGradientAndScore(x, y)
    assert abs(ps - js) <= 1e-5 * abs(js)
    got = params_to_reference(pn.layers, pg)
    assert len(got) == len(jg) == 6
    for i, (want, g) in enumerate(zip(jg, got)):
        assert set(want) == set(g), i
        for k in want:
            assert rel_l2(g[k], want[k]) <= 1e-4, (i, k, rel_l2(g[k],
                                                                want[k]))
    out = pn.output(x)
    assert isinstance(out, INDArray) and out.shape() == (B, CLASSES)
    np.testing.assert_allclose(out.toNumpy(), np.asarray(jn.output(x).toNumpy()),
                               rtol=0, atol=1e-6)
    assert pn.numParams() == jn.numParams()


class Recording:
    """Wraps an iterator: records each batch's features and, at each
    ``next``, the network's score (the loss of the step before it)."""

    def __init__(self, it, net):
        self.it, self.net = it, net
        self.batches, self.scores = [], []

    def reset(self):
        self.it.reset()

    def hasNext(self):
        return self.it.hasNext()

    def next(self):
        self.scores.append(self.net.score())
        ds = self.it.next()
        f = ds.getFeatures()
        self.batches.append(np.asarray(f.toNumpy() if hasattr(f, "toNumpy")
                                       else f))
        return ds


def test_lenet_adam_trajectory_through_iterator_matches():
    jn, pn = pair()
    x, y = data(5 * B - 3, seed=1)    # a ragged last batch, padded
    jr = Recording(JIterator(x, y, B, shuffle=True, seed=7), jn)
    pr = Recording(DataSetIterator(x, y, B, shuffle=True, seed=7), pn)
    jn.fit(jr)
    pn.fit(pr)
    assert len(pr.batches) == len(jr.batches) == 5
    for a, b in zip(pr.batches, jr.batches):
        np.testing.assert_array_equal(a, b)
    jl = jr.scores[1:] + [jn.score()]
    pl = pr.scores[1:] + [pn.score()]
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=0)
    assert pn.getIterationCount() == jn.getIterationCount() == 5
    assert pn.getEpochCount() == 1
    got = params_to_reference(pn.layers, pn._params)
    for want, g in zip(jax.tree.map(np.asarray, jn._params), got):
        for k in want:
            w = np.asarray(want[k], np.float64)
            assert np.abs(g[k] - w).max() <= 1e-4 * np.abs(w).max(), k
    # fit(DataSet) and score(DataSet) in inference mode
    np.testing.assert_allclose(pn.score(DataSet(*data(seed=2))),
                               jn.score(JDataSet(*data(seed=2))), rtol=1e-5)


def test_lenet_list_conf_matches_the_reference_chain():
    """``list()`` infers the same InputType chain and inserts the same
    preprocessors: FeedForwardToCnn before the first conv (the
    convolutionalFlat input), CnnToFeedForward before the dense layer."""
    jc = JZ.LeNet(numClasses=CLASSES).conf()
    pc = PZ.LeNet(numClasses=CLASSES).conf()
    assert [(t.kind, t.dims) for t in pc.layerInputTypes] == \
        [(t.kind, t.dims) for t in jc.layerInputTypes]
    assert {i: type(p).__name__ for i, p in pc.preprocessors.items()} == \
        {i: type(p).__name__ for i, p in jc.preprocessors.items()} == \
        {0: "FeedForwardToCnnPreProcessor", 4: "CnnToFeedForwardPreProcessor"}
    assert [l.nIn for l in pc.layers if hasattr(l, "nIn")] == \
        [l.nIn for l in jc.layers if hasattr(l, "nIn")]
    assert (pc.outputType.kind, pc.outputType.dims) == \
        (jc.outputType.kind, jc.outputType.dims)


def test_lenet_bf16_matches():
    jn, pn = pair("BFLOAT16")
    x, y = data()
    jg, js = jn.computeGradientAndScore(x, y)
    pg, ps = pn.computeGradientAndScore(x, y)
    assert pn._params[0]["W"].dtype == torch.float32   # fp32 master
    assert abs(ps - js) <= 1e-2 * abs(js), (ps, js)
    for want, g in zip(jg, params_to_reference(pn.layers, pg)):
        for k in want:
            assert rel_l2(g[k], np.asarray(want[k], np.float32)) <= 5e-2, k
    assert pn.output(x).tensor().dtype == torch.bfloat16


def test_multilayer_entry_points():
    """The device policy; fit's accepted inputs; the later slices."""
    conf = PZ.LeNet().conf()
    if torch.cuda.is_available():
        assert P.MultiLayerNetwork(conf).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            P.MultiLayerNetwork(conf)
    net = P.MultiLayerNetwork(conf, device="cpu").init()
    with pytest.raises(TypeError, match="DataSetIterator"):
        net.fit(object())
    # layerwise pretraining is ported (the nn-conf slice): LeNet has no
    # pretrainable layer, and asking for one is the reference's refusal
    with pytest.raises(ValueError, match="pretrainable"):
        net.pretrainLayer(0, np.zeros((1, 1, 28, 28), np.float32))
    # the line-search solvers are ported (the data and fine-tuning
    # slice): an unknown algorithm is the reference's refusal
    assert (P.NeuralNetConfiguration.Builder().optimizationAlgo("lbfgs")
            ._d["optimizationAlgo"] == "LBFGS")
    with pytest.raises(ValueError, match="unknown OptimizationAlgorithm"):
        P.NeuralNetConfiguration.Builder().optimizationAlgo("newton")
    # fitSteps / fitDataSet are ported (training-runtime slice): the
    # reference's refusals
    with pytest.raises(ValueError, match="stepsPerSync must be >= 1"):
        net.fitDataSet(None, stepsPerSync=0)
