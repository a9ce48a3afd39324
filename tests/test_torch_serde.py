"""Port parity for the model files and the JSON configuration
(deeplearning4j_tpu_torch/util/{serde,serializer,sharded_checkpoint}.py
and the networks' toJson/fromJson, save/load, params/setParams, clone)
against the JAX reference.

Mirrors tests/test_serde.py's ModelSerializer, TrainingCheckpoint,
config-JSON and review-regression cases on the port (the workspace and
profiler cases belong to other slices), then crosses both packages:
a file or JSON string written by either restores in the other, for
LeNet and a ResNet-shaped graph (conv, BN, a residual add, global
pooling; Nesterovs), with and without the updater state.

Tolerances (f32): a round trip inside one package is bit for bit
(outputs, and training resumed from a file against training that never
stopped). Across the packages the arrays carry bit for bit (the conv
HWIO <-> OIHW map is a permutation), so the checkpoint digest of a
carried state is equal in both; outputs of the two frameworks agree to
max-abs 1e-5 and one more training step's loss to rel 1e-5.
"""

import json

import numpy as np
import pytest
import torch

import jax

import deeplearning4j_tpu.nn as J
import deeplearning4j_tpu.zoo as JZ
from deeplearning4j_tpu.util import serde as jserde
from deeplearning4j_tpu.util.serializer import ModelSerializer as JMS
from deeplearning4j_tpu.util.sharded_checkpoint import _net_state as j_state
from deeplearning4j_tpu.util.sharded_checkpoint import \
    state_digest as j_digest
import deeplearning4j_tpu_torch.nn as P
import deeplearning4j_tpu_torch.zoo as PZ
from deeplearning4j_tpu_torch.data import DataSet, NormalizerStandardize
from deeplearning4j_tpu_torch.util import serde
from deeplearning4j_tpu_torch.util.serializer import (
    ModelSerializer, TrainingCheckpoint,
)
from deeplearning4j_tpu_torch.util.sharded_checkpoint import (
    ShardedModelSerializer, _net_state, state_digest,
)

torch.set_num_threads(1)
CPU = "cpu"


def _data(n=32, nin=4, nout=3, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, nin).astype("float32")
    w = rng.randn(nin, nout)
    yi = np.argmax(x @ w, axis=1)
    return x, np.eye(nout, dtype="float32")[yi]


def _mlp_conf(M, seed=42):
    return (M.NeuralNetConfiguration.Builder().seed(seed)
            .updater(M.Adam(1e-2)).weightInit(M.WeightInit.XAVIER)
            .activation("relu").list()
            .layer(M.DenseLayer(nOut=16))
            .layer(M.BatchNormalization())
            .layer(M.OutputLayer(nOut=3, activation="softmax",
                                 lossFunction="mcxent"))
            .setInputType(M.InputType.feedForward(4)).build())


def _cnn_conf(M):
    return (M.NeuralNetConfiguration.Builder().seed(7)
            .updater(M.Nesterovs(0.05, 0.9)).list()
            .layer(M.ConvolutionLayer(kernelSize=(3, 3), nOut=4,
                                      activation="relu"))
            .layer(M.SubsamplingLayer(poolingType="max", kernelSize=(2, 2),
                                      stride=(2, 2)))
            .layer(M.OutputLayer(nOut=3, activation="softmax",
                                 lossFunction="mcxent"))
            .setInputType(M.InputType.convolutional(8, 8, 2)).build())


def _lstm_conf(M):
    return (M.NeuralNetConfiguration.Builder().seed(3)
            .updater(M.Adam(1e-2)).list()
            .layer(M.LSTM(nOut=5, activation="tanh"))
            .layer(M.RnnOutputLayer(nOut=3, activation="softmax",
                                    lossFunction="mcxent"))
            .setInputType(M.InputType.recurrent(4)).build())


def _res_conf(M, updater=None):
    """A ResNet-shaped graph: conv -> BN -> relu, a residual add, global
    pooling, softmax output."""
    return (M.NeuralNetConfiguration.Builder().seed(11)
            .updater(updater or M.Nesterovs(0.1, 0.9)).graphBuilder()
            .addInputs("in")
            .setInputTypes(M.InputType.convolutional(8, 8, 3))
            .addLayer("c1", M.ConvolutionLayer(kernelSize=(3, 3), nOut=4,
                                               convolutionMode="Same",
                                               activation="identity"), "in")
            .addLayer("bn1", M.BatchNormalization(), "c1")
            .addLayer("a1", M.ActivationLayer(activation="relu"), "bn1")
            .addLayer("c2", M.ConvolutionLayer(kernelSize=(3, 3), nOut=4,
                                               convolutionMode="Same",
                                               activation="identity"), "a1")
            .addLayer("bn2", M.BatchNormalization(), "c2")
            .addVertex("add", M.ElementWiseVertex("Add"), "bn2", "a1")
            .addLayer("pool", M.GlobalPoolingLayer(poolingType="avg"), "add")
            .addLayer("out", M.OutputLayer(nOut=3, activation="softmax",
                                           lossFunction="mcxent"), "pool")
            .setOutputs("out").build())


def _img(n=8, c=3, hw=8, classes=3, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, c, hw, hw).astype("float32")
    return x, np.eye(classes, dtype="float32")[rng.randint(0, classes, n)]


def _seq(n=6, f=4, t=5, seed=2):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, f, t).astype("float32")
    y = np.eye(3, dtype="float32")[rng.randint(0, 3, (n, t))]
    return x, y.transpose(0, 2, 1).copy()


def _out(net, x):
    return np.asarray(net.output(x).toNumpy())


# ----------------------------------------------------------------------
# the reference's test_serde.py, on the port
# ----------------------------------------------------------------------

class TestModelSerializerMLN:
    def test_output_round_trip(self, tmp_path):
        x, y = _data()
        net = P.MultiLayerNetwork(_mlp_conf(P), device=CPU).init()
        for _ in range(5):
            net.fit(x, y)
        p = str(tmp_path / "model.npz")
        ModelSerializer.writeModel(net, p)
        net2 = ModelSerializer.restoreMultiLayerNetwork(p, device=CPU)
        np.testing.assert_array_equal(_out(net, x), _out(net2, x))
        assert net2.getIterationCount() == net.getIterationCount()

    def test_resumed_training_is_bit_exact(self, tmp_path):
        x, y = _data()
        ref = P.MultiLayerNetwork(_mlp_conf(P), device=CPU).init()
        for _ in range(10):
            ref.fit(x, y)
        net = P.MultiLayerNetwork(_mlp_conf(P), device=CPU).init()
        for _ in range(5):
            net.fit(x, y)
        p = str(tmp_path / "ckpt.npz")
        ModelSerializer.writeModel(net, p, saveUpdater=True)
        resumed = ModelSerializer.restoreMultiLayerNetwork(p, device=CPU)
        for _ in range(5):
            resumed.fit(x, y)
        np.testing.assert_array_equal(_out(ref, x), _out(resumed, x))

    def test_without_updater_state(self, tmp_path):
        x, y = _data()
        net = P.MultiLayerNetwork(_mlp_conf(P), device=CPU).init()
        net.fit(x, y)
        p = str(tmp_path / "m.npz")
        ModelSerializer.writeModel(net, p, saveUpdater=False)
        net2 = ModelSerializer.restoreMultiLayerNetwork(p, loadUpdater=False,
                                                        device=CPU)
        np.testing.assert_array_equal(_out(net, x), _out(net2, x))
        # a fresh updater: Adam's moments are zero
        assert all(float(t.abs().sum()) == 0.0 for s in net2._upd_states
                   if s for t in s["m"].values())

    def test_normalizer_round_trip(self, tmp_path):
        x, y = _data()
        norm = NormalizerStandardize().fit(DataSet(x, y))
        net = P.MultiLayerNetwork(_mlp_conf(P), device=CPU).init()
        p = str(tmp_path / "m.npz")
        ModelSerializer.writeModel(net, p, normalizer=norm)
        norm2 = ModelSerializer.restoreNormalizer(p)
        np.testing.assert_allclose(norm2._mean, norm._mean)
        np.testing.assert_allclose(norm2._std, norm._std)

    def test_add_normalizer_later(self, tmp_path):
        x, y = _data()
        net = P.MultiLayerNetwork(_mlp_conf(P), device=CPU).init()
        p = str(tmp_path / "m.npz")
        ModelSerializer.writeModel(net, p)
        assert ModelSerializer.restoreNormalizer(p) is None
        norm = NormalizerStandardize().fit(DataSet(x, y))
        ModelSerializer.addNormalizerToModel(p, norm)
        np.testing.assert_allclose(ModelSerializer.restoreNormalizer(p)._mean,
                                   norm._mean)
        net2 = ModelSerializer.restoreMultiLayerNetwork(p, device=CPU)
        np.testing.assert_array_equal(_out(net, x), _out(net2, x))

    def test_wrong_type_raises(self, tmp_path):
        net = P.MultiLayerNetwork(_mlp_conf(P), device=CPU).init()
        p = str(tmp_path / "m.npz")
        ModelSerializer.writeModel(net, p)
        with pytest.raises(ValueError, match="MultiLayerNetwork"):
            ModelSerializer.restoreComputationGraph(p, device=CPU)


class TestModelSerializerCNNAndRNN:
    def test_cnn_round_trip(self, tmp_path):
        x, y = _img(c=2)
        net = P.MultiLayerNetwork(_cnn_conf(P), device=CPU).init()
        for _ in range(3):
            net.fit(x, y)
        p = str(tmp_path / "cnn.npz")
        net.save(p)
        net2 = P.MultiLayerNetwork.load(p, device=CPU)
        np.testing.assert_array_equal(_out(net, x), _out(net2, x))
        net.fit(x, y)
        net2.fit(x, y)
        assert net.score() == net2.score()

    def test_restored_conv_weights_keep_their_layout(self, tmp_path):
        """A restored net lays its conv weights out as init does (LeNet's
        first conv has nIn 1, where two stride sets both count as
        channels_last), so training resumed from a file stays bit for
        bit on the trajectory that never stopped."""
        x, y = _lenet_data()
        a = PZ.LeNet(numClasses=10, device=CPU).init()
        a.fit(x, y)
        p = str(tmp_path / "lenet.npz")
        ModelSerializer.writeModel(a, p)
        b = ModelSerializer.restore(p, device=CPU)
        for pa, pb in zip(a._params, b._params):
            for k in pa:
                assert pa[k].stride() == pb[k].stride(), k
        for _ in range(2):
            a.fit(x, y)
            b.fit(x, y)
            assert a.score() == b.score()

    def test_lstm_round_trip(self, tmp_path):
        x, y = _seq()
        net = P.MultiLayerNetwork(_lstm_conf(P), device=CPU).init()
        for _ in range(3):
            net.fit(x, y)
        p = str(tmp_path / "lstm.npz")
        ModelSerializer.writeModel(net, p)
        net2 = ModelSerializer.restore(p, device=CPU)
        np.testing.assert_array_equal(_out(net, x), _out(net2, x))


class TestModelSerializerCG:
    def test_graph_round_trip(self, tmp_path):
        x, y = _img()
        net = P.ComputationGraph(_res_conf(P), device=CPU).init()
        for _ in range(3):
            net.fit(x, y)
        p = str(tmp_path / "g.npz")
        ModelSerializer.writeModel(net, p)
        net2 = ModelSerializer.restoreComputationGraph(p, device=CPU)
        np.testing.assert_array_equal(_out(net, x), _out(net2, x))
        net.fit(x, y)
        net2.fit(x, y)
        assert net.score() == net2.score()
        assert torch.equal(net.params().tensor(), net2.params().tensor())


class TestTrainingCheckpoint:
    def test_full_resume_with_extra(self, tmp_path):
        x, y = _data()
        net = P.MultiLayerNetwork(_mlp_conf(P), device=CPU).init()
        for _ in range(3):
            net.fit(x, y)
        norm = NormalizerStandardize().fit(DataSet(x, y))
        p = str(tmp_path / "ck.npz")
        TrainingCheckpoint.save(net, p, normalizer=norm,
                                extra={"epoch_pos": 17})
        net2, norm2, extra = TrainingCheckpoint.load(p, device=CPU)
        assert extra == {"epoch_pos": 17}
        assert net2.getIterationCount() == 3
        np.testing.assert_allclose(norm2._std, norm._std)
        net.fit(x, y)
        net2.fit(x, y)
        assert net.score() == net2.score()


class TestConfigJson:
    def test_mln_conf_round_trip(self):
        conf = _mlp_conf(P)
        conf2 = P.MultiLayerConfiguration.fromJson(conf.toJson())
        x, _ = _data()
        a = P.MultiLayerNetwork(conf, device=CPU).init()
        b = P.MultiLayerNetwork(conf2, device=CPU).init()
        np.testing.assert_array_equal(_out(a, x), _out(b, x))
        assert conf2.toJson() == conf.toJson()

    def test_graph_conf_round_trip(self):
        from deeplearning4j_tpu_torch.nn.conf.graph import \
            ComputationGraphConfiguration

        conf = _res_conf(P)
        conf2 = ComputationGraphConfiguration.fromJson(conf.toJson())
        assert conf2.topoOrder == conf.topoOrder
        x, _ = _img()
        a = P.ComputationGraph(conf, device=CPU).init()
        b = P.ComputationGraph(conf2, device=CPU).init()
        np.testing.assert_array_equal(_out(a, x), _out(b, x))

    def test_net_save_load_methods(self, tmp_path):
        x, y = _data()
        net = P.MultiLayerNetwork(_mlp_conf(P), device=CPU).init()
        net.fit(x, y)
        p = str(tmp_path / "n.npz")
        net.save(p)
        np.testing.assert_array_equal(
            _out(net, x), _out(P.MultiLayerNetwork.load(p, device=CPU), x))
        assert "Total params" in net.summary()


class TestReviewRegressions:
    def test_extensionless_path_round_trip(self, tmp_path):
        x, _ = _data()
        net = P.MultiLayerNetwork(_mlp_conf(P), device=CPU).init()
        p = str(tmp_path / "noext")
        ModelSerializer.writeModel(net, p)
        np.testing.assert_array_equal(
            _out(net, x), _out(ModelSerializer.restore(p, device=CPU), x))

    def test_fromjson_wrong_root_type_raises(self):
        from deeplearning4j_tpu_torch.nn.conf.graph import \
            ComputationGraphConfiguration

        with pytest.raises(TypeError, match="ComputationGraphConfiguration"):
            ComputationGraphConfiguration.fromJson(_mlp_conf(P).toJson())

    def test_decode_rejects_lookalike_package(self):
        node = {"__o": "deeplearning4j_tpu_evil.x:Y", "attrs": {}}
        with pytest.raises(ValueError, match="refusing"):
            serde.decode(node, [])

    def test_restore_skips_random_init(self, tmp_path, monkeypatch):
        net = P.MultiLayerNetwork(_mlp_conf(P), device=CPU).init()
        p = str(tmp_path / "m.npz")
        ModelSerializer.writeModel(net, p)

        def boom(self):
            raise AssertionError("restore must not run a random init")

        monkeypatch.setattr(P.MultiLayerNetwork, "init", boom)
        ModelSerializer.restoreMultiLayerNetwork(p, device=CPU)

    def test_unported_reference_attribute_is_refused(self, tmp_path):
        """The attribute this case refused until per-layer activation
        remat was ported, ``activationCheckpointing``, now loads: a
        reference config that sets it reads with the flag, a model file
        of it round-trips and trains bitwise a net built with the flag;
        a reference class the port lacks is still refused by name."""
        conf = json.loads(_mlp_conf(J).toJson())
        conf["attrs"]["activationCheckpointing"] = True
        pc = P.MultiLayerConfiguration.fromJson(json.dumps(conf))
        assert pc.activationCheckpointing is True
        x, y = _data()
        net = P.MultiLayerNetwork(pc, device=CPU).init()
        net.fit(x, y)
        p = str(tmp_path / "remat.npz")
        ModelSerializer.writeModel(net, p)
        back = ModelSerializer.restoreMultiLayerNetwork(p, device=CPU)
        assert back.conf.activationCheckpointing is True
        built = (P.NeuralNetConfiguration.Builder().seed(42)
                 .updater(P.Adam(1e-2)).weightInit(P.WeightInit.XAVIER)
                 .activation("relu").activationCheckpointing(True).list()
                 .layer(P.DenseLayer(nOut=16))
                 .layer(P.BatchNormalization())
                 .layer(P.OutputLayer(nOut=3, activation="softmax",
                                      lossFunction="mcxent"))
                 .setInputType(P.InputType.feedForward(4)).build())
        twin = P.MultiLayerNetwork(built, device=CPU).init()
        twin.fit(x, y)
        for _ in range(2):
            back.fit(x, y)
            twin.fit(x, y)
        assert torch.equal(back.params().tensor(), twin.params().tensor())
        with pytest.raises(NotImplementedError, match="item 7's"):
            serde.decode({"__o": "deeplearning4j_tpu.parallel.overlap:X",
                          "attrs": {}}, [])


# ----------------------------------------------------------------------
# across the packages
# ----------------------------------------------------------------------

def _ref_lenet(steps=2):
    x, y = _lenet_data()
    net = JZ.LeNet(numClasses=10).init()
    for _ in range(steps):
        net.fit(x, y)
    return net


def _lenet_data(n=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 784)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
    return x, y


def _ref_res(steps=2):
    x, y = _img()
    net = J.ComputationGraph(_res_conf(J)).init()
    for _ in range(steps):
        net.fit(x, y)
    return net


@pytest.fixture(scope="module")
def ref_lenet():
    return _ref_lenet()


@pytest.fixture(scope="module")
def ref_res():
    return _ref_res()


def _port_lenet(steps=2):
    x, y = _lenet_data()
    net = PZ.LeNet(numClasses=10, device=CPU).init()
    for _ in range(steps):
        net.fit(x, y)
    return net


def _port_res(steps=2):
    x, y = _img()
    net = P.ComputationGraph(_res_conf(P), device=CPU).init()
    for _ in range(steps):
        net.fit(x, y)
    return net


def _cases():
    return {"lenet": (_lenet_data, "MultiLayerNetwork"),
            "resgraph": (_img, "ComputationGraph")}


@pytest.mark.parametrize("name", ["lenet", "resgraph"])
@pytest.mark.parametrize("updater", [True, False],
                         ids=["updater", "no_updater"])
def test_reference_file_restores_in_port(name, updater, tmp_path, request):
    data, kind = _cases()[name]
    jn = request.getfixturevalue("ref_lenet" if name == "lenet"
                                 else "ref_res")
    x, y = data()
    p = str(tmp_path / "ref.npz")
    JMS.writeModel(jn, p, saveUpdater=updater)
    pn = ModelSerializer.restore(p, loadUpdater=updater, device=CPU)
    assert type(pn).__name__ == kind
    assert pn.getIterationCount() == jn.getIterationCount()
    np.testing.assert_allclose(_out(pn, x), _out(jn, x), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(pn.params().toNumpy(),
                                  np.asarray(jn.params().toNumpy()))
    if updater:
        # one more step from the carried updater state, in both packages
        jc = JMS.restore(p)
        jc.fit(x, y)
        pn.fit(x, y)
        assert abs(pn.score() - jc.score()) <= 1e-5 * abs(jc.score())


@pytest.mark.parametrize("name", ["lenet", "resgraph"])
@pytest.mark.parametrize("updater", [True, False],
                         ids=["updater", "no_updater"])
def test_port_file_restores_in_reference(name, updater, tmp_path):
    data, kind = _cases()[name]
    pn = _port_lenet() if name == "lenet" else _port_res()
    x, y = data()
    p = str(tmp_path / "port.npz")
    ModelSerializer.writeModel(pn, p, saveUpdater=updater)
    jn = JMS.restore(p, loadUpdater=updater)
    assert type(jn).__name__ == kind
    assert jn.getIterationCount() == pn.getIterationCount()
    np.testing.assert_allclose(_out(jn, x), _out(pn, x), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(jn.params().toNumpy()),
                                  pn.params().toNumpy())
    if updater:
        pc = ModelSerializer.restore(p, device=CPU)
        jn.fit(x, y)
        pc.fit(x, y)
        assert abs(pc.score() - jn.score()) <= 1e-5 * abs(jn.score())


@pytest.mark.parametrize("name", ["lenet", "resgraph"])
def test_json_crosses_both_ways(name):
    if name == "lenet":
        jc, pc = JZ.LeNet(numClasses=10).conf(), \
            PZ.LeNet(numClasses=10, device=CPU).conf()
        pcls, jcls = P.MultiLayerConfiguration, J.MultiLayerConfiguration
    else:
        from deeplearning4j_tpu.nn.conf.graph import \
            ComputationGraphConfiguration as jcls
        from deeplearning4j_tpu_torch.nn.conf.graph import \
            ComputationGraphConfiguration as pcls

        jc, pc = _res_conf(J), _res_conf(P)
    from_ref = pcls.fromJson(jc.toJson())
    from_port = jcls.fromJson(pc.toJson())
    # the port writes the reference's module names; what each side read
    # re-encodes to the writer's tree (the trees differ only where the
    # reference keeps derived state the port does not: GlobalPooling's
    # _mode)
    assert json.loads(from_ref.toJson()) == json.loads(jc.toJson())
    assert json.loads(from_port.toJson()) == json.loads(pc.toJson())
    for tag in ("deeplearning4j_tpu_torch",):
        assert tag not in pc.toJson()
    net_cls = P.MultiLayerNetwork if name == "lenet" else P.ComputationGraph
    net_cls(from_ref, device=CPU).init()
    jnet = (J.MultiLayerNetwork if name == "lenet" else J.ComputationGraph)
    jnet(from_port).init()


@pytest.mark.parametrize("name", ["lenet", "resgraph"])
def test_state_digest_equal_across_packages(name, tmp_path, request):
    """The same trained state (carried through a model file) hashes the
    same under the reference's digest and the port's."""
    jn = request.getfixturevalue("ref_lenet" if name == "lenet"
                                 else "ref_res")
    p = str(tmp_path / "d.npz")
    JMS.writeModel(jn, p)
    pn = ModelSerializer.restore(p, device=CPU)
    assert state_digest(_net_state(pn)) == j_digest(j_state(jn))
    assert state_digest(_net_state(pn, False)) == \
        j_digest(j_state(jn, False))
    # and the port's directory checkpoint commits that digest
    ShardedModelSerializer.writeModel(pn, str(tmp_path / "ck"))
    from deeplearning4j_tpu_torch.util.sharded_checkpoint import \
        read_manifest
    assert read_manifest(str(tmp_path / "ck"))["digest"] == \
        j_digest(j_state(jn))


def test_set_params_carries_a_reference_vector():
    jn = _ref_lenet(steps=1)
    pn = PZ.LeNet(numClasses=10, device=CPU).init()
    pn.setParams(np.asarray(jn.params().toNumpy()))
    x, _ = _lenet_data()
    np.testing.assert_allclose(_out(pn, x), _out(jn, x), rtol=0, atol=1e-5)
    table = {k: np.asarray(v.toNumpy()) for k, v in jn.paramTable().items()}
    fresh = PZ.LeNet(numClasses=10, device=CPU).init()
    fresh.setParamTable(table)
    assert torch.equal(fresh.params().tensor(), pn.params().tensor())
    np.testing.assert_array_equal(pn.getParam("0_W").toNumpy(),
                                  np.asarray(jn.getParam("0_W").toNumpy()))


def test_clone_is_independent():
    x, y = _img()
    net = _port_res(steps=1)
    c = net.clone()
    assert c.getIterationCount() == net.getIterationCount()
    net.fit(x, y)
    c.fit(x, y)
    assert net.score() == c.score()
    net.fit(x, y)
    assert not torch.equal(net.params().tensor(), c.params().tensor())


def test_codec_decodes_arrays_to_cpu_tensors():
    arrays = []
    node = serde.encode({"w": torch.arange(3.0), "n": np.ones(2)}, arrays)
    back = serde.decode(node, arrays)
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
               for v in back.values())
    # the reference's codec reads the port's tree
    jback = jserde.decode(node, arrays)
    np.testing.assert_array_equal(np.asarray(jback["w"]), [0.0, 1.0, 2.0])
    assert jax.numpy.asarray(jback["n"]).shape == (2,)


# ----------------------------------------------------------------------
# the rest of the layer catalogue across the packages
# ----------------------------------------------------------------------

def _noise_conf(M):
    return (M.NeuralNetConfiguration.Builder().seed(31)
            .updater(M.Adam(1e-2)).biasUpdater(M.Sgd(0.05))
            .weightNoise(M.WeightNoise(M.NormalDistribution(0.0, 0.01)))
            .constrainWeights(M.MaxNormConstraint(maxNorm=1.5))
            .constrainBias(M.NonNegativeConstraint()).list()
            .layer(M.Convolution1DLayer(nOut=4, kernelSize=3,
                                        activation="tanh"))
            .layer(M.GlobalPoolingLayer(poolingType="max"))
            .layer(M.DenseLayer(nOut=5, activation="relu"))
            .layer(M.OutputLayer(nOut=3, activation="softmax"))
            .setInputType(M.InputType.recurrent(4, 6)).build())


def _vae_conf(M):
    return (M.NeuralNetConfiguration.Builder().seed(32)
            .updater(M.RmsProp(1e-3)).list()
            .layer(M.VariationalAutoencoder(
                nOut=2, encoderLayerSizes=(5, 4), decoderLayerSizes=(3,),
                activation="leakyrelu",
                reconstructionDistribution="bernoulli"))
            .layer(M.OutputLayer(nOut=3, activation="softmax"))
            .setInputType(M.InputType.feedForward(4)).build())


def _misc_conf(M):
    return (M.NeuralNetConfiguration.Builder().seed(33)
            .updater(M.Nesterovs(0.05, 0.9)).list()
            .layer(M.LocallyConnected2D(nOut=3, kernelSize=(2, 2),
                                        activation="tanh"))
            .layer(M.PReLULayer(sharedAxes=(2,), alphaInit=0.2))
            .layer(M.PrimaryCapsules(capsules=2, capsuleDimensions=3,
                                     kernelSize=(2, 2), stride=(1, 1)))
            .layer(M.CapsuleLayer(capsules=3, capsuleDimensions=4,
                                  routings=2))
            .layer(M.CapsuleStrengthLayer())
            .layer(M.OutputLayer(nOut=3, activation="softmax"))
            .setInputType(M.InputType.convolutional(5, 5, 2)).build())


def _seq_graph_conf(M):
    return (M.NeuralNetConfiguration.Builder().seed(34)
            .updater(M.Adam(1e-2)).graphBuilder().addInputs("tok")
            .addLayer("emb", M.EmbeddingSequenceLayer(nIn=11, nOut=4), "tok")
            .addLayer("mz", M.MaskZeroLayer(M.LSTM(nOut=5)), "emb")
            .addVertex("rev", M.ReverseTimeSeriesVertex(), "mz")
            .addVertex("last", M.LastTimeStepVertex(), "rev")
            .addLayer("out", M.OutputLayer(nOut=3, activation="softmax"),
                      "last")
            .setOutputs("out").setInputTypes(M.InputType.recurrent(1, 6))
            .build())


_CATALOGUE = {"noise": (_noise_conf, False), "vae": (_vae_conf, False),
              "misc": (_misc_conf, False), "graph": (_seq_graph_conf, True)}


def _catalogue_data(name):
    rng = np.random.default_rng(7)
    if name == "noise":
        x = rng.standard_normal((5, 4, 6)).astype(np.float32)
    elif name == "vae":
        x = rng.random((5, 4)).astype(np.float32)
    elif name == "misc":
        x = rng.standard_normal((5, 2, 5, 5)).astype(np.float32)
    else:
        x = rng.integers(0, 11, (5, 6)).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[rng.integers(0, 3, 5)]


@pytest.mark.parametrize("name", sorted(_CATALOGUE))
def test_catalogue_file_crosses_both_ways(name, tmp_path):
    """A model file that sets constraints, weightNoise or a biasUpdater,
    holds a VAE, capsules or the time vertices: the reference's restores
    in the port with the reference's outputs, and the port's (after its
    own training steps) restores in the reference with the port's."""
    conf, graph = _CATALOGUE[name]
    x, y = _catalogue_data(name)
    jnet = (J.ComputationGraph if graph else J.MultiLayerNetwork)(
        conf(J)).init()
    jnet.fit(x, y)
    ref = str(tmp_path / "ref.npz")
    JMS.writeModel(jnet, ref, True)
    pnet = ModelSerializer.restore(ref, device=CPU)
    np.testing.assert_allclose(_out(pnet, x), _out(jnet, x), atol=1e-5)
    for _ in range(2):
        pnet.fit(x, y)
    mine = str(tmp_path / "port.npz")
    ModelSerializer.writeModel(pnet, mine, True)
    back = JMS.restore(mine)
    np.testing.assert_allclose(np.asarray(_out(back, x)), _out(pnet, x),
                               atol=1e-5)
    assert back._iteration == pnet.getIterationCount() == 3


@pytest.mark.parametrize("name", sorted(_CATALOGUE))
def test_catalogue_round_trip_resumes_bitwise(name, tmp_path):
    """A port file with the updater state (the biases' own under a
    biasUpdater) resumes bit for bit against training that never
    stopped."""
    conf, graph = _CATALOGUE[name]
    x, y = _catalogue_data(name)
    a = (P.ComputationGraph if graph else P.MultiLayerNetwork)(
        conf(P), device=CPU).init()
    a.fit(x, y)
    path = str(tmp_path / "m.npz")
    ModelSerializer.writeModel(a, path, True)
    b = ModelSerializer.restore(path, device=CPU)
    for _ in range(2):
        a.fit(x, y)
        b.fit(x, y)
    np.testing.assert_array_equal(a.params().toNumpy(), b.params().toNumpy())
    if name == "noise":
        assert set(b._upd_states[0]) == {"main", "bias"}


def _more_confs():
    """Port configs holding the rest of PR 12's classes."""
    from deeplearning4j_tpu_torch.nn.conf import preprocessors as PPP

    def b(seed):
        return (P.NeuralNetConfiguration.Builder().seed(seed)
                .updater(P.Adam(1e-2)))

    return {
        "layers_1d": (b(41).list()
                      .layer(P.Subsampling1DLayer(kernelSize=2, stride=1))
                      .layer(P.Upsampling1D(size=2))
                      .layer(P.Cropping1D(cropping=(1, 1)))
                      .layer(P.ZeroPadding1DLayer(padding=1))
                      .layer(P.LocallyConnected1D(nOut=3, kernelSize=2))
                      .layer(P.GlobalPoolingLayer(poolingType="avg"))
                      .layer(P.OutputLayer(nOut=3, activation="softmax"))
                      .setInputType(P.InputType.recurrent(4, 6)).build(),
                      (5, 4, 6)),
        "wrappers": (b(42).list()
                     .layer(P.FrozenLayerWithBackprop(
                         P.DenseLayer(nOut=5, activation="tanh")))
                     .layer(P.ElementWiseMultiplicationLayer())
                     .layer(P.RepeatVector(n=3))
                     .layer(P.LSTM(nOut=4)).layer(P.MaskLayer())
                     .layer(P.RnnOutputLayer(nOut=3, activation="softmax"))
                     .setInputType(P.InputType.feedForward(4)).build(),
                     (5, 4)),
        "center_loss": (b(43).list()
                        .layer(P.EmbeddingLayer(nIn=9, nOut=4))
                        .layer(P.CenterLossOutputLayer(nOut=3,
                                                       activation="softmax"))
                        .setInputType(P.InputType.feedForward(1)).build(),
                        (5, 1)),
        "ocnn_autoencoder": (b(44).list()
                             .layer(P.AutoEncoder(nOut=4,
                                                  corruptionLevel=0.2))
                             .layer(P.OCNNOutputLayer(hiddenSize=3))
                             .setInputType(P.InputType.feedForward(5))
                             .build(), (5, 5)),
        "cnn_rnn": (b(45).list()
                    .inputPreProcessor(0, PPP.RnnToCnnPreProcessor(3, 3, 2))
                    .layer(P.ConvolutionLayer(nOut=2, kernelSize=(2, 2)))
                    .layer(P.SpaceToBatch(blocks=1))
                    .layer(P.LSTM(nOut=3))
                    .layer(P.RnnOutputLayer(nOut=3, activation="softmax"))
                    .setInputType(P.InputType.recurrent(18, 4)).build(),
                    (5, 18, 4)),
    }


@pytest.mark.parametrize("name", sorted(_more_confs()))
def test_more_catalogue_classes_round_trip_and_cross(name, tmp_path):
    """Each remaining class of the slice in a port model file: restored in
    the port bit for bit, and in the reference with the port's outputs."""
    conf, shape = _more_confs()[name]
    rng = np.random.default_rng(8)
    x = (rng.integers(0, 9, shape) if name == "center_loss"
         else rng.standard_normal(shape)).astype(np.float32)
    net = P.MultiLayerNetwork(conf, device=CPU).init()
    out = _out(net, x)
    y = (np.zeros((5, 1), np.float32) if name.startswith("ocnn")
         else np.zeros(out.shape, np.float32))
    net.fit(x, y)
    path = str(tmp_path / "m.npz")
    ModelSerializer.writeModel(net, path, True)
    back = ModelSerializer.restore(path, device=CPU)
    np.testing.assert_array_equal(_out(back, x), _out(net, x))
    ref = JMS.restore(path)
    np.testing.assert_allclose(np.asarray(_out(ref, x)), _out(net, x),
                               atol=1e-5)


# ----------------------------------------------------------------------
# transferred nets and line-search solvers
# ----------------------------------------------------------------------

def _transferred(M, net, graph):
    if graph:
        return (M.TransferLearning.GraphBuilder(net)
                .setFeatureExtractor("d1")
                .removeVertexKeepConnections("out")
                .addLayer("out", M.OutputLayer(nOut=5, activation="softmax"),
                          "d1").build())
    return (M.TransferLearning.Builder(net).setFeatureExtractor(0)
            .nOutReplace(1, 5).build())


def _small_graph_conf(M):
    return (M.NeuralNetConfiguration.Builder().seed(9).updater(M.Adam(1e-2))
            .graphBuilder().addInputs("in")
            .addLayer("d1", M.DenseLayer(nOut=6, activation="tanh"), "in")
            .addLayer("out", M.OutputLayer(nOut=3, activation="softmax"),
                      "d1")
            .setOutputs("out").setInputTypes(M.InputType.feedForward(4))
            .build())


def _small_mlp_conf(M, algo=None):
    b = M.NeuralNetConfiguration.Builder().seed(9).updater(M.Adam(1e-2))
    if algo is not None:
        b = b.optimizationAlgo(algo).maxNumLineSearchIterations(11)
    return (b.list().layer(M.DenseLayer(nIn=4, nOut=6, activation="tanh"))
            .layer(M.OutputLayer(nOut=3, activation="softmax")).build())


@pytest.mark.parametrize("graph", [False, True], ids=["mln", "graph"])
@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_transferred_net_file_crosses_both_ways(graph, direction, tmp_path):
    """Frozen flags and the replaced head travel in the file: restored in
    the other package, the frozen layers stay frozen under its fit."""
    x, _ = _data()
    y5 = np.eye(5, dtype=np.float32)[np.arange(32) % 5]
    conf = _small_graph_conf if graph else _small_mlp_conf
    if direction == "ref_to_port":
        src = (J.ComputationGraph if graph else J.MultiLayerNetwork)(
            conf(J)).init()
        net = _transferred(J, src, graph)
        net.fit(x, y5)
        path = str(tmp_path / "ref.npz")
        JMS.writeModel(net, path, True)
        back = ModelSerializer.restore(path, device=CPU)
    else:
        src = (P.ComputationGraph if graph else P.MultiLayerNetwork)(
            conf(P), device=CPU).init()
        net = _transferred(P, src, graph)
        net.fit(x, y5)
        path = str(tmp_path / "port.npz")
        ModelSerializer.writeModel(net, path, True)
        back = JMS.restore(path)
    np.testing.assert_allclose(np.asarray(_out(back, x)), _out(net, x),
                               atol=1e-5)
    frozen = "d1" if graph else 0
    layer = (back.conf.nodes[frozen].payload if graph
             else back.layers[frozen])
    assert getattr(layer, "frozen", False)
    before = np.asarray(back._params[frozen]["W"]).copy() \
        if direction == "port_to_ref" else \
        back._params[frozen]["W"].detach().clone().numpy()
    back.fit(x, y5)
    after = back._params[frozen]["W"]
    after = np.asarray(after) if direction == "port_to_ref" else \
        after.detach().numpy()
    np.testing.assert_array_equal(before, after)


@pytest.mark.parametrize("algo", ["LBFGS", "CONJUGATE_GRADIENT",
                                  "LINE_GRADIENT_DESCENT"])
@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_solver_net_file_crosses_both_ways(algo, direction, tmp_path):
    """The solver and its line-search cap travel in the file; the
    solver's memory is not written (as in the reference) and starts fresh
    on restore, so training continues from the restored weights."""
    x, y = _data()
    if direction == "ref_to_port":
        net = J.MultiLayerNetwork(_small_mlp_conf(J, algo)).init()
        net.fit(x, y)
        path = str(tmp_path / "ref.npz")
        JMS.writeModel(net, path, True)
        back = ModelSerializer.restore(path, device=CPU)
    else:
        net = P.MultiLayerNetwork(_small_mlp_conf(P, algo), device=CPU).init()
        net.fit(x, y)
        path = str(tmp_path / "port.npz")
        ModelSerializer.writeModel(net, path, True)
        back = JMS.restore(path)
    assert back.conf.optimizationAlgo == algo
    assert back.conf.maxNumLineSearchIterations == 11
    assert back._solver is not None
    np.testing.assert_allclose(np.asarray(_out(back, x)), _out(net, x),
                               atol=1e-5)
    back.fit(x, y)
    assert np.isfinite(back.score())


def test_solver_conf_json_crosses_both_ways():
    for src, dst in ((J, P), (P, J)):
        text = _small_mlp_conf(src, "LBFGS").toJson()
        conf = dst.MultiLayerConfiguration.fromJson(text)
        assert conf.optimizationAlgo == "LBFGS"
        assert json.loads(conf.toJson()) == json.loads(text)
