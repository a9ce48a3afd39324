"""Port parity for TF frozen-graph import (deeplearning4j_tpu_torch/
modelimport/{tensorflow,tf_wire}.py): every test of
tests/test_tf_import.py, the same ``SerializeToString()`` bytes through
both importers, each graph held to TF's own execution within the
reference test's band (atol 1e-5, rtol 1e-4) and the port's output to
the reference's within 1e-6 of its max-abs (f32); the port's GraphDef
codec against ``graph_pb2`` (decode, re-encode bytewise, the text
format), its wire details on hand-assembled bytes (packed and unpacked
repeated fields, negative int64 varints, a single typed value broadcast,
the attr map's entries, bf16 and half patterns), and a cut zoo
ResNet-50 written by tests/_torch_tf_models.py against the native net.

Graphs are frozen the way real frozen models are: tf.function ->
get_concrete_function -> convert_variables_to_constants_v2.
"""

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from tensorflow.core.framework import graph_pb2  # noqa: E402
from tensorflow.python.framework.convert_to_constants import (  # noqa: E402
    convert_variables_to_constants_v2,
)

from deeplearning4j_tpu.modelimport.tensorflow import (  # noqa: E402
    TFGraphMapper as JMapper, importFrozenTF as j_import,
)
from deeplearning4j_tpu_torch.modelimport import tf_wire as tw  # noqa: E402
from deeplearning4j_tpu_torch.modelimport.onnx_wire import (  # noqa: E402
    _write_varint,
)
from deeplearning4j_tpu_torch.modelimport.tensorflow import (  # noqa: E402
    TFGraphMapper, TFImportException, importFrozenTF,
)

torch.set_num_threads(2)
CPU = "cpu"


def _freeze(model, spec):
    fn = tf.function(model).get_concrete_function(spec)
    frozen = convert_variables_to_constants_v2(fn)
    return frozen.graph.as_graph_def(), frozen


def _placeholder_name(gd):
    return [n.name for n in gd.node if n.op == "Placeholder"][0]


def _last_name(gd):
    consumed = {i.split(":")[0].lstrip("^") for n in gd.node for i in n.input}
    sinks = [n.name for n in gd.node
             if n.op not in ("Const", "NoOp") and n.name not in consumed]
    return sinks[-1]


def _run_both(gd, x, inputShapes=None):
    data = gd.SerializeToString()
    sd = importFrozenTF(data, inputShapes=inputShapes, device=CPU)
    jsd = j_import(data, inputShapes=inputShapes)
    ph, last = _placeholder_name(gd), _last_name(gd)
    got = TFGraphMapper.outputVariable(sd, last).eval({ph: x}).toNumpy()
    want = np.asarray(JMapper.outputVariable(jsd, last).eval(
        {ph: x}).toNumpy())
    return got, want, sd


def _parity(gd, golden, x, atol=1e-5, rtol=1e-4):
    got, ref, sd = _run_both(gd, x)
    np.testing.assert_allclose(got, golden, atol=atol, rtol=rtol)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-6 * max(np.abs(ref).max(), 1e-30))
    return sd


def _keras_case(layers, shape, seed):
    tf.keras.utils.set_random_seed(seed)
    model = tf.keras.Sequential(layers)
    model.build(shape)
    return _freeze(model, tf.TensorSpec(shape, tf.float32))


def test_dense_mlp_parity():
    gd, frozen = _keras_case([
        tf.keras.layers.Dense(32, activation="relu"),
        tf.keras.layers.Dense(16, activation="tanh"),
        tf.keras.layers.Dense(5, activation="softmax")], (4, 12), 3)
    x = np.random.RandomState(0).rand(4, 12).astype(np.float32)
    _parity(gd, np.asarray(frozen(tf.constant(x))[0]), x)


def test_imported_graph_is_trainable():
    gd, _ = _keras_case([tf.keras.layers.Dense(8, activation="relu"),
                         tf.keras.layers.Dense(3)], (8, 6), 4)
    sd = importFrozenTF(gd.SerializeToString(), device=CPU)
    out = TFGraphMapper.outputVariable(sd, _last_name(gd))
    g = sd.math.square(out).mean()
    g.rename("loss")
    sd.setLossVariables("loss")
    x = np.random.RandomState(1).rand(8, 6).astype(np.float32)
    grads = sd.calculateGradients({_placeholder_name(gd): x},
                                  *[v.name for v in sd.variables()])
    assert isinstance(grads, dict)


def test_small_cnn_parity():
    gd, frozen = _keras_case([
        tf.keras.layers.Conv2D(8, 3, padding="same", activation="relu"),
        tf.keras.layers.MaxPool2D(2),
        tf.keras.layers.Conv2D(12, 3, strides=2, padding="valid"),
        tf.keras.layers.BatchNormalization(),
        tf.keras.layers.ReLU(),
        tf.keras.layers.GlobalAveragePooling2D(),
        tf.keras.layers.Dense(4, activation="softmax")], (2, 16, 16, 3), 5)
    ops = {n.op for n in gd.node}
    assert "Conv2D" in ops and "Rsqrt" in ops, ops
    x = np.random.RandomState(2).rand(2, 16, 16, 3).astype(np.float32)
    _parity(gd, np.asarray(frozen(tf.constant(x))[0]), x)


def test_fused_batchnorm_parity():
    g, b = np.float32([1.2, 0.8]), np.float32([0.1, -0.2])
    m, v = np.float32([0.3, -0.1]), np.float32([1.5, 0.7])

    @tf.function
    def f(x):
        y, _, _ = tf.raw_ops.FusedBatchNormV3(
            x=x, scale=g, offset=b, mean=m, variance=v,
            epsilon=1e-3, is_training=False)[:3]
        return tf.nn.relu(y)

    gd = f.get_concrete_function(
        tf.TensorSpec((2, 4, 4, 2), tf.float32)).graph.as_graph_def()
    assert "FusedBatchNormV3" in {n.op for n in gd.node}
    x = np.random.RandomState(7).randn(2, 4, 4, 2).astype(np.float32)
    _parity(gd, np.asarray(f(tf.constant(x))), x)


def test_same_padded_avgpool_excludes_padding():
    @tf.function
    def f(x):
        return tf.nn.avg_pool2d(x, ksize=3, strides=2, padding="SAME")

    gd = f.get_concrete_function(
        tf.TensorSpec((1, 6, 6, 2), tf.float32)).graph.as_graph_def()
    x = np.ones((1, 6, 6, 2), np.float32)
    golden = np.asarray(f(tf.constant(x)))
    assert golden.max() == golden.min() == 1.0
    _parity(gd, golden, x, atol=1e-6)


def test_depthwise_and_relu6_parity():
    gd, frozen = _keras_case([
        tf.keras.layers.DepthwiseConv2D(3, padding="same"),
        tf.keras.layers.ReLU(max_value=6.0),
        tf.keras.layers.AveragePooling2D(2)], (1, 8, 8, 4), 6)
    x = (np.random.RandomState(3).rand(1, 8, 8, 4) * 8).astype(np.float32)
    _parity(gd, np.asarray(frozen(tf.constant(x))[0]), x)


def test_explicit_conv_padding_and_math_tail():
    """Conv2D with EXPLICIT pads, and the elementwise/shape ops of the
    reference's table (Sub, Mul, RealDiv, Maximum, Minimum, Pow, Sqrt,
    Exp, Log, Neg, Square, Abs, Sigmoid, Tanh, LeakyRelu, AddN, Reshape,
    Squeeze, Pad, ConcatV2, Cast)."""
    w = np.random.RandomState(0).randn(3, 3, 2, 4).astype(np.float32) * 0.3

    @tf.function
    def f(x):
        y = tf.nn.conv2d(x, w, strides=1,
                         padding=[[0, 0], [1, 2], [0, 1], [0, 0]])
        y = tf.concat([tf.nn.sigmoid(y), tf.math.tanh(y)], axis=3)
        y = tf.pad(y, [[0, 0], [1, 0], [0, 1], [0, 0]])
        a = tf.math.sqrt(tf.math.abs(y) + 1.0) - tf.math.square(y) * 0.1
        a = tf.math.maximum(a, -1.0) / (tf.math.exp(-tf.math.abs(y)) + 1.0)
        a = tf.math.minimum(a, 2.0) + tf.math.log(tf.math.abs(y) + 2.0)
        a = tf.math.pow(tf.math.abs(a) + 0.5, 1.5) + tf.math.negative(y)
        a = tf.add_n([a, y, tf.nn.leaky_relu(y, alpha=0.3)])
        a = tf.reshape(a, [2, -1, 1])
        return tf.cast(tf.squeeze(a, axis=[2]), tf.float32)

    gd = f.get_concrete_function(
        tf.TensorSpec((2, 5, 5, 2), tf.float32)).graph.as_graph_def()
    x = np.random.RandomState(4).randn(2, 5, 5, 2).astype(np.float32)
    _parity(gd, np.asarray(f(tf.constant(x))), x)


def test_bfloat16_and_half_consts_decode_correctly():
    vals = np.array([1.0, 2.5, -3.0], dtype=np.float32)

    @tf.function
    def f(x):
        b16 = tf.constant(vals, dtype=tf.bfloat16)
        h16 = tf.constant(vals, dtype=tf.float16)
        return x + tf.cast(b16, tf.float32) + tf.cast(h16, tf.float32)

    gd = f.get_concrete_function(
        tf.TensorSpec((3,), tf.float32)).graph.as_graph_def()
    got, ref, _ = _run_both(gd, np.zeros(3, np.float32))
    np.testing.assert_allclose(got, 2 * vals, atol=1e-3)
    np.testing.assert_array_equal(got, ref)


def test_import_errors():
    @tf.function
    def f(x):
        return tf.linalg.svd(x)[0]

    gd = f.get_concrete_function(
        tf.TensorSpec((3, 3), tf.float32)).graph.as_graph_def()
    with pytest.raises(TFImportException, match="unsupported TF op"):
        importFrozenTF(gd.SerializeToString(), device=CPU)

    @tf.function
    def g(x):
        return tf.nn.relu(x)

    gd = g.get_concrete_function(
        tf.TensorSpec((None, 4), tf.float32)).graph.as_graph_def()
    with pytest.raises(TFImportException, match="inputShapes"):
        importFrozenTF(gd.SerializeToString(), device=CPU)
    name = _placeholder_name(gd)
    x = np.random.RandomState(4).rand(2, 4).astype(np.float32)
    got, ref, _ = _run_both(gd, x, inputShapes={name: (2, 4)})
    np.testing.assert_allclose(got, np.maximum(x, 0))
    np.testing.assert_array_equal(got, ref)


# ----------------------------------------------------------------------
# the GraphDef codec
# ----------------------------------------------------------------------

def test_codec_reads_and_rewrites_tfs_bytes_and_text(tmp_path):
    """tf_wire decodes TF's bytes, re-encodes them bytewise, and its text
    reader gives the same graph as graph_pb2's text parser; a .pbtxt file
    imports to the same function as the binary."""
    gd, frozen = _keras_case([
        tf.keras.layers.Conv2D(4, 3, padding="same", activation="relu"),
        tf.keras.layers.GlobalAveragePooling2D(),
        tf.keras.layers.Dense(3, activation="softmax")], (2, 6, 6, 2), 8)
    data = gd.SerializeToString()
    msg = tw.decode("GraphDef", data)
    assert [n.name for n in msg.node] == [n.name for n in gd.node]
    assert [n.op for n in msg.node] == [n.op for n in gd.node]
    assert tw.encode(msg) == data
    from google.protobuf import text_format

    text = text_format.MessageToString(gd)
    back = graph_pb2.GraphDef()
    back.ParseFromString(tw.encode(tw.parse_text("GraphDef", text)))
    assert back == gd
    path = tmp_path / "g.pbtxt"
    path.write_text(text)
    x = np.random.RandomState(1).rand(2, 6, 6, 2).astype(np.float32)
    ph, last = _placeholder_name(gd), _last_name(gd)
    a = TFGraphMapper.outputVariable(
        importFrozenTF(str(path), device=CPU), last).eval({ph: x}).toNumpy()
    b = TFGraphMapper.outputVariable(
        importFrozenTF(data, device=CPU), last).eval({ph: x}).toNumpy()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a, np.asarray(frozen(tf.constant(x))[0]),
                               atol=1e-5, rtol=1e-4)


def test_codec_writer_is_read_by_graph_pb2():
    """A graph written by tf_wire (attr map, list attrs, tensors, shapes,
    negative ints) parses with graph_pb2 to the same fields."""
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    nodes = [
        tw.make_node("Placeholder", "x", dtype=("type", 1),
                     shape=("shape", (4, 2))),
        tw.make_node("Const", "w", dtype=("type", 1), value=w),
        tw.make_node("Const", "s", dtype=("type", 3),
                     value=np.array([-1, 3], np.int32)),
        tw.make_node("MatMul", "m", ["x", "w"], transpose_a=False,
                     transpose_b=False, T=("type", 1)),
        tw.make_node("Reshape", "r", ["m", "s"], T=("type", 1)),
        tw.make_node("Squeeze", "q", ["r"], squeeze_dims=[-7, 2],
                     T=("type", 1)),
    ]
    data = tw.encode(tw.make_graph(nodes, producer=7))
    gd = graph_pb2.GraphDef()
    gd.ParseFromString(data)
    assert [n.op for n in gd.node] == ["Placeholder", "Const", "Const",
                                       "MatMul", "Reshape", "Squeeze"]
    assert list(gd.node[5].attr["squeeze_dims"].list.i) == [-7, 2]
    assert [d.size for d in gd.node[0].attr["shape"].shape.dim] == [4, 2]
    assert gd.node[1].attr["value"].tensor.tensor_content == w.tobytes()
    assert list(gd.node[3].input) == ["x", "w"]
    assert gd.versions.producer == 7
    assert tw.encode(tw.decode("GraphDef", gd.SerializeToString())) == \
        gd.SerializeToString()


def _field(num, wt, payload):
    out = bytearray()
    _write_varint(out, (num << 3) | wt)
    if wt == 2:
        _write_varint(out, len(payload))
        out += payload
    else:
        out += payload
    return bytes(out)


def _varint(v):
    out = bytearray()
    _write_varint(out, v)
    return bytes(out)


def test_codec_wire_details():
    """Hand-assembled TensorProto bytes: unpacked and packed int64_val
    with a negative value, a single float_val broadcast over the shape,
    an unknown field skipped; a bf16 tensor_content from its bits; a
    half_val from its bits."""
    shape = _field(2, 2, _field(2, 2, _field(1, 0, _varint(3))))
    unpacked = (_field(1, 0, _varint(9)) + shape
                + _field(10, 0, _varint(-5)) + _field(10, 0, _varint(7))
                + _field(10, 0, _varint(2 ** 40)) + _field(99, 0, _varint(1)))
    t = tw.decode("TensorProto", unpacked)
    np.testing.assert_array_equal(tw.tensor_to_ndarray(t),
                                  np.array([-5, 7, 2 ** 40], np.int64))
    packed = (_field(1, 0, _varint(9)) + shape + _field(
        10, 2, _varint(-5) + _varint(7) + _varint(2 ** 40)))
    assert tw.decode("TensorProto", packed).int64_val == [-5, 7, 2 ** 40]
    one = (_field(1, 0, _varint(1)) + _field(2, 2, _field(
        2, 2, _field(1, 0, _varint(2))) + _field(2, 2, _field(
            1, 0, _varint(3)))) + _field(5, 2, np.float32(0.25).tobytes()))
    np.testing.assert_array_equal(tw.tensor_to_ndarray(
        tw.decode("TensorProto", one)), np.full((2, 3), 0.25, np.float32))
    vals = np.array([1.0, -2.5, 3.140625], np.float32)
    bits = (vals.view(np.uint32) >> 16).astype(np.uint16)
    bf = tw.make_tensor(vals, dtype="bfloat16")
    assert bf.tensor_content == bits.tobytes()
    np.testing.assert_array_equal(tw.tensor_to_ndarray(
        tw.decode("TensorProto", tw.encode(bf))), vals)
    half = tw.message("TensorProto", dtype=19, tensor_shape=tw.message(
        "TensorShapeProto", dim=[tw.message("TensorShapeProto.Dim",
                                            size=3)]),
        half_val=[int(b) for b in vals.astype(np.float16).view(np.uint16)])
    got = tw.tensor_to_ndarray(tw.decode("TensorProto", tw.encode(half)))
    assert got.dtype == np.float16
    np.testing.assert_array_equal(got, vals.astype(np.float16))


def test_zoo_resnet_graphdef_matches_the_native_net():
    """tests/_torch_tf_models.py's frozen form of a cut zoo ResNet-50
    (one bottleneck a stage, 32x32, seeded BN statistics) imports to the
    native net's eval logits within 1e-5 of their max-abs, and through
    the reference's importer (the same bytes) to the same."""
    import _torch_onnx_models as om
    import _torch_tf_models as tm

    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import strip_carries

    net = ComputationGraph(om.resnet50_conf(
        blocks=(1, 1, 1, 1), numClasses=7, inputShape=(3, 32, 32)),
        device=CPU).init()
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for st in net._states.values():
            if st:
                st["mean"].copy_(0.1 * torch.randn(st["mean"].shape,
                                                   generator=g))
                st["var"].copy_(0.5 + torch.rand(st["var"].shape,
                                                 generator=g))
    data = tw.encode(tm.resnet_graphdef(net, 2))
    x = np.random.default_rng(0).standard_normal((2, 3, 32, 32),
                                                 dtype=np.float32)
    with torch.no_grad():
        _, pre, _ = net._run_graph(net._params, strip_carries(net._states),
                                   net._coerce_inputs(torch.tensor(x)),
                                   False, None, None)
    want = pre["fc"].numpy()
    feed = {"input": x.transpose(0, 2, 3, 1).copy()}
    sd = importFrozenTF(data, device=CPU)
    got = TFGraphMapper.outputVariable(sd, "logits").eval(feed).toNumpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    ref = np.asarray(JMapper.outputVariable(j_import(data), "logits").eval(
        feed).toNumpy())
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    probs = TFGraphMapper.outputVariable(sd, "probs").eval(feed).toNumpy()
    np.testing.assert_allclose(probs, net.output(x).toNumpy(), atol=1e-6)
