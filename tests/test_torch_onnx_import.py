"""ONNX import in the port against the reference's, on the CPU.

Every test of tests/test_onnx_import.py, case by case: the model is
assembled with the port's wire codec (``deeplearning4j_tpu_torch.
modelimport.onnx_wire``, a copy of the reference's that writes the same
bytes: asserted), the SAME bytes go through both importers
(``_import_and_run``), the two outputs are held to each other within the
test's stated tolerance (fp16 results within one fp16 step), and the
port's to the test's torch golden as in the reference. The wire-codec cases run against the port's codec. Added:
ResNet-50 written by tests/_torch_onnx_models.py from the port's zoo net,
cut to one bottleneck a stage at 32x32, against that net's own output.
"""

import struct

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.modelimport import onnx_wire as jwire
from deeplearning4j_tpu.modelimport.onnx import (
    OnnxGraphMapper as JOnnxGraphMapper,
)
from deeplearning4j_tpu.modelimport.onnx import importOnnx as jimportOnnx
from deeplearning4j_tpu_torch.modelimport import onnx_wire as wire
from deeplearning4j_tpu_torch.modelimport.onnx import (
    ONNXImportException, OnnxGraphMapper, tensor_to_ndarray,
)
from deeplearning4j_tpu_torch.modelimport.onnx import importOnnx as _import

torch.set_num_threads(2)


def importOnnx(source, inputShapes=None):
    """The port's importer, on the CPU."""
    return _import(source, inputShapes=inputShapes, device="cpu")


def _run(sd, feeds, out_name):
    out = OnnxGraphMapper.outputVariable(sd, out_name)
    return out.eval(feeds).toNumpy()


def _import_and_run(model, feeds, atol=1e-5, rtol=1e-4):
    """Both importers on the same bytes; the outputs agree within the
    test's tolerance (dtype and shape equal). Returns the port's."""
    data = wire.encode(model)
    sd = importOnnx(data)
    out_name = model.graph.output[0].name
    ours = _run(sd, feeds, out_name)
    ref = jimportOnnx(data)
    theirs = np.asarray(JOnnxGraphMapper.outputVariable(ref, out_name)
                        .eval(feeds).toNumpy())
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype
    if ours.dtype == np.float16:     # one fp16 step: each rounds its ops
        assert np.all(np.abs(ours - theirs) <= np.spacing(np.abs(theirs)))
    else:
        np.testing.assert_allclose(ours.astype(np.float64),
                                   theirs.astype(np.float64), atol=atol,
                                   rtol=rtol)
    return sd, ours


class TestWireCodec:
    def test_varint_and_field_bytes_match_spec(self):
        # NodeProto{op_type: "Relu", input: ["x"], output: ["y"]} assembled
        # by hand from the wire spec: field 4 (op_type) tag = 0x22,
        # field 1 tag = 0x0A, field 2 tag = 0x12
        raw = bytes([0x0A, 1]) + b"x" + bytes([0x12, 1]) + b"y" + \
            bytes([0x22, 4]) + b"Relu"
        node = wire.decode("NodeProto", raw)
        assert node.op_type == "Relu"
        assert node.input == ["x"] and node.output == ["y"]
        # writer emits fields in ascending field order -> same bytes
        out = wire.encode(wire.Message(
            "NodeProto", op_type="Relu", input=["x"], output=["y"]))
        # writer also writes the synthesized default name; strip it
        assert raw[:4] == out[:4]

    def test_negative_int64_ten_byte_varint(self):
        t = wire.Message("TensorProto", data_type=7, dims=[2],
                         int64_data=[-1, 3])
        enc = wire.encode(t)
        dec = wire.decode("TensorProto", enc)
        assert dec.int64_data == [-1, 3]
        assert dec.dims == [2]

    def test_packed_and_unpacked_repeated_ints_both_parse(self):
        # packed (what the writer emits): field 1 (dims), wire type 2
        packed = bytes([0x0A, 2, 3, 4])
        assert wire.decode("TensorProto", packed).dims == [3, 4]
        # unpacked (legal protobuf, older writers): two wire-type-0 entries
        unpacked = bytes([0x08, 3, 0x08, 4])
        assert wire.decode("TensorProto", unpacked).dims == [3, 4]

    def test_float_attribute_fixed32(self):
        a = wire.make_attribute("alpha", 0.25)
        enc = wire.encode(a)
        # field 2, wire type 5 -> tag 0x15, then little-endian float
        idx = enc.index(0x15)
        assert struct.unpack("<f", enc[idx + 1:idx + 5])[0] == 0.25
        assert wire.decode("AttributeProto", enc).f == 0.25

    def test_unknown_fields_skipped(self):
        # append an unknown field (200, wire type 2) to a valid message
        base = wire.encode(wire.make_attribute("x", 3))
        unknown = bytearray()
        wire._write_varint(unknown, (200 << 3) | 2)
        wire._write_varint(unknown, 4)
        unknown += b"junk"
        dec = wire.decode("AttributeProto", base + bytes(unknown))
        assert dec.name == "x" and dec.i == 3

    def test_tensor_roundtrip_dtypes(self):
        for arr in (np.arange(6, dtype=np.float32).reshape(2, 3),
                    np.arange(4, dtype=np.int64) - 2,
                    np.asarray([True, False]),
                    np.arange(3, dtype=np.float64)):
            tp = wire.make_tensor("t", arr)
            back = tensor_to_ndarray(
                wire.decode("TensorProto", wire.encode(tp)))
            np.testing.assert_array_equal(back, arr)
            assert back.dtype == arr.dtype

    def test_typed_field_fallback_float_data(self):
        # float_data instead of raw_data (spec-legal, some exporters do it)
        tp = wire.Message("TensorProto", name="w", dims=[2, 2], data_type=1,
                          float_data=[1.0, 2.0, 3.0, 4.0])
        back = tensor_to_ndarray(wire.decode("TensorProto", wire.encode(tp)))
        np.testing.assert_array_equal(
            back, np.asarray([[1, 2], [3, 4]], np.float32))


def _mlp_model(w1, b1, w2, b2):
    """Gemm(transB)+Relu+Gemm(transB)+Softmax — torch Linear layout."""
    nodes = [
        wire.make_node("Gemm", ["x", "w1", "b1"], ["h"], transB=1),
        wire.make_node("Relu", ["h"], ["hr"]),
        wire.make_node("Gemm", ["hr", "w2", "b2"], ["logits"], transB=1),
        wire.make_node("Softmax", ["logits"], ["probs"], axis=-1),
    ]
    graph = wire.make_graph(
        nodes, "mlp",
        inputs=[wire.make_value_info("x", np.float32, (4, 8))],
        outputs=[wire.make_value_info("probs", np.float32, (4, 3))],
        initializers=[wire.make_tensor("w1", w1), wire.make_tensor("b1", b1),
                      wire.make_tensor("w2", w2), wire.make_tensor("b2", b2)])
    return wire.make_model(graph, opset=17)


class TestMLPParity:
    def test_gemm_relu_softmax_vs_torch(self):
        torch.manual_seed(0)
        lin1, lin2 = torch.nn.Linear(8, 16), torch.nn.Linear(16, 3)
        model = _mlp_model(
            lin1.weight.detach().numpy(), lin1.bias.detach().numpy(),
            lin2.weight.detach().numpy(), lin2.bias.detach().numpy())
        x = np.random.RandomState(1).randn(4, 8).astype(np.float32)
        with torch.no_grad():
            golden = torch.softmax(
                lin2(torch.relu(lin1(torch.from_numpy(x)))), -1).numpy()
        _, ours = _import_and_run(model, {"x": x})
        np.testing.assert_allclose(ours, golden, atol=1e-5, rtol=1e-4)

    def test_gemm_alpha_beta_transA(self):
        rs = np.random.RandomState(2)
        a = rs.randn(5, 4).astype(np.float32)   # transA -> (4,5)@(5,3)
        w = rs.randn(5, 3).astype(np.float32)
        c = rs.randn(3).astype(np.float32)
        node = wire.make_node("Gemm", ["a", "w", "c"], ["y"],
                              alpha=0.5, beta=2.0, transA=1)
        graph = wire.make_graph(
            [node], "gemm",
            inputs=[wire.make_value_info("a", np.float32, (5, 4))],
            outputs=[wire.make_value_info("y", np.float32, (4, 3))],
            initializers=[wire.make_tensor("w", w), wire.make_tensor("c", c)])
        _, ours = _import_and_run(wire.make_model(graph), {"a": a})
        np.testing.assert_allclose(ours, 0.5 * (a.T @ w) + 2.0 * c,
                                   atol=1e-5, rtol=1e-4)

    def test_old_opset_softmax_2d_coercion(self):
        # opset < 13: Softmax(axis=1) flattens trailing dims into one
        # softmax block — different from per-last-axis softmax
        x = np.random.RandomState(3).randn(2, 3, 4).astype(np.float32)
        node = wire.make_node("Softmax", ["x"], ["y"], axis=1)
        graph = wire.make_graph(
            [node], "sm",
            inputs=[wire.make_value_info("x", np.float32, (2, 3, 4))],
            outputs=[wire.make_value_info("y", np.float32, (2, 3, 4))])
        _, ours = _import_and_run(wire.make_model(graph, opset=11), {"x": x})
        flat = x.reshape(2, 12)
        e = np.exp(flat - flat.max(1, keepdims=True))
        golden = (e / e.sum(1, keepdims=True)).reshape(2, 3, 4)
        np.testing.assert_allclose(ours, golden, atol=1e-6, rtol=1e-5)


class TestCNNParity:
    def _conv_model(self, conv, pads, strides, x_shape, extra_nodes=(),
                    out_shape=None, groups=1):
        w = conv.weight.detach().numpy()
        b = conv.bias.detach().numpy()
        nodes = [wire.make_node(
            "Conv", ["x", "w", "b"], ["c"], pads=pads, strides=strides,
            kernel_shape=list(w.shape[2:]), group=groups)]
        nodes += list(extra_nodes)
        out_name = nodes[-1].output[0]
        graph = wire.make_graph(
            nodes, "cnn",
            inputs=[wire.make_value_info("x", np.float32, x_shape)],
            outputs=[wire.make_value_info(out_name, np.float32,
                                          out_shape or (None,))],
            initializers=[wire.make_tensor("w", w), wire.make_tensor("b", b)])
        return wire.make_model(graph)

    def test_conv_relu_maxpool_flatten_gemm_vs_torch(self):
        torch.manual_seed(4)
        conv = torch.nn.Conv2d(3, 8, 3, stride=2, padding=1)
        lin = torch.nn.Linear(8 * 4 * 4, 5)
        x = np.random.RandomState(5).randn(2, 3, 16, 16).astype(np.float32)
        with torch.no_grad():
            t = torch.relu(conv(torch.from_numpy(x)))
            t = torch.max_pool2d(t, 2, 2)
            golden = lin(t.flatten(1)).numpy()
        extra = [
            wire.make_node("Relu", ["c"], ["r"]),
            wire.make_node("MaxPool", ["r"], ["p"], kernel_shape=[2, 2],
                           strides=[2, 2]),
            wire.make_node("Flatten", ["p"], ["f"], axis=1),
            wire.make_node("Gemm", ["f", "wl", "bl"], ["y"], transB=1),
        ]
        model = self._conv_model(conv, [1, 1, 1, 1], [2, 2], (2, 3, 16, 16),
                                 extra, out_shape=(2, 5))
        model.graph.initializer += [
            wire.make_tensor("wl", lin.weight.detach().numpy()),
            wire.make_tensor("bl", lin.bias.detach().numpy())]
        _, ours = _import_and_run(model, {"x": x})
        np.testing.assert_allclose(ours, golden, atol=1e-4, rtol=1e-3)

    def test_depthwise_conv_groups_vs_torch(self):
        torch.manual_seed(6)
        conv = torch.nn.Conv2d(6, 6, 3, padding=1, groups=6)
        x = np.random.RandomState(7).randn(1, 6, 8, 8).astype(np.float32)
        with torch.no_grad():
            golden = conv(torch.from_numpy(x)).numpy()
        model = self._conv_model(conv, [1, 1, 1, 1], [1, 1], (1, 6, 8, 8),
                                 groups=6)
        _, ours = _import_and_run(model, {"x": x})
        np.testing.assert_allclose(ours, golden, atol=1e-4, rtol=1e-3)

    def test_auto_pad_same_upper_vs_torch_same(self):
        torch.manual_seed(8)
        conv = torch.nn.Conv2d(2, 4, 3, padding="same")
        x = np.random.RandomState(9).randn(1, 2, 7, 7).astype(np.float32)
        with torch.no_grad():
            golden = conv(torch.from_numpy(x)).numpy()
        w = conv.weight.detach().numpy()
        b = conv.bias.detach().numpy()
        node = wire.make_node("Conv", ["x", "w", "b"], ["y"],
                              auto_pad="SAME_UPPER", strides=[1, 1],
                              kernel_shape=[3, 3])
        graph = wire.make_graph(
            [node], "sp",
            inputs=[wire.make_value_info("x", np.float32, (1, 2, 7, 7))],
            outputs=[wire.make_value_info("y", np.float32, (1, 4, 7, 7))],
            initializers=[wire.make_tensor("w", w), wire.make_tensor("b", b)])
        _, ours = _import_and_run(wire.make_model(graph), {"x": x})
        np.testing.assert_allclose(ours, golden, atol=1e-4, rtol=1e-3)

    def test_avgpool_count_include_pad_variants(self):
        x = np.random.RandomState(10).randn(1, 2, 6, 6).astype(np.float32)
        for include in (0, 1):
            with torch.no_grad():
                golden = torch.nn.functional.avg_pool2d(
                    torch.from_numpy(x), 3, 2, padding=1,
                    count_include_pad=bool(include)).numpy()
            node = wire.make_node("AveragePool", ["x"], ["y"],
                                  kernel_shape=[3, 3], strides=[2, 2],
                                  pads=[1, 1, 1, 1],
                                  count_include_pad=include)
            graph = wire.make_graph(
                [node], "ap",
                inputs=[wire.make_value_info("x", np.float32, (1, 2, 6, 6))],
                outputs=[wire.make_value_info("y", np.float32, (1, 2, 3, 3))])
            _, ours = _import_and_run(wire.make_model(graph), {"x": x})
            np.testing.assert_allclose(ours, golden, atol=1e-5, rtol=1e-4,
                                       err_msg=f"count_include_pad={include}")

    def test_batchnorm_inference_vs_torch_eval(self):
        torch.manual_seed(11)
        bn = torch.nn.BatchNorm2d(5)
        bn.weight.data.uniform_(0.5, 1.5)
        bn.bias.data.uniform_(-0.5, 0.5)
        bn.running_mean.data.normal_()
        bn.running_var.data.uniform_(0.5, 2.0)
        bn.eval()
        x = np.random.RandomState(12).randn(2, 5, 4, 4).astype(np.float32)
        with torch.no_grad():
            golden = bn(torch.from_numpy(x)).numpy()
        node = wire.make_node(
            "BatchNormalization", ["x", "g", "b", "m", "v"], ["y"],
            epsilon=float(bn.eps))
        graph = wire.make_graph(
            [node], "bn",
            inputs=[wire.make_value_info("x", np.float32, (2, 5, 4, 4))],
            outputs=[wire.make_value_info("y", np.float32, (2, 5, 4, 4))],
            initializers=[
                wire.make_tensor("g", bn.weight.detach().numpy()),
                wire.make_tensor("b", bn.bias.detach().numpy()),
                wire.make_tensor("m", bn.running_mean.numpy()),
                wire.make_tensor("v", bn.running_var.numpy())])
        _, ours = _import_and_run(wire.make_model(graph), {"x": x})
        np.testing.assert_allclose(ours, golden, atol=1e-5, rtol=1e-4)

    def test_convtranspose_vs_torch(self):
        torch.manual_seed(13)
        dc = torch.nn.ConvTranspose2d(4, 3, 3, stride=2, padding=1)
        x = np.random.RandomState(14).randn(1, 4, 5, 5).astype(np.float32)
        with torch.no_grad():
            golden = dc(torch.from_numpy(x)).numpy()
        node = wire.make_node(
            "ConvTranspose", ["x", "w", "b"], ["y"], strides=[2, 2],
            pads=[1, 1, 1, 1], kernel_shape=[3, 3])
        graph = wire.make_graph(
            [node], "dc",
            inputs=[wire.make_value_info("x", np.float32, (1, 4, 5, 5))],
            outputs=[wire.make_value_info("y", np.float32,
                                          tuple(golden.shape))],
            initializers=[
                wire.make_tensor("w", dc.weight.detach().numpy()),
                wire.make_tensor("b", dc.bias.detach().numpy())])
        _, ours = _import_and_run(wire.make_model(graph), {"x": x})
        np.testing.assert_allclose(ours, golden, atol=1e-4, rtol=1e-3)

    def test_convtranspose_auto_pad_same_upper(self):
        # spec: SAME_UPPER fixes output = input*stride; total_pad =
        # eff_kernel - stride. Oracle: torch full (pad-0) ConvTranspose
        # cropped by (lo, hi) — exactly what explicit convT pads mean.
        torch.manual_seed(26)
        dc = torch.nn.ConvTranspose2d(3, 2, 3, stride=2, bias=False)
        x = np.random.RandomState(27).randn(1, 3, 5, 5).astype(np.float32)
        with torch.no_grad():
            full = dc(torch.from_numpy(x)).numpy()  # (1, 2, 11, 11)
        tot = 3 - 2  # eff_kernel - stride = 1; SAME_UPPER -> (0, 1)
        golden = full[:, :, 0:full.shape[2] - tot, 0:full.shape[3] - tot]
        assert golden.shape == (1, 2, 10, 10)  # = input * stride
        node = wire.make_node(
            "ConvTranspose", ["x", "w"], ["y"], strides=[2, 2],
            auto_pad="SAME_UPPER", kernel_shape=[3, 3])
        graph = wire.make_graph(
            [node], "dcs",
            inputs=[wire.make_value_info("x", np.float32, (1, 3, 5, 5))],
            outputs=[wire.make_value_info("y", np.float32, (1, 2, 10, 10))],
            initializers=[wire.make_tensor("w", dc.weight.detach().numpy())])
        _, ours = _import_and_run(wire.make_model(graph), {"x": x})
        assert ours.shape == golden.shape
        np.testing.assert_allclose(ours, golden, atol=1e-4, rtol=1e-3)

    def test_global_average_pool(self):
        x = np.random.RandomState(15).randn(2, 3, 5, 7).astype(np.float32)
        node = wire.make_node("GlobalAveragePool", ["x"], ["y"])
        graph = wire.make_graph(
            [node], "gap",
            inputs=[wire.make_value_info("x", np.float32, (2, 3, 5, 7))],
            outputs=[wire.make_value_info("y", np.float32, (2, 3, 1, 1))])
        _, ours = _import_and_run(wire.make_model(graph), {"x": x})
        np.testing.assert_allclose(
            ours, x.mean((2, 3), keepdims=True), atol=1e-6, rtol=1e-5)


class TestStructuralOps:
    def test_reshape_zero_and_minus_one_semantics(self):
        x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
        shp = wire.make_tensor("s", np.asarray([0, -1], np.int64))
        node = wire.make_node("Reshape", ["x", "s"], ["y"])
        graph = wire.make_graph(
            [node], "rs",
            inputs=[wire.make_value_info("x", np.float32, (2, 3, 4))],
            outputs=[wire.make_value_info("y", np.float32, (2, 12))],
            initializers=[shp])
        _, ours = _import_and_run(wire.make_model(graph), {"x": x})
        np.testing.assert_array_equal(ours, x.reshape(2, 12))

    def test_transpose_concat_slice_unsqueeze(self):
        x = np.random.RandomState(16).randn(2, 3, 4).astype(np.float32)
        nodes = [
            wire.make_node("Transpose", ["x"], ["t"], perm=[0, 2, 1]),
            wire.make_node("Concat", ["t", "t"], ["c"], axis=2),
            wire.make_node("Slice", ["c", "st", "en", "ax"], ["s"]),
            wire.make_node("Unsqueeze", ["s", "uax"], ["y"]),
        ]
        graph = wire.make_graph(
            nodes, "struct",
            inputs=[wire.make_value_info("x", np.float32, (2, 3, 4))],
            outputs=[wire.make_value_info("y", np.float32, (1, 2, 4, 2))],
            initializers=[
                wire.make_tensor("st", np.asarray([1], np.int64)),
                wire.make_tensor("en", np.asarray([3], np.int64)),
                wire.make_tensor("ax", np.asarray([2], np.int64)),
                wire.make_tensor("uax", np.asarray([0], np.int64))])
        _, ours = _import_and_run(wire.make_model(graph), {"x": x})
        golden = np.concatenate([x.transpose(0, 2, 1)] * 2, 2)[None, :, :, 1:3]
        np.testing.assert_allclose(ours, golden, atol=1e-6, rtol=1e-5)

    def test_reduce_mean_and_clip(self):
        x = np.random.RandomState(17).randn(3, 4, 5).astype(np.float32) * 3
        nodes = [
            wire.make_node("ReduceMean", ["x"], ["m"], axes=[1],
                           keepdims=0),
            wire.make_node("Clip", ["m", "lo", "hi"], ["y"]),
        ]
        graph = wire.make_graph(
            nodes, "rm",
            inputs=[wire.make_value_info("x", np.float32, (3, 4, 5))],
            outputs=[wire.make_value_info("y", np.float32, (3, 5))],
            initializers=[
                wire.make_tensor("lo", np.float32(-1.0)),
                wire.make_tensor("hi", np.float32(1.0))])
        _, ours = _import_and_run(wire.make_model(graph), {"x": x})
        np.testing.assert_allclose(ours, np.clip(x.mean(1), -1, 1),
                                   atol=1e-6, rtol=1e-5)

    def test_pad_axes_input_opset18(self):
        # opset 18+: pads bind to the LISTED axes; others stay unpadded
        x = np.ones((3, 2), np.float32)
        node = wire.make_node("Pad", ["x", "p", "c", "ax"], ["y"])
        graph = wire.make_graph(
            [node], "pad18",
            inputs=[wire.make_value_info("x", np.float32, (3, 2))],
            outputs=[wire.make_value_info("y", np.float32, (3, 4))],
            initializers=[
                wire.make_tensor("p", np.asarray([1, 1], np.int64)),
                wire.make_tensor("c", np.float32(7.0)),
                wire.make_tensor("ax", np.asarray([1], np.int64))])
        _, ours = _import_and_run(wire.make_model(graph, opset=18), {"x": x})
        assert ours.shape == (3, 4)
        np.testing.assert_array_equal(ours[:, 0], [7, 7, 7])
        np.testing.assert_array_equal(ours[:, 1:3], np.ones((3, 2)))

    def test_slice_out_of_range_clamps(self):
        # spec: wrap negatives once, then clamp into [0, dim] — Python
        # slicing would re-wrap starts=-5 on a dim-3 axis to row 1
        x = np.arange(9, dtype=np.float32).reshape(3, 3)
        for starts, ends, golden in (
                ([-5], [3], x),                 # start clamps to 0
                ([0], [-5], x[:0]),             # end clamps to 0 (empty)
                ([1], [2**31], x[1:])):         # huge end clamps to dim
            node = wire.make_node("Slice", ["x", "st", "en", "ax"], ["y"])
            graph = wire.make_graph(
                [node], "slc",
                inputs=[wire.make_value_info("x", np.float32, (3, 3))],
                outputs=[wire.make_value_info("y", np.float32,
                                              tuple(golden.shape))],
                initializers=[
                    wire.make_tensor("st", np.asarray(starts, np.int64)),
                    wire.make_tensor("en", np.asarray(ends, np.int64)),
                    wire.make_tensor("ax", np.asarray([0], np.int64))])
            _, ours = _import_and_run(wire.make_model(graph), {"x": x})
            np.testing.assert_array_equal(ours, golden,
                                          err_msg=f"{starts}:{ends}")

    def test_reduce_noop_with_empty_axes(self):
        x = np.random.RandomState(28).randn(2, 3).astype(np.float32)
        node = wire.make_node("ReduceSum", ["x"], ["y"],
                              noop_with_empty_axes=1)
        graph = wire.make_graph(
            [node], "rnoop",
            inputs=[wire.make_value_info("x", np.float32, (2, 3))],
            outputs=[wire.make_value_info("y", np.float32, (2, 3))])
        _, ours = _import_and_run(wire.make_model(graph, opset=18), {"x": x})
        np.testing.assert_array_equal(ours, x)  # identity, NOT full reduce

    def test_gather_negative_indices_wrap(self):
        table = np.arange(20, dtype=np.float32).reshape(10, 2)
        # constant indices: normalized at import
        nodes = [wire.make_node("Gather", ["tbl", "cids"], ["y"], axis=0)]
        graph = wire.make_graph(
            nodes, "gneg",
            inputs=[wire.make_value_info("x0", np.float32, (1,))],
            outputs=[wire.make_value_info("y", np.float32, (2, 2))],
            initializers=[
                wire.make_tensor("tbl", table),
                wire.make_tensor("cids", np.asarray([-1, 0], np.int64))])
        _, ours = _import_and_run(wire.make_model(graph),
                                  {"x0": np.zeros(1, np.float32)})
        np.testing.assert_array_equal(ours, table[[-1, 0]])
        # placeholder indices: wrapped on device
        nodes = [wire.make_node("Gather", ["tbl", "ids"], ["y"], axis=0)]
        graph = wire.make_graph(
            nodes, "gneg2",
            inputs=[wire.make_value_info("ids", np.int64, (2,))],
            outputs=[wire.make_value_info("y", np.float32, (2, 2))],
            initializers=[wire.make_tensor("tbl", table)])
        _, ours = _import_and_run(
            wire.make_model(graph),
            {"ids": np.asarray([-2, 3], np.int64)})
        np.testing.assert_array_equal(ours, table[[-2, 3]])

    def test_clip_one_sided_bounds(self):
        # min/max are BOTH optional (clamp_min exports Clip with no max)
        x = np.asarray([[-2.0, -0.5, 0.5, 2.0]], np.float32)
        for ins, inits, golden in (
                (["x", "lo"], [wire.make_tensor("lo", np.float32(-1.0))],
                 np.maximum(x, -1)),
                (["x", "", "hi"], [wire.make_tensor("hi", np.float32(1.0))],
                 np.minimum(x, 1)),
                (["x"], [], x)):
            node = wire.make_node("Clip", ins, ["y"])
            graph = wire.make_graph(
                [node], "clip1",
                inputs=[wire.make_value_info("x", np.float32, (1, 4))],
                outputs=[wire.make_value_info("y", np.float32, (1, 4))],
                initializers=inits)
            _, ours = _import_and_run(wire.make_model(graph), {"x": x})
            np.testing.assert_allclose(ours, golden, atol=1e-6,
                                       err_msg=f"inputs={ins}")

    def test_global_pool_5d_and_rank_guard(self):
        # NCDHW: ALL spatial dims reduce, not just [2, 3]
        x = np.random.RandomState(25).randn(2, 3, 4, 5, 6).astype(np.float32)
        node = wire.make_node("GlobalAveragePool", ["x"], ["y"])
        graph = wire.make_graph(
            [node], "gap5",
            inputs=[wire.make_value_info("x", np.float32, (2, 3, 4, 5, 6))],
            outputs=[wire.make_value_info("y", np.float32, (2, 3, 1, 1, 1))])
        _, ours = _import_and_run(wire.make_model(graph), {"x": x})
        np.testing.assert_allclose(
            ours, x.mean((2, 3, 4), keepdims=True), atol=1e-6, rtol=1e-5)
        bad = wire.make_graph(
            [wire.make_node("GlobalMaxPool", ["x"], ["y"], name="gmp")],
            "gap2",
            inputs=[wire.make_value_info("x", np.float32, (2, 3))],
            outputs=[wire.make_value_info("y", np.float32, (2, 3))])
        with pytest.raises(ONNXImportException, match="spatial"):
            importOnnx(wire.encode(wire.make_model(bad)))

    def test_uint64_initializer_large_values(self):
        # uint64 varints must not be sign-reinterpreted on decode
        big = np.asarray([2**63 + 7, 1], np.uint64)
        tp = wire.Message("TensorProto", name="u", dims=[2], data_type=13,
                          uint64_data=[int(v) for v in big])
        back = tensor_to_ndarray(wire.decode("TensorProto", wire.encode(tp)))
        np.testing.assert_array_equal(back, big)
        assert back.dtype == np.uint64

    def test_structural_const_through_identity(self):
        # exporters routinely wrap initializers in Identity; const-ness
        # must survive for structural args like Reshape's shape input
        x = np.arange(12, dtype=np.float32).reshape(3, 4)
        nodes = [
            wire.make_node("Identity", ["s"], ["s2"]),
            wire.make_node("Reshape", ["x", "s2"], ["y"]),
        ]
        graph = wire.make_graph(
            nodes, "idc",
            inputs=[wire.make_value_info("x", np.float32, (3, 4))],
            outputs=[wire.make_value_info("y", np.float32, (4, 3))],
            initializers=[wire.make_tensor("s", np.asarray([4, 3],
                                                           np.int64))])
        _, ours = _import_and_run(wire.make_model(graph), {"x": x})
        np.testing.assert_array_equal(ours, x.reshape(4, 3))

    def test_gather_embedding_lookup(self):
        table = np.random.RandomState(18).randn(10, 6).astype(np.float32)
        idx = np.asarray([[1, 3], [7, 0]], np.int64)
        nodes = [wire.make_node("Gather", ["tbl", "ids"], ["y"], axis=0)]
        graph = wire.make_graph(
            nodes, "emb",
            inputs=[wire.make_value_info("ids", np.int64, (2, 2))],
            outputs=[wire.make_value_info("y", np.float32, (2, 2, 6))],
            initializers=[wire.make_tensor("tbl", table)])
        _, ours = _import_and_run(wire.make_model(graph), {"ids": idx})
        np.testing.assert_allclose(ours, table[idx], atol=1e-6)


class TestActivationsParity:
    def test_activation_zoo_vs_torch(self):
        x = np.random.RandomState(19).randn(3, 7).astype(np.float32)
        cases = {
            "LeakyRelu": (dict(alpha=0.1),
                          lambda t: torch.nn.functional.leaky_relu(t, 0.1)),
            "Elu": (dict(alpha=1.0), torch.nn.functional.elu),
            "Selu": (dict(), torch.selu),
            "Softplus": (dict(), torch.nn.functional.softplus),
            "HardSigmoid": (dict(alpha=1 / 6, beta=0.5),
                            torch.nn.functional.hardsigmoid),
            "Erf": (dict(), torch.erf),
        }
        for op, (attrs, fn) in cases.items():
            node = wire.make_node(op, ["x"], ["y"], **attrs)
            graph = wire.make_graph(
                [node], op,
                inputs=[wire.make_value_info("x", np.float32, (3, 7))],
                outputs=[wire.make_value_info("y", np.float32, (3, 7))])
            with torch.no_grad():
                golden = fn(torch.from_numpy(x)).numpy()
            _, ours = _import_and_run(wire.make_model(graph), {"x": x})
            np.testing.assert_allclose(ours, golden, atol=1e-5, rtol=1e-4,
                                       err_msg=op)

    def test_prelu_broadcast_slope(self):
        x = np.random.RandomState(20).randn(2, 4, 3, 3).astype(np.float32)
        slope = np.asarray([0.1, 0.2, 0.3, 0.4], np.float32).reshape(4, 1, 1)
        with torch.no_grad():
            golden = torch.nn.functional.prelu(
                torch.from_numpy(x),
                torch.from_numpy(slope.ravel())).numpy()
        node = wire.make_node("PRelu", ["x", "s"], ["y"])
        graph = wire.make_graph(
            [node], "prelu",
            inputs=[wire.make_value_info("x", np.float32, (2, 4, 3, 3))],
            outputs=[wire.make_value_info("y", np.float32, (2, 4, 3, 3))],
            initializers=[wire.make_tensor("s", slope)])
        _, ours = _import_and_run(wire.make_model(graph), {"x": x})
        np.testing.assert_allclose(ours, golden, atol=1e-6, rtol=1e-5)


class TestErrorsAndTraining:
    def test_unsupported_op_names_node(self):
        node = wire.make_node("NonMaxSuppressionV99", ["x"], ["y"],
                              name="bad_node")
        graph = wire.make_graph(
            [node], "err",
            inputs=[wire.make_value_info("x", np.float32, (1,))],
            outputs=[wire.make_value_info("y", np.float32, (1,))])
        with pytest.raises(ONNXImportException, match="bad_node"):
            importOnnx(wire.encode(wire.make_model(graph)))

    def test_symbolic_batch_requires_input_shapes(self):
        node = wire.make_node("Relu", ["x"], ["y"])
        graph = wire.make_graph(
            [node], "dyn",
            inputs=[wire.make_value_info("x", np.float32, (None, 4))],
            outputs=[wire.make_value_info("y", np.float32, (None, 4))])
        model = wire.make_model(graph)
        with pytest.raises(ONNXImportException, match="inputShapes"):
            importOnnx(wire.encode(model))
        sd = importOnnx(wire.encode(model), inputShapes={"x": (2, 4)})
        x = np.asarray([[-1, 2, -3, 4]] * 2, np.float32)
        np.testing.assert_array_equal(
            _run(sd, {"x": x}, "y"), np.maximum(x, 0))

    def test_imported_graph_is_trainable_grad_parity_vs_torch(self):
        # gradients flow through an imported Gemm+Relu chain — the
        # imported graph is a FULL SameDiff graph, not a frozen artifact.
        # Oracle: torch autograd on the identical computation.
        torch.manual_seed(21)
        lin1, lin2 = torch.nn.Linear(8, 16), torch.nn.Linear(16, 3)
        model = _mlp_model(
            lin1.weight.detach().numpy(), lin1.bias.detach().numpy(),
            lin2.weight.detach().numpy(), lin2.bias.detach().numpy())
        sd = importOnnx(wire.encode(model))
        x = np.random.RandomState(22).randn(4, 8).astype(np.float32)
        logits = OnnxGraphMapper.outputVariable(sd, "logits")
        sd._op("sum", [logits]).markAsLoss()
        w1 = sd._onnx_vars["w1"]
        grads = sd.calculateGradients({"x": x}, w1.name, "x")

        xt = torch.from_numpy(x).requires_grad_(True)
        lin2(torch.relu(lin1(xt))).sum().backward()
        np.testing.assert_allclose(
            grads[w1.name].toNumpy(), lin1.weight.grad.numpy(),
            atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(
            grads["x"].toNumpy(), xt.grad.numpy(),
            atol=1e-5, rtol=1e-4)

    def test_fp16_graph_stays_fp16(self):
        # helper constants (Gemm alpha, HardSigmoid, one-sided Clip)
        # must bind in the graph's dtype — float32 literals would
        # silently promote the whole downstream graph under jax rules
        rs = np.random.RandomState(30)
        w = rs.randn(4, 4).astype(np.float16)
        nodes = [
            wire.make_node("Gemm", ["x", "w"], ["g"], alpha=0.5, transB=1),
            wire.make_node("HardSigmoid", ["g"], ["h"],
                           alpha=0.2, beta=0.5),
            wire.make_node("Clip", ["h", "lo"], ["y"]),
        ]
        graph = wire.make_graph(
            nodes, "fp16",
            inputs=[wire.make_value_info("x", np.float16, (2, 4))],
            outputs=[wire.make_value_info("y", np.float16, (2, 4))],
            initializers=[wire.make_tensor("w", w),
                          wire.make_tensor("lo", np.float16(0.1))])
        _, ours = _import_and_run(wire.make_model(graph),
                                  {"x": rs.randn(2, 4).astype(np.float16)})
        assert ours.dtype == np.float16, ours.dtype

    def test_model_file_roundtrip(self, tmp_path):
        torch.manual_seed(23)
        lin = torch.nn.Linear(4, 2)
        node = wire.make_node("Gemm", ["x", "w", "b"], ["y"], transB=1)
        graph = wire.make_graph(
            [node], "file",
            inputs=[wire.make_value_info("x", np.float32, (3, 4))],
            outputs=[wire.make_value_info("y", np.float32, (3, 2))],
            initializers=[
                wire.make_tensor("w", lin.weight.detach().numpy()),
                wire.make_tensor("b", lin.bias.detach().numpy())])
        path = tmp_path / "m.onnx"
        path.write_bytes(wire.encode(wire.make_model(graph)))
        sd = importOnnx(str(path))
        x = np.random.RandomState(24).randn(3, 4).astype(np.float32)
        with torch.no_grad():
            golden = lin(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(_run(sd, {"x": x}, "y"), golden,
                                   atol=1e-5, rtol=1e-4)


# ----------------------------------------------------------------------
# the codec copies write the same bytes; ResNet-50 from the zoo net
# ----------------------------------------------------------------------

def _mlp_with(w, seed=0):
    rs = np.random.RandomState(seed)
    w1, b1 = rs.randn(16, 8).astype(np.float32), rs.randn(16).astype(
        np.float32)
    nodes = [w.make_node("Gemm", ["x", "w1", "b1"], ["h"], transB=1,
                         alpha=0.5),
             w.make_node("Relu", ["h"], ["y"])]
    graph = w.make_graph(
        nodes, "mlp", inputs=[w.make_value_info("x", np.float32, (None, 8))],
        outputs=[w.make_value_info("y", np.float32, (None, 16))],
        initializers=[w.make_tensor("w1", w1), w.make_tensor("b1", b1),
                      w.make_tensor("i64", np.arange(3, dtype=np.int64) - 1),
                      w.make_tensor("f16", np.ones(2, np.float16))])
    return w.make_model(graph, opset=13)


def test_wire_copies_write_the_same_bytes():
    a, b = wire.encode(_mlp_with(wire)), jwire.encode(_mlp_with(jwire))
    assert a == b
    assert wire.encode(wire.decode("ModelProto", b)) == b


def test_fp16_and_bf16_initializers_decode_without_ml_dtypes():
    bits = np.array([0x3F80, 0xC040, 0x0001, 0x7F80], np.uint16)  # bf16
    tp = wire.Message("TensorProto", name="b", dims=[4], data_type=16,
                      raw_data=bits.tobytes())
    got = tensor_to_ndarray(wire.decode("TensorProto", wire.encode(tp)))
    want = (bits.astype(np.uint32) << 16).view(np.float32)
    np.testing.assert_array_equal(got, want)
    tp = wire.Message("TensorProto", name="h", dims=[2], data_type=10,
                      int32_data=[0x3C00, 0xC000])
    got = tensor_to_ndarray(wire.decode("TensorProto", wire.encode(tp)))
    assert got.dtype == np.float16
    np.testing.assert_array_equal(got, [1.0, -2.0])


def test_resnet50_one_bottleneck_a_stage_vs_the_zoo_net():
    """tests/_torch_onnx_models.py writes the port's zoo ResNet-50 (one
    bottleneck a stage, 32x32, 10 classes, random weights and BN running
    statistics from seed 0) as ONNX; both importers read the same bytes,
    and their logits are held to the net's own eval-mode logits within
    1e-4 of the max-abs, with top-1 equal, and their probabilities to
    its output."""
    import _torch_onnx_models as om
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import strip_carries

    conf = om.resnet50_conf(blocks=(1, 1, 1, 1), numClasses=10,
                            inputShape=(3, 32, 32))
    net = ComputationGraph(conf, device="cpu").init()
    rs = np.random.RandomState(0)
    with torch.no_grad():
        for st in net._states.values():
            if st:
                st["mean"].copy_(torch.from_numpy(
                    rs.randn(*st["mean"].shape).astype(np.float32) * 0.1))
                st["var"].copy_(torch.from_numpy(rs.uniform(
                    0.5, 1.5, st["var"].shape).astype(np.float32)))
    x = rs.randn(4, 3, 32, 32).astype(np.float32)
    with torch.no_grad():
        _, pre, _ = net._run_graph(net._params, strip_carries(net._states),
                                   net._coerce_inputs(x), False, None, None)
    want_logits = pre["fc"].numpy()
    want_probs = net.output(x).toNumpy()
    data = wire.encode(om.resnet_onnx(net, 4))
    tol = 1e-4 * np.abs(want_logits).max()
    for sd in (importOnnx(data), jimportOnnx(data)):
        names = [sd._onnx_vars[n].name for n in ("logits", "probs")]
        got = sd.output({"input": x}, names)
        logits, probs = (got[n].toNumpy() for n in names)
        assert np.abs(logits - want_logits).max() <= tol
        np.testing.assert_array_equal(logits.argmax(1),
                                      want_logits.argmax(1))
        np.testing.assert_allclose(probs, want_probs, atol=1e-5)
