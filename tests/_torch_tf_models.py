"""Frozen TensorFlow GraphDefs of the port's zoo ResNet-50, written through
the port's own GraphDef codec ``modelimport/tf_wire.py`` (no jax and no
tensorflow: ``chip_smoke.py`` imports this file on the card's machine,
the CPU tests at a cut depth).

``resnet_graphdef(net, batch)`` walks a ComputationGraph of the zoo
ResNet-50's layer kinds (convolution, batch norm with its activation,
max pooling, the residual add, relu, global average pooling and the
softmax output layer) and writes its weights and BN running statistics
as an NHWC frozen graph of Placeholder, Const, Conv2D (EXPLICIT
padding), FusedBatchNormV3, Relu, AddV2, MaxPool (EXPLICIT padding),
Mean, MatMul, BiasAdd and Softmax nodes, as TF's freezing writes them.
Its input is "input" [B, H, W, C]; its outputs are "logits" and
"probs".
"""

import numpy as np

from deeplearning4j_tpu_torch.modelimport import tf_wire as tw
from deeplearning4j_tpu_torch.nn.graph import params_to_reference
from deeplearning4j_tpu_torch.ndarray.ndarray import to_numpy
from deeplearning4j_tpu_torch.ops.conv import same_pads

DT_FLOAT, DT_INT32 = 1, 3


def _pads(layer, in_hw):
    """The (top, bottom), (left, right) pads of a conv or pool layer."""
    k, s = tuple(layer.kernelSize), tuple(layer.stride)
    if str(layer.convolutionMode).lower() == "same":
        return (same_pads(in_hw[0], k[0], s[0]),
                same_pads(in_hw[1], k[1], s[1]))
    return tuple((q, q) for q in layer.padding)


def _out_hw(layer, in_hw, pads):
    k, s = tuple(layer.kernelSize), tuple(layer.stride)
    return tuple((n + lo + hi - kk) // ss + 1
                 for n, (lo, hi), kk, ss in zip(in_hw, pads, k, s))


def resnet_graphdef(net, batch):
    """The ComputationGraph `net` (the zoo ResNet-50's layer kinds, input
    "input") as a frozen GraphDef Message at batch `batch`."""
    conf = net.conf
    ref = params_to_reference(conf, net._params)
    states = {n: {k: to_numpy(v) for k, v in s.items()}
              for n, s in (net._states or {}).items() if s}
    it = conf.inputTypes["input"]
    nodes = [tw.make_node("Placeholder", "input", dtype=("type", DT_FLOAT),
                          shape=("shape", (batch, it.height, it.width,
                                           it.channels)))]
    hw = {"input": (it.height, it.width)}

    def const(name, arr, dtype=DT_FLOAT):
        arr = np.ascontiguousarray(arr, dtype=np.float32 if dtype == DT_FLOAT
                                   else np.int32)
        nodes.append(tw.make_node("Const", name, dtype=("type", dtype),
                                  value=arr))
        return name

    for name in conf.topoOrder:
        node = conf.nodes[name]
        if node.kind == "input":
            continue
        src = node.inputs[0]
        p = node.payload
        kind = type(p).__name__
        if kind == "ConvolutionLayer":
            (t, b), (l, r) = pads = _pads(p, hw[src])
            ins = [src, const(f"{name}/W", ref[name]["W"])]   # HWIO
            conv = name if "b" not in ref[name] else f"{name}/conv"
            nodes.append(tw.make_node(
                "Conv2D", conv, ins, T=("type", DT_FLOAT),
                strides=[1, *p.stride, 1], padding="EXPLICIT",
                explicit_paddings=[0, 0, t, b, l, r, 0, 0],
                dilations=[1, *p.dilation, 1], data_format="NHWC"))
            if "b" in ref[name]:
                nodes.append(tw.make_node(
                    "BiasAdd", name, [conv, const(f"{name}/b",
                                                  ref[name]["b"])],
                    T=("type", DT_FLOAT), data_format="NHWC"))
            hw[name] = _out_hw(p, hw[src], pads)
        elif kind == "BatchNormalization":
            st = states[name]
            act = p.activation
            bn = f"{name}/bn" if act == "relu" else name
            ins = [src] + [const(f"{name}/{k}", v) for k, v in (
                ("gamma", ref[name]["gamma"]), ("beta", ref[name]["beta"]),
                ("mean", st["mean"]), ("var", st["var"]))]
            nodes.append(tw.make_node(
                "FusedBatchNormV3", bn, ins, T=("type", DT_FLOAT),
                U=("type", DT_FLOAT), epsilon=float(p.eps),
                data_format="NHWC", is_training=False))
            if act == "relu":
                nodes.append(tw.make_node("Relu", name, [bn],
                                          T=("type", DT_FLOAT)))
            elif act != "identity":
                raise ValueError(f"{name}: BN activation {act!r}")
            hw[name] = hw[src]
        elif kind == "SubsamplingLayer":
            if p.poolingType != "max":
                raise ValueError(f"{name}: pooling {p.poolingType!r}")
            (t, b), (l, r) = pads = _pads(p, hw[src])
            nodes.append(tw.make_node(
                "MaxPool", name, [src], T=("type", DT_FLOAT),
                ksize=[1, *p.kernelSize, 1], strides=[1, *p.stride, 1],
                padding="EXPLICIT", explicit_paddings=[0, 0, t, b, l, r, 0, 0],
                data_format="NHWC"))
            hw[name] = _out_hw(p, hw[src], pads)
        elif kind == "ElementWiseVertex":
            nodes.append(tw.make_node("AddV2", name, list(node.inputs),
                                      T=("type", DT_FLOAT)))
            hw[name] = hw[src]
        elif kind == "ActivationLayer":
            nodes.append(tw.make_node("Relu", name, [src],
                                      T=("type", DT_FLOAT)))
            hw[name] = hw[src]
        elif kind == "GlobalPoolingLayer":
            nodes.append(tw.make_node(
                "Mean", name, [src, const(f"{name}/axes", [1, 2], DT_INT32)],
                T=("type", DT_FLOAT), Tidx=("type", DT_INT32),
                keep_dims=False))
        elif kind == "OutputLayer":
            nodes.append(tw.make_node(
                "MatMul", f"{name}/matmul",
                [src, const(f"{name}/W", ref[name]["W"])],
                T=("type", DT_FLOAT), transpose_a=False, transpose_b=False))
            nodes.append(tw.make_node(
                "BiasAdd", "logits",
                [f"{name}/matmul", const(f"{name}/b", ref[name]["b"])],
                T=("type", DT_FLOAT), data_format="NHWC"))
            nodes.append(tw.make_node("Softmax", "probs", ["logits"],
                                      T=("type", DT_FLOAT)))
        else:
            raise ValueError(f"{name}: no GraphDef form for {kind}")
    return tw.make_graph(nodes, producer=1882)
