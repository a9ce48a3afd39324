"""ONNX models of the port's zoo ResNet-50, written through the port's own
wire codec (no jax: ``chip_smoke.py`` imports this file on the card's
machine, the CPU tests at a cut depth).

``resnet_onnx(net, batch)`` walks a ComputationGraph of the zoo
ResNet-50's layer kinds (convolution, batch norm with its activation,
max pooling, the residual add, relu, global average pooling and the
softmax output layer) and writes its weights and BN running statistics
as an NCHW ONNX model of Conv, BatchNormalization, Relu, Add, MaxPool,
GlobalAveragePool, Flatten, Gemm and Softmax nodes. ``resnet50_conf``
builds the zoo net's configuration with a chosen number of bottlenecks a
stage (the zoo's is (3, 4, 6, 3)).
"""

import numpy as np

from deeplearning4j_tpu_torch.modelimport import onnx_wire as wire
from deeplearning4j_tpu_torch.nn.graph import params_to_reference
from deeplearning4j_tpu_torch.ndarray.ndarray import to_numpy
from deeplearning4j_tpu_torch.ops.conv import same_pads

ZOO_BLOCKS = (3, 4, 6, 3)


def resnet50_conf(blocks=ZOO_BLOCKS, numClasses=1000, inputShape=(3, 224, 224),
                  seed=0):
    """The zoo ResNet50's configuration (its stem, bottlenecks and head)
    with `blocks` bottlenecks a stage."""
    from deeplearning4j_tpu_torch.nn.conf.builder import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        BatchNormalization, ConvolutionLayer, GlobalPoolingLayer,
        OutputLayer, SubsamplingLayer,
    )
    from deeplearning4j_tpu_torch.nn.updaters import Nesterovs
    from deeplearning4j_tpu_torch.nn.weights import WeightInit
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    if tuple(blocks) == ZOO_BLOCKS:
        return ResNet50(numClasses=numClasses, inputShape=inputShape,
                        seed=seed).conf()
    c, h, w = inputShape
    g = (NeuralNetConfiguration.Builder().seed(seed)
         .updater(Nesterovs(1e-1, 0.9)).weightInit(WeightInit.RELU)
         .graphBuilder().addInputs("input"))
    g.addLayer("conv1", ConvolutionLayer(nOut=64, kernelSize=(7, 7),
                                         stride=(2, 2), padding=(3, 3),
                                         activation="identity",
                                         hasBias=False), "input")
    g.addLayer("bn1", BatchNormalization(activation="relu"), "conv1")
    g.addLayer("pool1", SubsamplingLayer(poolingType="max", kernelSize=(3, 3),
                                         stride=(2, 2), padding=(1, 1)),
               "bn1")
    prev = "pool1"
    stages = [(64, 256, 1), (128, 512, 2), (256, 1024, 2), (512, 2048, 2)]
    for si, (n, (mid, out, stride0)) in enumerate(zip(blocks, stages)):
        for bi in range(n):
            prev = ResNet50._bottleneck(g, f"s{si}b{bi}", prev, mid, out,
                                        stride0 if bi == 0 else 1,
                                        project=(bi == 0))
    g.addLayer("gap", GlobalPoolingLayer(poolingType="avg"), prev)
    g.addLayer("fc", OutputLayer(nOut=numClasses, activation="softmax",
                                 lossFunction="mcxent"), "gap")
    return (g.setOutputs("fc")
            .setInputTypes(InputType.convolutional(h, w, c)).build())


def _hw(it):
    return it.height, it.width


def resnet_onnx(net, batch):
    """The ComputationGraph `net` (the zoo ResNet-50's layer kinds, NCHW
    input "input") as an ONNX ModelProto at batch `batch`, opset 17:
    conv weights OIHW, BN (scale, bias, running mean, running var), the
    output layer as Gemm + Softmax. Its input is "input" and its output
    "probs" (the logits, before the softmax, are "logits")."""
    conf = net.conf
    ref = params_to_reference(conf, net._params)
    states = {n: {k: to_numpy(v) for k, v in s.items()}
              for n, s in (net._states or {}).items() if s}
    nodes, inits = [], []
    it_in = conf.inputTypes["input"]
    out_type = {"input": it_in}

    def init(name, arr):
        inits.append(wire.make_tensor(name, np.ascontiguousarray(
            arr, dtype=np.float32)))
        return name

    for name in conf.topoOrder:
        node = conf.nodes[name]
        if node.kind == "input":
            continue
        src = node.inputs[0]
        in_type = out_type[src]
        p = node.payload
        kind = type(p).__name__
        out = name
        if kind == "ConvolutionLayer":
            W = ref[name]["W"]                       # HWIO
            k, s = tuple(p.kernelSize), tuple(p.stride)
            if str(p.convolutionMode).lower() == "same":
                H, Wd = _hw(in_type)
                (t, b), (l, r) = (same_pads(H, k[0], s[0]),
                                  same_pads(Wd, k[1], s[1]))
            else:
                (t, b), (l, r) = [(q, q) for q in p.padding]
            ins = [src, init(f"{name}.W", W.transpose(3, 2, 0, 1))]
            if "b" in ref[name]:
                ins.append(init(f"{name}.b", ref[name]["b"]))
            nodes.append(wire.make_node(
                "Conv", ins, [out], kernel_shape=list(k), strides=list(s),
                pads=[t, l, b, r], dilations=list(p.dilation)))
        elif kind == "BatchNormalization":
            st = states[name]
            ins = [src] + [init(f"{name}.{k}", v) for k, v in (
                ("gamma", ref[name]["gamma"]), ("beta", ref[name]["beta"]),
                ("mean", st["mean"]), ("var", st["var"]))]
            act = p.activation
            bn_out = f"{name}.bn" if act == "relu" else out
            nodes.append(wire.make_node("BatchNormalization", ins, [bn_out],
                                        epsilon=float(p.eps)))
            if act == "relu":
                nodes.append(wire.make_node("Relu", [bn_out], [out]))
            elif act != "identity":
                raise ValueError(f"{name}: BN activation {act!r}")
        elif kind == "SubsamplingLayer":
            if p.poolingType != "max":
                raise ValueError(f"{name}: pooling {p.poolingType!r}")
            (pt, pl) = p.padding
            nodes.append(wire.make_node(
                "MaxPool", [src], [out], kernel_shape=list(p.kernelSize),
                strides=list(p.stride), pads=[pt, pl, pt, pl]))
        elif kind == "ElementWiseVertex":
            nodes.append(wire.make_node("Add", list(node.inputs), [out]))
        elif kind == "ActivationLayer":
            nodes.append(wire.make_node("Relu", [src], [out]))
        elif kind == "GlobalPoolingLayer":
            nodes.append(wire.make_node("GlobalAveragePool", [src],
                                        [f"{name}.pool"]))
            nodes.append(wire.make_node("Flatten", [f"{name}.pool"], [out],
                                        axis=1))
        elif kind == "OutputLayer":
            ins = [src, init(f"{name}.W", ref[name]["W"]),
                   init(f"{name}.b", ref[name]["b"])]
            nodes.append(wire.make_node("Gemm", ins, ["logits"]))
            nodes.append(wire.make_node("Softmax", ["logits"], ["probs"],
                                        axis=-1))
            out = "probs"
        else:
            raise ValueError(f"{name}: no ONNX form for {kind}")
        out_type[name] = node.inputType
    c, h, w = it_in.channels, it_in.height, it_in.width
    n_out = conf.nodes[conf.networkOutputs[0]].payload.nOut
    graph = wire.make_graph(
        nodes, "resnet50",
        inputs=[wire.make_value_info("input", np.float32, (batch, c, h, w))],
        outputs=[wire.make_value_info("probs", np.float32, (batch, n_out))],
        initializers=inits)
    return wire.make_model(graph, opset=17)
