"""Memory-traffic attribution as a diagnostic (reference:
``deeplearning4j_tpu/analysis/hbm.py``).

One known model's train step, run once under ``util.hbm_ledger``'s
count (the reference compiles it and reads the HLO; the port dispatches
it and counts each aten op's bytes), every byte put in a bin, the floor
beside the total, and the dtype audit. ``precompile_subject`` captures
the subject's train step (``runtime.aot``) and reports its key.
"""

from __future__ import annotations

__all__ = ["SUBJECTS", "build_subject", "precompile_subject",
           "run_attribution"]

#: the subjects, each built into (net, x_shape, optimizer slots)
SUBJECTS = ("lenet", "resnet_block")


def build_subject(name, batch_size=32, device=None):
    """(net, x_shape, optimizer_slots) of one subject in bf16, the
    reference's configurations (its ``build_subject``). `device`: the
    card unless "cpu"."""
    from deeplearning4j_tpu_torch.ndarray.dtype import DataType

    if name == "lenet":
        from deeplearning4j_tpu_torch.zoo import LeNet

        net = LeNet(numClasses=10, inputShape=(1, 28, 28),
                    dataType=DataType.BFLOAT16, device=device).init()
        return net, (batch_size, 1, 28, 28), 1
    if name == "resnet_block":
        from deeplearning4j_tpu_torch.nn.conf.builder import \
            NeuralNetConfiguration
        from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
        from deeplearning4j_tpu_torch.nn.conf.layers import (
            BatchNormalization, ConvolutionLayer, GlobalPoolingLayer,
            OutputLayer,
        )
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        from deeplearning4j_tpu_torch.nn.updaters import Nesterovs

        conf = (NeuralNetConfiguration.Builder()
                .seed(12).updater(Nesterovs(0.1, 0.9))
                .dataType(DataType.BFLOAT16)
                .activation("relu").list()
                .layer(ConvolutionLayer(nOut=32, kernelSize=(3, 3),
                                        stride=(1, 1), padding=(1, 1)))
                .layer(BatchNormalization())
                .layer(ConvolutionLayer(nOut=32, kernelSize=(3, 3),
                                        stride=(1, 1), padding=(1, 1)))
                .layer(BatchNormalization())
                .layer(GlobalPoolingLayer())
                .layer(OutputLayer(nOut=10, activation="softmax",
                                   lossFunction="mcxent"))
                .setInputType(InputType.convolutional(16, 16, 3))
                .build())
        net = MultiLayerNetwork(conf, device=device).init()
        return net, (batch_size, 3, 16, 16), 1
    raise ValueError(
        f"unknown attribution subject {name!r}; pick one of {SUBJECTS}")


def precompile_subject(subject, batch_size=32, cache=None, device=None):
    """Capture one subject's train step; {entry: {key, status,
    seconds}}."""
    net, _x_shape, _slots = build_subject(subject, batch_size, device)
    return net.precompile(batchSize=batch_size, entries=("train",),
                          cache=cache)


def run_attribution(subject="lenet", batch_size=32, device=None):
    """Count and attribute one subject's step -> (record, text): the
    ``attribute_ledger`` record plus ``compiled_cost``'s total (the
    cross-check) and the audit's offender count."""
    from deeplearning4j_tpu_torch.util import hbm_ledger

    net, x_shape, slots = build_subject(subject, batch_size, device)
    rows = hbm_ledger.record_step(net, x_shape)
    rec = hbm_ledger.attribute_ledger(net, x_shape, optimizer_slots=slots,
                                      rows=rows)
    rec["subject"] = subject
    audit = hbm_ledger.audit_activation_dtypes(net, x_shape, rows=rows)
    rec["wide_activation_buffers"] = len(audit)
    text = (f"subject: {subject} (batch {batch_size}, bf16, "
            f"{net.device})\n" + hbm_ledger.format_attribution(rec, gb=False)
            + f"\ndtype audit      {len(audit)} wide-float "
              "activation-scale output(s)")
    for r in audit[:5]:
        text += (f"\n    {r['scope'][:40]:<42} {r['op'][:16]:<17}"
                 f"{r['dtype']:<9}{r['bytes']} B")
    return rec, text
