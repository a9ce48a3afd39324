"""The port's ``entry()`` (reference: ``__graft_entry__.py`` ``entry``):
the flagship's forward, ready to run.

``entry()`` builds the zoo ResNet-50 (1000 classes, 224², bf16 compute)
on the card, captures its inference forward at batch 8 as a CUDA graph
(``runtime.aot``) and returns ``(forward, (params, x))``: ``forward(params,
x)`` copies x into the graph's static input, replays it and returns the
logits [8, 1000] (a copy, so a result outlives the next call). `params`
are the network's own tensors; the graph holds them, so any other params
raise. ``device="cpu"`` builds and runs it eagerly (``batch`` and
``image`` cut the size for a test).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["entry"]


def entry(device=None, batch=8, image=224, seed=0):
    """(forward, (params, x)) of the bf16 ResNet-50 forward (module
    docstring)."""
    from deeplearning4j_tpu_torch.ndarray.dtype import DataType
    from deeplearning4j_tpu_torch.runtime import aot
    from deeplearning4j_tpu_torch.zoo import ResNet50

    net = ResNet50(numClasses=1000, inputShape=(3, image, image),
                   dataType=DataType.BFLOAT16, device=device).init()

    def body(x):
        with torch.no_grad():
            return net._forward_infer(net._params, x)

    step = aot.CapturedStep(body, owner=net, entry="entry_forward")
    x = torch.from_numpy(np.random.RandomState(seed).rand(
        batch, 3, image, image).astype(np.float32)).to(net.device)
    step.capture((x,))

    def forward(params, x):
        if params is not net._params:
            raise ValueError("forward runs the captured graph, which "
                             "holds the network's own params: pass the "
                             "params entry() returned")
        return step(x.to(net.device)).clone()

    return forward, (net._params, x)
