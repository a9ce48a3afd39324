"""The network helpers that ``nn/graph.py`` shares with the sequential
network.

The counterpart of the module-level helpers of
``deeplearning4j_tpu/nn/multilayer.py``: ``_unwrap``, ``_tm`` (training
telemetry), ``strip_carries``, ``cast_params``, ``default_param_update``,
``_grad_normalize`` and ``_out_act`` (``MultiLayerNetwork._out_act`` in
the reference). The ``MultiLayerNetwork`` class itself waits for the
LeNet slice (ROADMAP.md Queue 1 item 4).
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn import activations as _act
from deeplearning4j_tpu_torch.nn.conf.builder import GradientNormalization

__all__ = ["strip_carries", "cast_params", "default_param_update"]


def _unwrap(x, device=None):
    """A tensor, numpy array or nested list as a tensor on `device`."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    arr = np.asarray(x)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device or "cpu")


_TM = None


def _tm():
    """Training telemetry handles, resolved once: the ``train.step`` span
    and the step histogram and counter on the port's registry."""
    global _TM
    if _TM is None:
        from deeplearning4j_tpu_torch.runtime import telemetry

        reg = telemetry.get_registry()
        _TM = {
            "reg": reg,
            "step_s": reg.histogram(
                "dl4j_train_step_seconds",
                "train-step wall: forward, backward, update and the loss "
                "fetch, host-observed").labels(),
            "steps": reg.counter(
                "dl4j_train_steps_total", "optimizer steps applied").labels(),
        }
    return _TM


def strip_carries(states):
    """Drop transient rnn carries (h/c) from a {layer: state} dict; keep
    persistent state."""

    def strip(s):
        if isinstance(s, dict):
            return {k: strip(v) for k, v in s.items() if k not in ("h", "c")}
        return s

    return {n: strip(s) for n, s in states.items()}


def cast_params(p, compute_dtype, param_dtype):
    """fp32 master params -> the compute dtype (bf16/fp16) for the
    forward; autograd carries the gradient back to the fp32 master."""
    if compute_dtype == param_dtype:
        return p
    return {k: a.to(compute_dtype) if a.is_floating_point() else a
            for k, a in p.items()}


def default_param_update(updater, grads, upd_state, iteration, params):
    """Apply one layer's updater and subtract its updates from the params
    in place (the caller holds ``torch.no_grad()``)."""
    upd, us = updater.apply(grads, upd_state, iteration, params=params)
    for k, p in params.items():
        p.sub_(upd[k].to(p.dtype))
    return params, us


def _grad_normalize(grads_per_layer, mode, threshold):
    """Gradient clipping/normalization over per-layer {name: grad} dicts
    (reference: GradientNormalization)."""
    if mode is None:
        return grads_per_layer
    out = []
    for g in grads_per_layer:
        if not g:
            out.append(g)
            continue
        if mode == GradientNormalization.ClipElementWiseAbsoluteValue:
            g = {k: torch.clamp(a, -threshold, threshold)
                 for k, a in g.items()}
        elif mode in (GradientNormalization.ClipL2PerLayer,
                      GradientNormalization.RenormalizeL2PerLayer):
            l2 = torch.sqrt(sum(a.square().sum() for a in g.values())
                            + 1e-12)
            scale = (torch.clamp(threshold / l2, max=1.0)
                     if mode == GradientNormalization.ClipL2PerLayer
                     else 1.0 / l2)
            g = {k: a * scale for k, a in g.items()}
        elif mode in (GradientNormalization.ClipL2PerParamType,
                      GradientNormalization.RenormalizeL2PerParamType):
            def per_param(a):
                l2 = torch.sqrt(a.square().sum() + 1e-12)
                if mode == GradientNormalization.ClipL2PerParamType:
                    return a * torch.clamp(threshold / l2, max=1.0)
                return a / l2
            g = {k: per_param(a) for k, a in g.items()}
        out.append(g)
    return out


def _out_act(layer, pre):
    """The output activation over the CLASS axis: NCW [B,O,T] output
    needs softmax over O, not the trailing time axis."""
    act = _act.get(layer.activation)
    if pre.dim() == 3:
        return act(pre.transpose(1, 2)).transpose(1, 2)
    return act(pre)
