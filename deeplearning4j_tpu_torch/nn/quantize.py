"""Weight-only int8 quantization for batch inference.

The counterpart of ``deeplearning4j_tpu/nn/quantize.py``: symmetric
absmax quantization, per output channel for matrix and conv weights,
``q = round(w * 127 / absmax)`` stored as int8 and dequantized to the
compute dtype in the forward. Vector leaves (biases, BN gamma/beta) pass
through unquantized in the tree API; ``quantize_leaf_int8`` also offers
per-tensor scaling for direct use. Training keeps fp32 masters; this is
inference only.

The reference takes the last axis as the output channel because its
weights are HWIO / ``[in, out]``. The port's conv weights are OIHW
(output axis 0; a deconvolution's axis 1), so each weight is quantized
along its layer's own output axis (``Layer.output_axis``); its scales
keep the weight's rank (size 1 on the other axes), so they broadcast
against it. Carried across to the reference's layout, ``q`` and the
scales equal the reference's bit for bit.
"""

from __future__ import annotations

import torch

__all__ = ["quantize_leaf_int8", "quantize_params_int8",
           "dequantize_params", "int8_infer_fn", "param_bytes"]


def quantize_leaf_int8(w, axis=-1):
    """One float tensor -> (int8 q, float32 scale) with symmetric absmax
    scaling; the scale is per output channel (`axis`, the last by
    default; kept as a size-1-elsewhere tensor) for dim >= 2, per tensor
    for vectors. w == q * scale up to 1/254 of the channel's absmax."""
    w = torch.as_tensor(w)
    wf = w.float()
    if w.dim() >= 2:
        axis = axis % w.dim()
        others = tuple(d for d in range(w.dim()) if d != axis)
        absmax = wf.abs().amax(dim=others, keepdim=True)
    else:
        absmax = wf.abs().max()
    # divided by a tensor, not a Python scalar: on the card a scalar
    # divisor becomes a multiply by its reciprocal, one ulp off the
    # quotient the CPU (and the reference) computes
    scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _output_axis(layer, name, t):
    return -1 if layer is None else layer.output_axis(name, t)


def quantize_params_int8(params, layers=None):
    """Quantize every float matrix/conv tensor (dim >= 2) of a network's
    params (a list of per-layer dicts, or a dict of them by layer name)
    -> (q_params, scales) of the same structure. Each weight takes its
    layer's output axis (`layers`, parallel to `params`; None: the last
    axis, the reference's rule). Vector leaves keep their float dtype and
    get a 1.0 scale: they are a negligible slice of the weight bytes, and
    a shared scale on a small shift term (a BN beta spanning [-0.01, 3])
    would cost up to 100 % relative error on its small entries."""
    def one(layer, p):
        qp, sc = {}, {}
        for k, t in p.items():
            if t.dim() >= 2 and t.is_floating_point():
                qp[k], sc[k] = quantize_leaf_int8(
                    t.detach(), _output_axis(layer, k, t))
            else:
                qp[k], sc[k] = t.detach(), torch.ones((), device=t.device)
        return qp, sc

    if isinstance(params, dict):
        lay = layers or {}
        pairs = {n: one(lay.get(n), p) for n, p in params.items()}
        return ({n: a for n, (a, _) in pairs.items()},
                {n: b for n, (_, b) in pairs.items()})
    lay = layers or [None] * len(params)
    pairs = [one(l, p) for l, p in zip(lay, params)]
    return [a for a, _ in pairs], [b for _, b in pairs]


def dequantize_params(q_params, scales, dtype):
    """int8 params -> compute-dtype params (each int8 tensor times its
    broadcasting scale); tensors that are not int8 pass through."""
    def one(qp, sc):
        return {k: (q.float() * sc[k]).to(dtype) if q.dtype == torch.int8
                else q for k, q in qp.items()}

    if isinstance(q_params, dict):
        return {n: one(q_params[n], scales[n]) for n in q_params}
    return [one(q, s) for q, s in zip(q_params, scales)]


def int8_infer_fn(net):
    """(fn, q_params, scales) for weight-only int8 batch inference on an
    initialised network: ``fn(q_params, scales, x)`` runs the network's
    inference forward with the weights dequantized to its compute dtype
    in the call, and returns the output tensor.

    The dequantize is its own pass over every weight before the forward
    (no consumer fuses it, as the reference's jit does): a call reads the
    int8 weights, writes a compute-dtype copy and the forward reads that
    copy, so it moves more weight bytes than the plain forward, not
    fewer. int8 saves the weights' resident memory only."""
    net._require_init()
    if isinstance(net._params, dict):
        layers = {n: net._unit_layer(n) for n in net._params}
    else:
        layers = list(net.layers)
    q_params, scales = quantize_params_int8(net._params, layers)

    def infer(qp, sc, x):
        with torch.no_grad():
            return net._forward_infer(
                dequantize_params(qp, sc, net._compute_dtype), x)

    return infer, q_params, scales


def param_bytes(params):
    """Total bytes of the tensors of a network's params (list or dict of
    per-layer dicts): the weight traffic the int8 A/B cuts."""
    groups = params.values() if isinstance(params, dict) else params
    return int(sum(t.numel() * t.element_size()
                   for p in groups for t in p.values()))
