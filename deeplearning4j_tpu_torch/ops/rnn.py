"""Recurrent cells: one input-projection product, then a loop over time.

The counterpart of ``deeplearning4j_tpu/ops/rnn.py``: ``lstm_scan``
(with and without GravesLSTM's peepholes), ``simple_rnn_scan`` and
``gru_scan``. The shape of the work is the reference's: the input
projection of ALL timesteps is one ``[T*B, nIn] x [nIn, G]`` product
plus the bias, and the loop over T carries only the recurrent ``h @ U``
product and the gates' elementwise math. Autograd differentiates
through the loop. The reference runs its scans as ``lax.scan``, outside
any Pallas kernel, so no hand-written kernel stands here; the products
are ``torch.matmul`` (cuBLAS on the card).

Data is time-major ``[T, B, F]``; the layers in ``nn/conf/recurrent.py``
transpose from the API's ``[B, F, T]`` once at their boundary.

Gate order in the packed weights is the reference's ``[i, f, o, g]``
(input, forget, output, cell), not ``torch.nn.LSTM``'s ``[i, f, g, o]``.
Under bf16 the rounding sites are the reference's as XLA fuses its scan
body: the projection is rounded, then ``+ b``; each step rounds its
products (``h @ U``, and GRU's ``(r * h) @ U_n`` with ``r * h`` rounded
as the product's input) and its new carries, and the gate math between
them runs in fp32.
"""

from __future__ import annotations

import torch

__all__ = ["lstm_scan", "simple_rnn_scan", "gru_scan"]


def _project(x_tbf, w, b, width):
    """All timesteps' input projections as one product: [T, B, width]."""
    T, B, _ = x_tbf.shape
    return (x_tbf.reshape(T * B, -1) @ w + b).reshape(T, B, width)


def _zeros(x_tbf, H):
    return x_tbf.new_zeros((x_tbf.shape[1], H))


def _wide(t):
    """`t` in the gate math's dtype: fp32 for bf16/fp16, else as it is."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def lstm_scan(x_tbf, w, u, b, h0=None, c0=None, peephole=None,
              activation=torch.tanh, gate_activation=torch.sigmoid):
    """LSTM over time-major input.

    x_tbf [T, B, nIn]; w [nIn, 4H]; u [H, 4H]; b [4H]; peephole None or
    (p_i, p_f, p_o), each [H] (GravesLSTM): i and f read the old cell,
    o the new one. Returns (outputs [T, B, H], (h_T, c_T))."""
    H = u.shape[0]
    dt = x_tbf.dtype
    xw = _project(x_tbf, w, b, 4 * H)
    h = _zeros(x_tbf, H) if h0 is None else h0
    c = _zeros(x_tbf, H) if c0 is None else c0
    if peephole is not None:
        p_i, p_f, p_o = (_wide(p) for p in peephole)
    ys = []
    for xw_t in xw:
        i, f, o, g = (_wide(xw_t) + _wide(h @ u)).split(H, dim=-1)
        c_w = _wide(c)
        if peephole is not None:
            i = i + c_w * p_i
            f = f + c_w * p_f
        c_w = gate_activation(f) * c_w \
            + gate_activation(i) * activation(g)
        if peephole is not None:
            o = o + c_w * p_o
        h = (gate_activation(o) * activation(c_w)).to(dt)
        c = c_w.to(dt)
        ys.append(h)
    return torch.stack(ys), (h, c)


def simple_rnn_scan(x_tbf, w, u, b, h0=None, activation=torch.tanh):
    """Elman RNN (reference: SimpleRnn): h = act(x W + b + h U).
    Returns (outputs [T, B, H], h_T)."""
    H = u.shape[0]
    xw = _project(x_tbf, w, b, H)
    h = _zeros(x_tbf, H) if h0 is None else h0
    ys = []
    for xw_t in xw:
        h = activation(_wide(xw_t) + _wide(h @ u)).to(x_tbf.dtype)
        ys.append(h)
    return torch.stack(ys), h


def gru_scan(x_tbf, w, u, b, h0=None, activation=torch.tanh,
             gate_activation=torch.sigmoid):
    """GRU. w [nIn, 3H], u [H, 3H], b [3H], gates packed (r, z, n); the
    reset gate scales h before the candidate's product: n = act(x_n +
    (r * h) U_n). Returns (outputs [T, B, H], h_T)."""
    H = u.shape[0]
    xw = _project(x_tbf, w, b, 3 * H)
    h = _zeros(x_tbf, H) if h0 is None else h0
    u_rz, u_n = u[:, :2 * H], u[:, 2 * H:]
    ys = []
    dt = x_tbf.dtype
    for xw_t in xw:
        x_rz, x_n = _wide(xw_t[:, :2 * H]), _wide(xw_t[:, 2 * H:])
        r, z = gate_activation(x_rz + _wide(h @ u_rz)).split(H, dim=-1)
        h_w = _wide(h)
        n = activation(x_n + _wide((r * h_w).to(dt) @ u_n))
        h = ((1 - z) * n + z * h_w).to(dt)
        ys.append(h)
    return torch.stack(ys), h
