"""Port parity for the recurrent cells (deeplearning4j_tpu_torch/ops/
rnn.py) against the JAX reference's scans (deeplearning4j_tpu/ops/
rnn.py): lstm_scan with and without GravesLSTM's peepholes, with given
h0/c0 and without, simple_rnn_scan and gru_scan, on the same seeded
numpy inputs.

Tolerances:
- f32 outputs and final carries: rtol 1e-5 / atol 1e-6.
- f32 gradients of a fixed random projection of the outputs and the
  final carries, with respect to every input (x, W, U, b, the peepholes,
  h0, c0), against ``jax.grad``: relative L2 1e-5 each.
- bf16: the port's distance (relative L2, over the outputs and final
  carries together) to an f64 run of the same inputs at most 1.5x the
  reference's own bf16 distance to that answer
  (held to f64, not ulp for ulp: the two frameworks' sigmoid and tanh
  differ in the last bf16 bit).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.ops import rnn as J
from deeplearning4j_tpu_torch.ops import rnn as P

torch.set_num_threads(1)

T, B, F, H = 7, 3, 5, 4
#: cell -> (gate count, peepholes)
CELLS = {"lstm": (4, False), "graves": (4, True), "simple": (1, False),
         "gru": (3, False)}


def inputs(cell, carry, seed=0):
    """Seeded numpy inputs of one scan: x, w, u, b, the peepholes (or
    None), h0 and c0 (or None)."""
    gates, peep = CELLS[cell]
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    arrs = {"x": rnd(T, B, F), "w": rnd(F, gates * H, scale=0.5),
            "u": rnd(H, gates * H, scale=0.5), "b": rnd(gates * H,
                                                        scale=0.1)}
    if peep:
        arrs.update(pi=rnd(H, scale=0.3), pf=rnd(H, scale=0.3),
                    po=rnd(H, scale=0.3))
    if carry:
        arrs["h0"] = rnd(B, H, scale=0.5)
        if cell in ("lstm", "graves"):
            arrs["c0"] = rnd(B, H, scale=0.5)
    return arrs


def run(mod, cell, a):
    """(outputs, final carries) of `mod`'s scan over the dict `a` of
    arrays of its own framework."""
    peep = (a["pi"], a["pf"], a["po"]) if "pi" in a else None
    if cell in ("lstm", "graves"):
        ys, (h, c) = mod.lstm_scan(a["x"], a["w"], a["u"], a["b"],
                                   h0=a.get("h0"), c0=a.get("c0"),
                                   peephole=peep)
        return ys, (h, c)
    fn = mod.simple_rnn_scan if cell == "simple" else mod.gru_scan
    ys, h = fn(a["x"], a["w"], a["u"], a["b"], h0=a.get("h0"))
    return ys, (h,)


def projections(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T, B, H)).astype(np.float32),
            rng.standard_normal((B, H)).astype(np.float32))


def rel_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


CASES = [(c, carry) for c in CELLS for carry in (False, True)]
IDS = [f"{c}-{'h0' if carry else 'zero'}" for c, carry in CASES]


@pytest.mark.parametrize("cell,carry", CASES, ids=IDS)
def test_scan_outputs_and_carries_match(cell, carry):
    a = inputs(cell, carry)
    jys, jc = run(J, cell, {k: jnp.asarray(v) for k, v in a.items()})
    pys, pc = run(P, cell, {k: torch.from_numpy(v) for k, v in a.items()})
    assert pys.shape == (T, B, H)
    np.testing.assert_allclose(pys.numpy(), np.asarray(jys), rtol=1e-5,
                               atol=1e-6)
    for got, want in zip(pc, jc):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cell,carry", CASES, ids=IDS)
def test_scan_gradients_match_jax_grad(cell, carry):
    a = inputs(cell, carry)
    ry, rc = projections()
    names = sorted(a)

    def jloss(*vals):
        ys, cs = run(J, cell, dict(zip(names, vals)))
        return jnp.sum(ys * ry) + sum(jnp.sum(c * rc) for c in cs)

    want = jax.grad(jloss, argnums=tuple(range(len(names))))(
        *[jnp.asarray(a[k]) for k in names])
    ts = {k: torch.from_numpy(v).requires_grad_(True) for k, v in a.items()}
    ys, cs = run(P, cell, ts)
    loss = (ys * torch.from_numpy(ry)).sum() \
        + sum((c * torch.from_numpy(rc)).sum() for c in cs)
    got = torch.autograd.grad(loss, [ts[k] for k in names])
    for k, g, w in zip(names, got, want):
        assert rel_l2(g.numpy(), w) <= 1e-5, (k, rel_l2(g.numpy(), w))


@pytest.mark.parametrize("cell", list(CELLS))
def test_scan_bf16_held_to_f64(cell):
    a = inputs(cell, carry=True, seed=2)
    exact = run(P, cell, {k: torch.from_numpy(v).double()
                          for k, v in a.items()})
    jb = run(J, cell, {k: jnp.asarray(v, jnp.bfloat16)
                       for k, v in a.items()})
    pb = run(P, cell, {k: torch.from_numpy(v).bfloat16()
                       for k, v in a.items()})
    assert all(t.dtype == torch.bfloat16 for t in [pb[0], *pb[1]])

    def flat(ts):   # outputs and final carries, as one vector
        return np.concatenate([np.asarray(t, np.float64).ravel()
                               for t in ts])

    e = flat([t.numpy() for t in [exact[0], *exact[1]]])
    d_port = rel_l2(flat([t.float().numpy() for t in [pb[0], *pb[1]]]), e)
    d_ref = rel_l2(flat([np.asarray(t, np.float32)
                         for t in [jb[0], *jb[1]]]), e)
    assert 0 < d_port <= 1.5 * d_ref, (d_port, d_ref)


def test_gate_order_is_ifog():
    """The packed weights are the reference's [i, f, o, g]: a large bias
    in the third slice opens the output gate and leaves the cell input
    at tanh(0) = 0, so h = 0; torch.nn.LSTM's [i, f, g, o] would read
    that slice as the cell input."""
    W = torch.zeros(1, 4)
    b = torch.tensor([10.0, -10.0, 10.0, 0.0])    # i, o open, f shut
    ys, (h, c) = P.lstm_scan(torch.ones(1, 1, 1), W, torch.zeros(1, 4), b)
    assert float(c) == 0.0 and float(h) == 0.0
    b = torch.tensor([10.0, -10.0, 10.0, 1.0])    # g = tanh(1)
    _, (h, c) = P.lstm_scan(torch.ones(1, 1, 1), W, torch.zeros(1, 4), b)
    assert abs(float(c) - np.tanh(1.0) * (1 / (1 + np.exp(-10)))) < 1e-6
    assert float(h) > 0.5
