"""Port parity for the CNN path's ops (deeplearning4j_tpu_torch/ops/
{conv,pooling,norm}.py) against the JAX reference's functions, forward
and gradient, in f32 and bf16. The same seeded numpy inputs go to both:
NHWC arrays to the reference, their NCHW-logical channels_last view
(a permute, no copy) to the port; a seeded cotangent gives the
gradients (``jax.vjp`` and ``torch.autograd.grad``).

Tolerances:
- f32: outputs max abs 1e-5; each gradient rel L2 1e-5.
- bf16: outputs within 2 bf16 ulps of the reference's (the two
  frameworks round intermediate bf16 results at different places; the
  ulp of values below 1/256 of the max-abs is taken at that floor).
  Gradients rel L2 2e-2: a bf16 cotangent carries 8 bits, and the BN
  backward's bf16 tail (xhat, n*dy - dbeta - xhat*dgamma) cancels, so the
  ~0.4 % per-element rounding of each side reaches the gradient's L2
  at about 1e-2 (observed up to 5e-3 below).
- bf16 average pooling: outputs rel L2 1e-2, not 2 ulps: the reference
  sums each window in bf16 (``reduce_window`` in the operand's type, a
  rounding per add), the port in f32, so a cancelling window sum can
  differ by many ulps of its small result.
- max-pool and BN-at-its-kink gradients: exactly equal (the tie and kink
  rules are decisions, not roundings).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.ops import conv as jconv
from deeplearning4j_tpu.ops import norm as jnorm
from deeplearning4j_tpu.ops import pooling as jpool
from deeplearning4j_tpu_torch.ops import conv as tconv
from deeplearning4j_tpu_torch.ops import norm as tnorm
from deeplearning4j_tpu_torch.ops import pooling as tpool

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def to_port(a_nhwc, dtype):
    """An NHWC float32 array -> the port's [B,C,H,W] channels_last."""
    t = torch.from_numpy(np.ascontiguousarray(a_nhwc)).to(dtype)
    return t.permute(0, 3, 1, 2).requires_grad_(True) if t.dim() == 4 \
        else t.requires_grad_(True)


def from_port(t):
    t = t.detach()
    if t.dim() == 4:
        t = t.permute(0, 2, 3, 1)
    return t.float().numpy()


def rel_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def bf16_within(got, want, n):
    """Every value of `got` within n bf16 ulps of `want` (float arrays of
    bf16 values), the ulp of values below 1/256 of the max-abs taken at
    that floor."""
    w = np.asarray(want, np.float64)
    floor = max(np.abs(w).max(), 1e-30) / 256
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), floor))) - 7)
    return bool((np.abs(np.asarray(got, np.float64) - w) <= n * ulp).all())


def check_out(got, want, kind):
    want = np.asarray(want, np.float32)
    if kind == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        assert bf16_within(got, want, 2)


def check_grad(got, want, kind):
    assert rel_l2(got, want) <= (1e-5 if kind == "f32" else 2e-2), \
        rel_l2(got, want)


def vjp_ref(fn, args, dy):
    out, pull = jax.vjp(fn, *args)
    return out, pull(dy)


def ref_in(a, jdt):
    return jnp.asarray(a, jnp.float32).astype(jdt)


def port_grads(out, ins, dy):
    return torch.autograd.grad(out, ins, dy)


# ----------------------------------------------------------------------
# convolution
# ----------------------------------------------------------------------

CONV_CASES = {
    "truncate": dict(k=3, stride=1, pad=(1, 1), dil=1, mode="truncate",
                     bias=True),
    "same_s2": dict(k=3, stride=2, pad=(0, 0), dil=1, mode="same",
                    bias=True),
    "same_even_s2": dict(k=4, stride=2, pad=(0, 0), dil=1, mode="same",
                         bias=True),
    "dilation2": dict(k=3, stride=1, pad=(2, 2), dil=2, mode="truncate",
                      bias=True),
    "no_bias_s2": dict(k=1, stride=2, pad=(0, 0), dil=1, mode="truncate",
                       bias=False),
}


@pytest.mark.parametrize("kind", DTYPES)
@pytest.mark.parametrize("case", CONV_CASES)
def test_conv2d_matches(case, kind):
    c = CONV_CASES[case]
    jdt, tdt = DTYPES[kind]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 10, 5)).astype(np.float32)
    w = (rng.standard_normal((c["k"], c["k"], 5, 6)) * 0.3).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32) if c["bias"] else None
    pad_j = jconv.explicit_padding(c["mode"], c["pad"], c["k"], c["stride"],
                                   c["dil"])
    pad_t = tconv.explicit_padding(c["mode"], c["pad"], c["k"], c["stride"],
                                   c["dil"])
    args = [ref_in(x, jdt), ref_in(w, jdt)] + (
        [ref_in(b, jdt)] if c["bias"] else [])

    def jf(xx, ww, *bb):
        return jconv.conv2d(xx, ww, bb[0] if bb else None, c["stride"],
                            pad_j, c["dil"])

    out = jf(*args)
    H, W = (tconv.conv_output_size(n, c["k"], c["stride"], c["pad"][0],
                                   c["dil"], c["mode"]) for n in (9, 10))
    assert out.shape == (2, H, W, 6)
    dy = rng.standard_normal(out.shape).astype(np.float32)
    out, jg = vjp_ref(jf, args, ref_in(dy, jdt))
    tx = to_port(x, tdt)
    tw = torch.from_numpy(w).to(tdt).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    tb = None if b is None else torch.from_numpy(b).to(tdt).requires_grad_()
    y = tconv.conv2d(tx, tw, tb, c["stride"], pad_t, c["dil"])
    check_out(from_port(y), out, kind)
    ins = [tx, tw] + ([tb] if tb is not None else [])
    tg = port_grads(y, ins, to_port(dy, tdt).detach())
    check_grad(from_port(tg[0]), jg[0], kind)
    check_grad(tg[1].detach().permute(2, 3, 1, 0).float().numpy(), jg[1],
               kind)
    if tb is not None:
        check_grad(tg[2].float().numpy(), jg[2], kind)


# ----------------------------------------------------------------------
# pooling
# ----------------------------------------------------------------------

def relu_input(rng, shape):
    """ReLU of a normal draw rounded to 1/8: zeros and repeated values, so
    most windows hold tied maxima."""
    return np.maximum(np.round(rng.standard_normal(shape) * 8) / 8,
                      0).astype(np.float32)


POOL_CASES = {
    "k2s2": (2, 2, ((0, 0), (0, 0))),
    "k3s2p1": (3, 2, ((1, 1), (1, 1))),
    "k3s2_same": (3, 2, "SAME"),
    "k2s1_same": (2, 1, "SAME"),
}


@pytest.mark.parametrize("kind", DTYPES)
@pytest.mark.parametrize("case", POOL_CASES)
def test_max_pool_matches_with_ties(case, kind):
    """Output and gradient; the inputs are full of tied maxima (ReLU
    zeros, values on a 1/8 grid), and the gradient equals the
    reference's exactly: the first maximum of each window takes it."""
    k, s, pad = POOL_CASES[case]
    jdt, tdt = DTYPES[kind]
    rng = np.random.default_rng(2)
    x = relu_input(rng, (2, 11, 10, 3))
    jx = ref_in(x, jdt)
    out = jpool.max_pool2d(jx, k, s, pad)
    dy = rng.standard_normal(out.shape).astype(np.float32)
    out, (jg,) = vjp_ref(lambda a: jpool.max_pool2d(a, k, s, pad), [jx],
                         ref_in(dy, jdt))
    tx = to_port(x, tdt)
    y = tpool.max_pool2d(tx, k, s, pad)
    np.testing.assert_array_equal(from_port(y), np.asarray(out, np.float32))
    (tg,) = port_grads(y, [tx], to_port(dy, tdt).detach())
    np.testing.assert_array_equal(from_port(tg), np.asarray(jg, np.float32))


def test_max_pool_first_match_on_ties():
    """A window of four equal values gives its whole cotangent to the
    first in row-major order, in both packages."""
    x = np.ones((1, 2, 2, 1), np.float32)
    _, pull = jax.vjp(lambda a: jpool.max_pool2d(a, 2, 2, ((0, 0), (0, 0))),
                      jnp.asarray(x))
    (jg,) = pull(jnp.ones((1, 1, 1, 1), jnp.float32))
    tx = to_port(x, torch.float32)
    (tg,) = port_grads(tpool.max_pool2d(tx, 2, 2, ((0, 0), (0, 0))), [tx],
                       torch.ones(1, 1, 1, 1))
    want = np.array([1, 0, 0, 0], np.float32).reshape(1, 2, 2, 1)
    np.testing.assert_array_equal(np.asarray(jg), want)
    np.testing.assert_array_equal(from_port(tg), want)


@pytest.mark.parametrize("kind", DTYPES)
@pytest.mark.parametrize("case,include", [
    ("k3s2p1", True), ("k3s2p1", False), ("k3s2_same", True),
    ("k2s2", True)])
def test_avg_pool_matches(case, include, kind):
    k, s, pad = POOL_CASES[case]
    jdt, tdt = DTYPES[kind]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 11, 10, 3)).astype(np.float32)

    def jf(a):
        return jpool.avg_pool2d(a, k, s, pad, count_include_pad=include)

    out = jf(ref_in(x, jdt))
    dy = rng.standard_normal(out.shape).astype(np.float32)
    out, (jg,) = vjp_ref(jf, [ref_in(x, jdt)], ref_in(dy, jdt))
    tx = to_port(x, tdt)
    y = tpool.avg_pool2d(tx, k, s, pad, count_include_pad=include)
    if kind == "f32":
        check_out(from_port(y), out, kind)
    else:
        assert rel_l2(from_port(y), np.asarray(out, np.float32)) <= 1e-2
    (tg,) = port_grads(y, [tx], to_port(dy, tdt).detach())
    check_grad(from_port(tg), jg, kind)


@pytest.mark.parametrize("case", ["k2s2", "k3s2_same"])
def test_pnorm_pool_matches(case):
    k, s, pad = POOL_CASES[case]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 11, 10, 3)).astype(np.float32)
    out = jpool.pnorm_pool2d(jnp.asarray(x), k, s, pad, 3)
    y = tpool.pnorm_pool2d(to_port(x, torch.float32), k, s, pad, 3)
    np.testing.assert_allclose(from_port(y), np.asarray(out), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("ptype", ["avg", "max", "sum", "pnorm"])
def test_global_pool_matches(ptype):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 4, 5, 6)).astype(np.float32)

    def jf(a):
        return jpool.global_pool(a, ptype, (1, 2))

    out = jf(jnp.asarray(x))
    dy = rng.standard_normal(out.shape).astype(np.float32)
    out, (jg,) = vjp_ref(jf, [jnp.asarray(x)], jnp.asarray(dy))
    tx = to_port(x, torch.float32)
    y = tpool.global_pool(tx, ptype, (2, 3))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(out), rtol=0,
                               atol=1e-5)
    (tg,) = port_grads(y, [tx], torch.from_numpy(dy))
    check_grad(from_port(tg), jg, "f32")


def test_global_max_pool_splits_ties_evenly():
    """The stock global max pool shares a tied maximum's cotangent
    evenly: 1/3 to each of three tied maxima, in both packages (the
    reference's ``indices`` variant, not ported, is first-match)."""
    x = np.zeros((1, 2, 2, 1), np.float32)
    x[0, 0, 0, 0] = x[0, 0, 1, 0] = x[0, 1, 1, 0] = 2.0
    _, pull = jax.vjp(lambda a: jpool.global_pool(a, "max", (1, 2)),
                      jnp.asarray(x))
    (jg,) = pull(jnp.ones((1, 1), jnp.float32))
    tx = to_port(x, torch.float32)
    (tg,) = port_grads(tpool.global_pool(tx, "max", (2, 3)), [tx],
                       torch.ones(1, 1))
    want = np.array([1, 1, 0, 1], np.float32).reshape(1, 2, 2, 1) / 3
    np.testing.assert_allclose(np.asarray(jg), want, rtol=1e-6)
    np.testing.assert_allclose(from_port(tg), want, rtol=1e-6)


# ----------------------------------------------------------------------
# batch norm
# ----------------------------------------------------------------------

def bn_inputs(rng, shape=(4, 5, 6, 7)):
    c = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    gamma = (1 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.2 * rng.standard_normal(c)).astype(np.float32)
    rm = (0.1 * rng.standard_normal(c)).astype(np.float32)
    rv = (1 + 0.2 * rng.random(c)).astype(np.float32)
    return x, gamma, beta, rm, rv


def run_bn_pair(kind, x, gamma, beta, rm, rv, dy, act=None, residual=None,
                train=True):
    """((ref out, ref grads, ref rm, ref rv), (port ...)), the grads of
    (x, gamma, beta[, residual]) in the reference's layout."""
    jdt, tdt = DTYPES[kind]
    kw = dict(train=train, decay=0.9, eps=1e-5)
    jargs = [ref_in(x, jdt), ref_in(gamma, jdt), ref_in(beta, jdt)]
    if residual is not None:
        jargs.append(ref_in(residual, jdt))

    def jfull(xx, g, b, *res):
        if act is None:
            return jnorm.batch_norm(xx, g, b, jnp.asarray(rm),
                                    jnp.asarray(rv), **kw)
        return jnorm.batch_norm_act(
            xx, g, b, jnp.asarray(rm), jnp.asarray(rv), activation=act,
            residual=res[0] if res else None, **kw)

    _, jrm, jrv = (np.asarray(a) for a in jfull(*jargs))
    out, jg = vjp_ref(lambda *a: jfull(*a)[0], jargs, ref_in(dy, jdt))
    targs = [to_port(x, tdt), to_port(gamma, tdt), to_port(beta, tdt)]
    if residual is not None:
        targs.append(to_port(residual, tdt))
    if act is None:
        y, m, v = tnorm.batch_norm(targs[0], targs[1], targs[2],
                                   torch.from_numpy(rm), torch.from_numpy(rv),
                                   **kw)
    else:
        y, m, v = tnorm.batch_norm_act(
            targs[0], targs[1], targs[2], torch.from_numpy(rm),
            torch.from_numpy(rv), activation=act,
            residual=targs[3] if residual is not None else None, **kw)
    tg = port_grads(y, targs, to_port(dy, tdt).detach())
    return ((np.asarray(out, np.float32), [np.asarray(g, np.float32)
                                           for g in jg], jrm, jrv),
            (from_port(y), [from_port(g) for g in tg], m.numpy(), v.numpy()))


def check_bn_pair(kind, ref, port):
    check_out(port[0], ref[0], kind)
    for got, want in zip(port[1], ref[1]):
        check_grad(got, want, kind)
    for got, want in zip(port[2:], ref[2:]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", DTYPES)
def test_batch_norm_train_matches(kind):
    rng = np.random.default_rng(6)
    x, gamma, beta, rm, rv = bn_inputs(rng)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    check_bn_pair(kind, *run_bn_pair(kind, x, gamma, beta, rm, rv, dy))


@pytest.mark.parametrize("kind", DTYPES)
def test_batch_norm_eval_matches(kind):
    rng = np.random.default_rng(7)
    x, gamma, beta, rm, rv = bn_inputs(rng)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    ref, port = run_bn_pair(kind, x, gamma, beta, rm, rv, dy, train=False)
    check_bn_pair(kind, ref, port)
    np.testing.assert_array_equal(port[2], rm)   # eval: stats unchanged


def test_batch_norm_over_features_and_time():
    """[B,C] and NCW [B,C,T] inputs normalise over every axis but the
    channel axis 1 (the reference's channels-last [B,C] and [B,T,C])."""
    rng = np.random.default_rng(8)
    for shape in ((6, 5), (3, 5, 4)):
        x = rng.standard_normal(shape).astype(np.float32)
        g, b = np.ones(5, np.float32), np.zeros(5, np.float32)
        jx = x if x.ndim == 2 else np.transpose(x, (0, 2, 1))
        jy, jm, _ = jnorm.batch_norm(jnp.asarray(jx), jnp.asarray(g),
                                     jnp.asarray(b), jnp.zeros(5),
                                     jnp.ones(5), train=True)
        ty, tm, _ = tnorm.batch_norm(torch.from_numpy(x),
                                     torch.from_numpy(g),
                                     torch.from_numpy(b), torch.zeros(5),
                                     torch.ones(5), train=True)
        jy = np.asarray(jy) if x.ndim == 2 else np.transpose(
            np.asarray(jy), (0, 2, 1))
        np.testing.assert_allclose(ty.detach().numpy(), jy, atol=1e-5)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-6)


@pytest.mark.parametrize("kind", DTYPES)
@pytest.mark.parametrize("with_residual", [False, True],
                         ids=["no_residual", "residual"])
@pytest.mark.parametrize("act", jnorm.EPILOGUE_ACTIVATIONS)
def test_batch_norm_act_matches(act, with_residual, kind):
    rng = np.random.default_rng(9)
    x, gamma, beta, rm, rv = bn_inputs(rng)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    res = rng.standard_normal(x.shape).astype(np.float32) \
        if with_residual else None
    check_bn_pair(kind, *run_bn_pair(kind, x, gamma, beta, rm, rv, dy, act,
                                     res))


@pytest.mark.parametrize("act", ["relu", "leakyrelu"])
def test_batch_norm_act_kink(act):
    """x built so that BN outputs are exactly 0 (each channel of x is
    symmetric about its mean, beta 0): relu's gradient there is 0 and
    leakyrelu's 1, in both packages, so the gradients agree exactly."""
    base = np.array([-1.5, -0.5, 0.0, 0.5, 1.5], np.float32)
    x = np.stack([base * (c + 1) for c in range(3)], -1).reshape(
        1, 1, 5, 3)
    gamma, beta = np.ones(3, np.float32), np.zeros(3, np.float32)
    rm, rv = np.zeros(3, np.float32), np.ones(3, np.float32)
    dy = np.ones_like(x)
    ref, port = run_bn_pair("f32", x, gamma, beta, rm, rv, dy, act)
    assert (ref[0][0, 0, 2] == 0).all() and (port[0][0, 0, 2] == 0).all()
    np.testing.assert_allclose(port[0], ref[0], atol=1e-6)
    for got, want in zip(port[1], ref[1]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(port[1][0] != 0, ref[1][0] != 0)


def test_locked_gamma_beta_match():
    """Locked (None) gamma/beta are the constants 1/0."""
    rng = np.random.default_rng(10)
    x, _, _, rm, rv = bn_inputs(rng)
    jy, _, _ = jnorm.batch_norm_act(jnp.asarray(x), None, None,
                                    jnp.asarray(rm), jnp.asarray(rv),
                                    train=True, activation="relu")
    ty, _, _ = tnorm.batch_norm_act(to_port(x, torch.float32), None, None,
                                    torch.from_numpy(rm),
                                    torch.from_numpy(rv), train=True,
                                    activation="relu")
    np.testing.assert_allclose(from_port(ty), np.asarray(jy), atol=1e-5)


def test_bn_functions_save_what_the_reference_saves():
    """BNActTrainFn keeps x, the statistics, gamma and the OUTPUT for its
    backward, never the BN output before the activation; BNTrainFn keeps
    x, the statistics and gamma."""
    rng = np.random.default_rng(11)
    x, gamma, beta, _, _ = bn_inputs(rng)
    tx, tg, tb = (to_port(a, torch.float32) for a in (x, gamma, beta))
    out, _, _ = tnorm.BNActTrainFn.apply(tx, tg, tb, 1e-5, "relu")
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5
    assert saved[0] is tx and saved[3] is tg
    assert torch.equal(saved[4], out)
    y, _, _ = tnorm.BNTrainFn.apply(tx, tg, tb, 1e-5)
    assert len(y.grad_fn.saved_tensors) == 4
