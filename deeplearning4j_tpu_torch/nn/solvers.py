"""Second-order and line-search optimization algorithms.

The counterpart of ``deeplearning4j_tpu/nn/solvers.py`` (reference:
org.deeplearning4j.nn.api.OptimizationAlgorithm and
optimize.solvers.{LineGradientDescent, ConjugateGradient, LBFGS}). SGD
stays on the per-layer updater loop; these replace it with one
whole-parameter update, since their directions (the Newton-CG inner
solve, the L-BFGS two-loop) and step sizes couple every layer through
global inner products. Parameters, gradients and directions are flat
lists of tensors (``network_step`` flattens a network's).

- ``CONJUGATE_GRADIENT`` is truncated Newton-CG (``_NewtonCG``): solve
  (H + damping I) d = -g by linear CG with Hessian-vector products from
  a double backward, then Armijo-backtrack from the Newton step. The
  linear CG is ``linalg.cg``, as the reference's routes through its
  ``linalg/solvers.py``. Unlike the reference's, the
  inner solve stops at a direction of negative curvature (the
  truncated-Newton rule): on the reference test's two-layer regression,
  whose Hessian is indefinite, the reference's step stalls near loss 1.9
  where this one converges (``tests/test_solvers.py``'s bar: loss < 5e-3
  after 40 full-batch steps, below fixed-step SGD's).
- ``LBFGS`` is optax 0.2.6's ``lbfgs`` as ``build_solver`` configures
  it: memory 10, the scaled-identity initial preconditioner, and the zoom
  line search (strong Wolfe conditions, cubic/quadratic/bisection
  interpolation, the approximate-decrease test, the safe-step fallback)
  with ``initial_guess_strategy="one"``, written out here, since optax is
  a JAX library (``torch.optim.LBFGS`` is a different algorithm).
- ``LINE_GRADIENT_DESCENT`` is the steepest-descent direction with
  optax's backtracking Armijo search (increase 1.5, at most 1.0).

The line searches decide on the host: each trial reads the loss (and
for the zoom search the slope) back, where the reference runs the search
as an XLA while_loop on its device. The L-BFGS two-loop stays on the
device. Frozen parameters enter with structurally zero gradients and
never move (``network_step`` keeps them as they were).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["OptimizationAlgorithm", "build_solver", "solver_update",
           "network_step", "cg"]


class OptimizationAlgorithm:
    STOCHASTIC_GRADIENT_DESCENT = "STOCHASTIC_GRADIENT_DESCENT"
    LINE_GRADIENT_DESCENT = "LINE_GRADIENT_DESCENT"
    CONJUGATE_GRADIENT = "CONJUGATE_GRADIENT"
    LBFGS = "LBFGS"

    _ALL = (STOCHASTIC_GRADIENT_DESCENT, LINE_GRADIENT_DESCENT,
            CONJUGATE_GRADIENT, LBFGS)

    @staticmethod
    def resolve(algo) -> str:
        name = str(algo).upper()
        if name not in OptimizationAlgorithm._ALL:
            raise ValueError(
                f"unknown OptimizationAlgorithm {algo!r}; one of "
                f"{OptimizationAlgorithm._ALL}")
        return name


# ----------------------------------------------------------------------
# flat parameter lists
# ----------------------------------------------------------------------

def _vdot(a, b):
    """Sum over the leaves of their inner products (a 0-d tensor)."""
    out = None
    for x, y in zip(a, b):
        v = torch.vdot(x.reshape(-1), y.reshape(-1))
        out = v if out is None else out + v
    return out if out is not None else torch.zeros(())


def _grad(value, leaves, create_graph=False):
    g = torch.autograd.grad(value, leaves, allow_unused=True,
                            create_graph=create_graph)
    return [torch.zeros_like(p) if gi is None else gi
            for gi, p in zip(g, leaves)]


def _value_and_grad(value_fn, params):
    ps = [p.detach().requires_grad_(True) for p in params]
    with torch.enable_grad():
        v = value_fn(ps)
        g = _grad(v, ps)
    return v.detach(), [gi.detach() for gi in g]


def _value(value_fn, params):
    with torch.no_grad():
        return value_fn(params)


def _add_scale(params, s, d):
    return [(p + s * di).to(p.dtype) for p, di in zip(params, d)]


def _f(x):
    return np.float64(float(x))


def _slot(tree, i):
    """The i-th entry along the leading axis of every array in a nested
    dict/list tree (one slot of a stacked memory)."""
    if isinstance(tree, dict):
        return {k: _slot(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_slot(v, i) for v in tree]
    return tree[i]


# ----------------------------------------------------------------------
# CONJUGATE_GRADIENT: truncated Newton-CG
# ----------------------------------------------------------------------

class _NewtonCG:
    """Per step: solve (H + damping I) d = -g with matrix-free linear CG
    (H-vector products by a double backward), stopping at negative
    curvature; fall back to -g where the truncated solve lost descent,
    then Armijo-backtrack the Newton step from alpha = 1; no step when
    sufficient decrease is never reached (reference: ``_NewtonCG``)."""

    def __init__(self, maxIterations=20, damping=1e-4):
        self.maxIterations = int(maxIterations)
        self.damping = float(damping)

    def init(self, params):
        return ()

    def from_reference(self, state, flat):
        return ()

    def update(self, grads, state, params, *, value, value_fn):
        ps = [p.detach().requires_grad_(True) for p in params]
        with torch.enable_grad():
            g_graph = _grad(value_fn(ps), ps, create_graph=True)
        live = [gi.requires_grad for gi in g_graph]
        lam = self.damping

        def hvp(v):
            outs = [gi for gi, lv in zip(g_graph, live) if lv]
            vs = [vi for vi, lv in zip(v, live) if lv]
            hv = iter(torch.autograd.grad(outs, [p for p, lv in
                                                 zip(ps, live) if lv],
                                          grad_outputs=vs,
                                          retain_graph=True,
                                          allow_unused=True)) if outs \
                else iter(())
            out = []
            for vi, p, lv in zip(v, ps, live):
                h = next(hv) if lv else None
                h = torch.zeros_like(p) if h is None else h.detach()
                out.append((h + lam * vi).to(vi.dtype))
            return out

        # lazy: nn imports this module for the OptimizationAlgorithm
        # constants, which must not pull the linalg package in
        from deeplearning4j_tpu_torch.linalg.solvers import cg

        g = [gi.detach() for gi in grads]
        d = cg(hvp, [-gi for gi in g], tol=1e-4,
               maxiter=self.maxIterations).x
        gg = _vdot(g, g)
        gd = _vdot(g, d)
        # steepest-descent restart when the truncated solve lost descent
        if not float(gd) < 0:
            d, gd = [-gi for gi in g], -gg
        f0, gd, c1 = _f(value), _f(gd), 1e-4
        base = [p.detach() for p in params]

        def phi(alpha):
            return _f(_value(value_fn, _add_scale(base, float(alpha), d)))

        with np.errstate(all="ignore"):
            alpha = np.float64(1.0)
            f, j = phi(alpha), 0
            while f > f0 + c1 * alpha * gd and j < self.maxIterations:
                alpha = alpha * 0.5
                f, j = phi(alpha), j + 1
            scale = alpha if f <= f0 + c1 * alpha * gd else 0.0
        return [float(scale) * di for di in d], state


# ----------------------------------------------------------------------
# LINE_GRADIENT_DESCENT: optax's backtracking line search
# ----------------------------------------------------------------------

class _Backtracking:
    """optax ``scale_by_backtracking_linesearch`` (slope_rtol 1e-4,
    decrease_factor 0.8, atol = rtol = 0) behind ``scale(-1)``: the
    learning rate starts from min(increase_factor x the last one,
    max_learning_rate) and shrinks until sufficient decrease."""

    def __init__(self, max_backtracking_steps, increase_factor=1.5,
                 max_learning_rate=1.0, slope_rtol=1e-4,
                 decrease_factor=0.8):
        self.max_steps = int(max_backtracking_steps)
        self.increase_factor = increase_factor
        self.max_learning_rate = max_learning_rate
        self.slope_rtol = slope_rtol
        self.decrease_factor = decrease_factor

    def init(self, params):
        return {"learning_rate": np.float64(1.0)}

    def from_reference(self, state, flat):
        """optax's ``chain(scale(-1), scale_by_backtracking_linesearch)``
        state: the carried learning rate."""
        return {"learning_rate": _f(state[1].learning_rate)}

    def update(self, grads, state, params, *, value, value_fn):
        updates = [-g for g in grads]
        slope = _f(_vdot(updates, grads))
        value = _f(value)
        with np.errstate(all="ignore"):
            lr = np.minimum(self.increase_factor * state["learning_rate"],
                            self.max_learning_rate)
            err, it = np.inf, 0
            while not (err <= 0.0) and it <= self.max_steps:
                if it > 0:
                    lr = self.decrease_factor * lr
                new_value = _f(_value(value_fn,
                                      _add_scale(params, float(lr),
                                                 updates)))
                err = new_value - value - lr * self.slope_rtol * slope
                err = np.inf if np.isnan(err) else np.maximum(err, 0.0)
                it += 1
            new_lr = np.float64(0.0) if np.isinf(err) else lr
        return ([float(new_lr) * u for u in updates],
                {"learning_rate": new_lr})


# ----------------------------------------------------------------------
# LBFGS: optax's scale_by_lbfgs + scale(-1) + the zoom line search
# ----------------------------------------------------------------------

def _cubicmin(a, fa, fpa, b, fb, c, fc):
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    r0, r1 = fb - fa - C * db, fc - fa - C * dc
    A = (dc ** 2 * r0 + -db ** 2 * r1) / denom
    B = (-dc ** 3 * r0 + db ** 3 * r1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / db ** 2
    return a - C / (2.0 * B)


class _Zoom:
    """optax ``zoom_linesearch`` (tol 0, increase_factor 2, slope_rtol
    1e-4, curv_rtol 0.9, approx_dec_rtol 1e-6, interval threshold 1e-5,
    no maximal step size), its state machine on the host."""

    def __init__(self, max_linesearch_steps, tol=0.0, increase_factor=2.0,
                 slope_rtol=1e-4, curv_rtol=0.9, approx_dec_rtol=1e-6,
                 interval_threshold=1e-5):
        self.max_steps = int(max_linesearch_steps)
        self.tol = tol
        self.increase_factor = increase_factor
        self.slope_rtol = slope_rtol
        self.curv_rtol = curv_rtol
        self.approx_dec_rtol = approx_dec_rtol
        self.interval_threshold = interval_threshold

    def _decrease_error(self, stepsize, value_step, slope_step, value_init,
                        slope_init):
        err = value_step - value_init - self.slope_rtol * stepsize \
            * slope_init
        approx = slope_step - (2 * self.slope_rtol - 1.0) * slope_init
        delta = value_step - value_init - self.approx_dec_rtol \
            * np.abs(value_init)
        err = np.minimum(np.maximum(approx, delta), err)
        err = np.maximum(err, 0.0)
        return np.inf if np.isnan(err) else err

    def _curvature_error(self, slope_step, slope_init):
        err = np.maximum(np.abs(slope_step)
                         - self.curv_rtol * np.abs(slope_init), 0.0)
        return np.inf if np.isnan(err) else err

    def search(self, value_and_grad_fn, params, updates, value, grad):
        """-> (stepsize, value, grad) at the accepted step."""
        with np.errstate(all="ignore"):
            return self._search(value_and_grad_fn, params, updates,
                                _f(value), grad)

    def _on_line(self, value_and_grad_fn, params, stepsize, updates):
        v, g = value_and_grad_fn(_add_scale(params, float(stepsize),
                                            updates))
        return _f(v), g, _f(_vdot(g, updates))

    def _search(self, vg, params, updates, value, grad):
        slope = _f(_vdot(updates, grad))
        s = dict(count=0, stepsize=np.float64(0.0), value=value, grad=grad,
                 slope=slope, decrease_error=np.inf,
                 curvature_error=np.inf, interval_found=False, done=False,
                 failed=False, low=np.float64(0.0), value_low=value,
                 slope_low=slope, high=np.float64(0.0), value_high=value,
                 slope_high=slope, cubic_ref=np.float64(0.0),
                 value_cubic_ref=value, safe_stepsize=np.float64(0.0),
                 safe_value=value, safe_grad=grad)
        value_init, slope_init, tol = value, slope, self.tol
        while not (s["done"] or s["failed"]):
            if not s["interval_found"]:
                # find an interval holding a point of the Wolfe conditions
                new = (np.float64(1.0) if s["count"] == 0
                       else self.increase_factor * s["stepsize"])
                v, g, sl = self._on_line(vg, params, new, updates)
                dec = self._decrease_error(new, v, sl, value_init,
                                           slope_init)
                curv = self._curvature_error(sl, slope_init)
                err = np.maximum(dec, curv)
                if dec <= tol:
                    s.update(safe_stepsize=new, safe_value=v, safe_grad=g)
                set_high = (dec > 0.0) or (v >= s["value"]
                                           and s["count"] > 0)
                set_low = (sl >= 0.0) and not set_high
                if set_low:
                    lo = (new, v, sl, s["stepsize"], s["value"], s["slope"])
                else:
                    lo = (s["stepsize"], s["value"], s["slope"], new, v, sl)
                found = set_high or set_low or (err <= tol)
                done = err <= tol
                s.update(low=lo[0], value_low=lo[1], slope_low=lo[2],
                         high=lo[3], value_high=lo[4], slope_high=lo[5],
                         cubic_ref=lo[0], value_cubic_ref=lo[1],
                         interval_found=found, done=done,
                         failed=(s["count"] + 1 >= self.max_steps)
                         and not done)
            else:
                low, vlow, slow = s["low"], s["value_low"], s["slope_low"]
                high, vhigh, shigh = (s["high"], s["value_high"],
                                      s["slope_high"])
                delta = np.abs(high - low)
                left, right = np.minimum(high, low), np.maximum(high, low)
                too_small = delta <= self.interval_threshold
                mc = _cubicmin(low, vlow, slow, high, vhigh, s["cubic_ref"],
                               s["value_cubic_ref"])
                use_cubic = (mc > left + 0.2 * delta) and \
                    (mc < right - 0.2 * delta)
                mq = _quadmin(low, vlow, slow, high, vhigh)
                use_quad = (not use_cubic) and (mq > left + 0.1 * delta) \
                    and (mq < right - 0.1 * delta)
                new = mc if use_cubic else (mq if use_quad
                                            else (low + high) / 2.0)
                v, g, sl = self._on_line(vg, params, new, updates)
                dec = self._decrease_error(new, v, sl, value_init,
                                           slope_init)
                curv = self._curvature_error(sl, slope_init)
                err = np.maximum(dec, curv)
                if dec <= tol and v < s["safe_value"]:
                    s.update(safe_stepsize=new, safe_value=v, safe_grad=g)
                done = err <= tol
                set_high_mid = (dec > 0.0) or (v >= vlow)
                set_high_low = (sl * (high - low) >= 0.0) and \
                    not set_high_mid
                if set_high_mid:
                    nh = (new, v, sl)
                elif set_high_low:
                    nh = (low, vlow, slow)
                else:
                    nh = (high, vhigh, shigh)
                nl = (new, v, sl) if not set_high_mid else (low, vlow, slow)
                cref = (high, vhigh) if (set_high_mid or set_high_low) \
                    else (low, vlow)
                presumably = (s["count"] + 1 >= self.max_steps) or \
                    (too_small and s["safe_stepsize"] > 0.0)
                s.update(low=nl[0], value_low=nl[1], slope_low=nl[2],
                         high=nh[0], value_high=nh[1], slope_high=nh[2],
                         cubic_ref=cref[0], value_cubic_ref=cref[1],
                         done=done, failed=presumably and not done)
            s.update(count=s["count"] + 1, stepsize=new, value=v, grad=g,
                     slope=sl, decrease_error=dec, curvature_error=curv)
            if s["failed"]:
                # fall back to the safe step, or stand still when even a
                # step leaves the domain (inf or nan)
                if s["safe_stepsize"] > 0.0 or np.isinf(dec):
                    s.update(stepsize=s["safe_stepsize"],
                             value=s["safe_value"], grad=s["safe_grad"])
        return s["stepsize"], s["value"], s["grad"]


class _LBFGS:
    """optax ``lbfgs(linesearch=scale_by_zoom_linesearch(
    max_linesearch_steps, initial_guess_strategy="one"))``, memory 10,
    ``scale_init_precond=True`` (reference: ``build_solver``)."""

    def __init__(self, max_linesearch_steps=20, memory_size=10):
        self.m = int(memory_size)
        self.zoom = _Zoom(max_linesearch_steps)

    def init(self, params):
        z = [torch.zeros_like(p) for p in params]
        dt = params[0].dtype if params else torch.float32
        return {"count": 0, "params": [t.clone() for t in z],
                "updates": [t.clone() for t in z],
                "dp": [[t.clone() for t in z] for _ in range(self.m)],
                "du": [[t.clone() for t in z] for _ in range(self.m)],
                "w": [torch.zeros((), dtype=dt, device=z[0].device
                                  if z else None) for _ in range(self.m)]}

    def from_reference(self, state, flat):
        """optax's ``lbfgs`` chain state (``ScaleByLBFGSState``, the
        scale's, the zoom search's) -> this solver's: `flat` maps a
        params-shaped reference tree to the flat tensor list; the stacked
        memories are carried slot by slot. The zoom search keeps no state
        under ``initial_guess_strategy="one"``."""
        lb = state[0]
        params = flat(lb.params)
        dt = params[0].dtype if params else torch.float64
        return {"count": int(lb.count), "params": params,
                "updates": flat(lb.updates),
                "dp": [flat(_slot(lb.diff_params_memory, i))
                       for i in range(self.m)],
                "du": [flat(_slot(lb.diff_updates_memory, i))
                       for i in range(self.m)],
                "w": [torch.tensor(float(w), dtype=dt,
                                   device=params[0].device if params
                                   else None)
                      for w in np.asarray(lb.weights_memory)]}

    def _precondition(self, updates, dp, du, rhos, scale, memory_idx):
        idx = [(memory_idx + i) % self.m for i in range(self.m)]
        vec = list(updates)
        alphas = {}
        for i in reversed(idx):
            a = rhos[i] * _vdot(dp[i], vec)
            vec = [(v - a * u).to(v.dtype) for v, u in zip(vec, du[i])]
            alphas[i] = a
        vec = [scale * v for v in vec]
        for i in idx:
            b = rhos[i] * _vdot(du[i], vec)
            vec = [(v + (alphas[i] - b) * w).to(v.dtype)
                   for v, w in zip(vec, dp[i])]
        return vec

    def update(self, grads, state, params, *, value, value_fn):
        count, m = state["count"], self.m
        memory_idx, prev = count % m, (count - 1) % m
        if count > 0:
            diff_p = [p - q for p, q in zip(params, state["params"])]
            diff_u = [g - q for g, q in zip(grads, state["updates"])]
            vd = _vdot(diff_u, diff_p)
            weight = torch.where(vd == 0.0, torch.zeros_like(vd), 1.0 / vd)
        else:
            diff_p = [torch.zeros_like(p) for p in params]
            diff_u = [torch.zeros_like(p) for p in params]
            weight = torch.zeros_like(state["w"][0])
        dp, du, w = list(state["dp"]), list(state["du"]), list(state["w"])
        dp[prev], du[prev], w[prev] = diff_p, diff_u, weight.to(w[0].dtype)
        if count > 0:
            num = _vdot(diff_u, diff_p)
            den = _vdot(diff_u, diff_u)
            scale = torch.where(den > 0.0, num / den, torch.ones_like(num))
        else:
            norm = torch.sqrt(_vdot(grads, grads))
            scale = torch.clamp(1.0 / norm, max=1.0)
        direction = self._precondition(grads, dp, du, w, scale, memory_idx)
        updates = [-d for d in direction]
        stepsize, _, _ = self.zoom.search(
            lambda ps: _value_and_grad(value_fn, ps), params, updates,
            value, grads)
        new_state = {"count": count + 1,
                     "params": [p.detach().clone() for p in params],
                     "updates": [g.detach().clone() for g in grads],
                     "dp": dp, "du": du, "w": w}
        return [float(stepsize) * u for u in updates], new_state


def build_solver(algo: str, maxIterations: int = 20):
    """The solver of a non-SGD OptimizationAlgorithm; maxIterations
    bounds the line searches (reference: BaseOptimizer.maxIterations on
    the line maximizer) and the Newton-CG inner solve."""
    algo = OptimizationAlgorithm.resolve(algo)
    if algo == OptimizationAlgorithm.CONJUGATE_GRADIENT:
        return _NewtonCG(maxIterations)
    if algo == OptimizationAlgorithm.LBFGS:
        return _LBFGS(maxIterations)
    if algo == OptimizationAlgorithm.LINE_GRADIENT_DESCENT:
        return _Backtracking(maxIterations)
    raise ValueError(f"{algo} is the per-layer updater path, not a solver")


def solver_update(solver, grads, state, params, loss, value_fn):
    """One whole-parameter solver step -> (new_params, new_state).
    value_fn(params) re-evaluates the same loss (same batch, same dropout
    key) for the line search."""
    params = [p.detach() for p in params]
    updates, state = solver.update([g.detach() for g in grads], state,
                                   params, value=loss.detach(),
                                   value_fn=value_fn)
    return [(p + u).to(p.dtype) for p, u in zip(params, updates)], state


def network_step(net, loss_fn):
    """A network's solver step (reference: the solver branch of
    ``_train_step``). ``loss_fn(params)`` takes params structured as the
    network's ``_params`` and returns (loss, new layer states). The
    parameters are updated in place; frozen layers keep theirs, and each
    layer's constraints follow. Returns (loss, new states)."""
    from deeplearning4j_tpu_torch.nn.conf.constraint import \
        apply_constraints

    keys = net._unit_keys()
    names = [(k, n) for k in keys for n in net._params[k]]
    leaves = [net._params[k][n] for k, n in names]

    def struct(plist):
        out = {k: {} for k in keys}
        for (k, n), t in zip(names, plist):
            out[k][n] = t
        return net._pack([out[k] for k in keys])

    with torch.enable_grad():
        loss, new_states = loss_fn(net._params)
        grads = _grad(loss, leaves)

    def value_fn(plist):
        return loss_fn(struct(plist))[0]

    new, net._solver_state = solver_update(
        net._solver, grads, net._solver_state, leaves, loss, value_fn)
    with torch.no_grad():
        for (k, n), t, v in zip(names, leaves, new):
            if not getattr(net._unit_layer(k), "frozen", False):
                t.copy_(v)
        for k in keys:
            if net._params[k]:
                apply_constraints(net._unit_layer(k), net._params[k])
    return loss.detach(), new_states
