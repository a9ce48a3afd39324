"""The parity harness the layer-catalogue tests share: one configuration
built in both packages (``conf(M)`` with M either package's ``nn``), the
reference's weights carried into the port, then the loss, every
gradient, the output and a short fit trajectory held side by side, with
feature and label masks where the case has them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import deeplearning4j_tpu.nn as J
import deeplearning4j_tpu_torch.nn as P
from deeplearning4j_tpu.data import DataSet as JDataSet
from deeplearning4j_tpu_torch.data import DataSet as PDataSet
from deeplearning4j_tpu_torch.nn.graph import \
    params_to_reference as g_to_reference
from deeplearning4j_tpu_torch.nn.multilayer import params_to_reference

torch.set_num_threads(1)


def rel(got, want):
    """Relative L2 distance (numpy or tensors)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def flat(tree):
    """A nested {name: array} tree (lists included) as {path: array}."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            out[".".join(path)] = np.asarray(node)

    walk(tree, ())
    return out


def pair(conf, graph=False):
    """(reference net, port net on the CPU) of one configuration, the
    reference's params and states carried into the port."""
    jn = (J.ComputationGraph if graph else J.MultiLayerNetwork)(
        conf(J)).init()
    pn = (P.ComputationGraph if graph else P.MultiLayerNetwork)(
        conf(P), device="cpu").init()
    pn.load_reference_params(jax.tree.map(np.asarray, jn._params),
                             jax.tree.map(np.asarray, jn._states))
    return jn, pn


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def loss_and_grads(jn, pn, x, y, fm=None, lm=None, graph=False):
    """((reference loss, gradients), (port loss, gradients in the
    reference's layouts)) of the training loss (no dropout key)."""
    if graph:
        name = jn.conf.networkInputs[0]
        jx, px = {name: _j(x)}, {name: _t(x)}
        jy, py = [_j(y)], [_t(y)]
        jfm = None if fm is None else {name: _j(fm)}
        pfm = None if fm is None else {name: _t(fm)}
        jlm = None if lm is None else [_j(lm)]
        plm = None if lm is None else [_t(lm)]
    else:
        jx, px, jy, py = _j(x), _t(x), _j(y), _t(y)
        jfm, pfm, jlm, plm = _j(fm), _t(fm), _j(lm), _t(lm)
    jl, jg = jax.value_and_grad(lambda p: jn._loss_fn(
        p, jn._states, jx, jy, None, jfm, jlm, False)[0])(jn._params)
    keys = pn._unit_keys()
    loss, _ = pn._loss_fn(pn._params, pn._states, px, py, pfm, plm)
    names = [(k, n) for k in keys for n in pn._params[k]]
    gs = torch.autograd.grad(loss, [pn._params[k][n] for k, n in names],
                             allow_unused=True)
    grads = pn._pack([{} for _ in keys])
    for (k, n), g in zip(names, gs):
        grads[k][n] = torch.zeros_like(pn._params[k][n]) if g is None \
            else g
    to_ref = (lambda g: g_to_reference(pn.conf, g)) if graph else \
        (lambda g: params_to_reference(pn.layers, g))
    return (float(jl), jax.tree.map(np.asarray, jg)), \
        (float(loss.detach()), to_ref(grads))


def check_grads(jg, pg, rtol):
    want, got = flat(jg), flat(pg)
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        if np.linalg.norm(want[k]) == 0:
            assert np.abs(got[k]).max() <= 1e-7, k
        else:
            assert rel(got[k], want[k]) <= rtol, (k, rel(got[k], want[k]))


def check_net(conf, x, y, fm=None, lm=None, steps=3, graph=False,
              loss_rtol=1e-5, grad_rtol=1e-4, out_atol=1e-5,
              traj_rtol=1e-5, traj_atol=1e-6, train=True):
    """The configuration in both packages: the loss and every gradient,
    the output, then `steps` fit steps on the DataSet with the masks
    (each step's score and the final params). Returns the two nets."""
    jn, pn = pair(conf, graph)
    (jl, jg), (pl, pg) = loss_and_grads(jn, pn, x, y, fm, lm, graph)
    assert abs(pl - jl) <= loss_rtol * max(abs(jl), 1e-12), (pl, jl)
    check_grads(jg, pg, grad_rtol)
    out_j = np.asarray((jn.outputSingle(x) if graph else jn.output(x))
                       .toNumpy())
    out_p = (pn.outputSingle(x) if graph else pn.output(x)).toNumpy()
    assert out_p.shape == out_j.shape
    np.testing.assert_allclose(out_p, out_j, rtol=0, atol=out_atol)
    if not train:
        return jn, pn
    jds, pds = JDataSet(x, y, fm, lm), PDataSet(x, y, fm, lm)
    for _ in range(steps):
        jn.fit(jds)
        pn.fit(pds)
        assert abs(pn.score() - jn.score()) <= traj_rtol * max(
            abs(jn.score()), 1e-12) + traj_atol, (pn.score(), jn.score())
    np.testing.assert_allclose(pn.params().toNumpy(),
                               np.asarray(jn.params().toNumpy()),
                               rtol=traj_rtol, atol=traj_atol)
    return jn, pn


def ref_key(step_key):
    """The reference's jax.random key for a port ``StepKey``: its first
    integer seeds the key, the rest fold in one by one, as the
    reference's keys are built (step, layer, stream, leaf or sample)."""
    ints = step_key.ints
    k = jax.random.key(ints[0])
    for i in ints[1:]:
        k = jax.random.fold_in(k, i)
    return k
