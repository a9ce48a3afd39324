"""Pipeline parallelism: a GPipe schedule over the mesh's "pipe" axis
(reference: ``deeplearning4j_tpu/parallel/pipeline.py``).

The pure planning functions the partition-plan analyzer
(``analysis.partitioning``, PAR05) shares with the executor:
``partition_stages`` (the reference's balance rule, :91 there: the
longest run of structurally identical layers, trimmed to a multiple of
the stage count, with shape-changing layers kept out of it),
``stage_input_sizes`` and ``layer_signature``. A parameter here is
anything with a ``.shape`` (a tensor, a meta tensor).

``PipelineParallel`` (reference :133-416) executes the plan, one rank a
stage on the pipe axis, composed with a data axis. A MultiLayerNetwork's
layers split into a PROLOGUE and an EPILOGUE held whole on every rank
and S equal BODY stages, stage s on the rank at pipe coordinate s. One
step runs ``M + S - 1`` ticks over M microbatches: each tick stage 0
runs the prologue on the next microbatch, every rank applies its stage
to what it holds, the last stage adds the epilogue's loss once its
first microbatch arrives, and the boundary activations go on to the
next stage with ``collectives.ppermute_grad`` (+1, open ended). The
backward is autograd through those exchanges (each one's backward
sends the gradient back a stage), so every rank's graph has the same
exchanges in the same order: every stage computes every tick, as the
reference's scan does, and a term ``0 · sum(h)`` of the last tick's
activation keeps each exchange's backward on the path of every rank's
objective (without it a rank whose last exchange fed nothing would skip
that backward, and its neighbours would wait on it). The loss is the
mean of the microbatch means (reference ``psum(loss_acc)/M``, then
``pmean`` over data); the prologue's and epilogue's gradients are summed
over the pipe group, so every rank applies one update to them; all
gradients are averaged over the data group. Each layer's updater and
constraints then run as in ``fit`` (reference :303-330). ``sync_to_net``
gathers the stages' params and updater state so the net is whole on
every rank.

Refused with the reference's messages: stateful layers (BN running
statistics), a batch not divisible by ``n_microbatches * dp``,
``n_microbatches < 1``, a stage that changes the boundary shape, a mesh
with no pipe axis.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.parallel import collectives as _coll
from deeplearning4j_tpu_torch.parallel import mesh as _mesh

__all__ = ["PipelineParallel", "layer_signature", "partition_stages",
           "stage_input_sizes"]


def _cfg_repr(v):
    """Value-based repr for config objects: two separately-constructed
    Dropout(0.5) instances must compare equal."""
    if v is None or isinstance(v, (int, float, str, bool)):
        return v
    try:
        return (type(v).__name__,
                tuple(sorted((k, _cfg_repr(x)) for k, x in vars(v).items())))
    except TypeError:
        return type(v).__name__


def layer_signature(layer, params):
    """Stages must match on this: type, parameter shapes and the
    behavioural config (activation, dropout, updater)."""
    return (type(layer).__name__,
            str(getattr(layer, "activation", None)),
            _cfg_repr(getattr(layer, "dropOut", None)),
            _cfg_repr(getattr(layer, "updater", None)),
            tuple(sorted((k, tuple(v.shape)) for k, v in params.items())))


def stage_input_sizes(conf):
    """Per-layer boundary feature sizes for ``partition_stages``'
    `input_sizes` (index len(layers) = network output), read from the
    config's recorded layerInputTypes; None when the config carries no
    per-layer types (an unbuilt builder)."""
    def size_of(it):
        try:
            return it.size
        except Exception:
            return None

    sizes = [size_of(it)
             for it in getattr(conf, "layerInputTypes", [])] + [None]
    if len(sizes) != len(conf.layers) + 1:
        return None
    return sizes


def partition_stages(layers, params, n_stages, input_sizes=None):
    """Split a layer list into (prologue_idx, body_idx, epilogue_idx):
    body is the longest run of identical-signature layers, trimmed to a
    multiple of n_stages. With `input_sizes`, run members must also keep
    the boundary size (in == out), so a shape-changing entry layer stays
    in the prologue. Raises ValueError if no run is long enough."""
    sigs = [layer_signature(l, p) for l, p in zip(layers, params)]
    if input_sizes is not None:
        for i in range(len(sigs)):
            nxt = input_sizes[i + 1] if i + 1 < len(input_sizes) else None
            if input_sizes[i] is None or nxt is None or input_sizes[i] != nxt:
                sigs[i] = ("__boundary_changing__", i)
    best_start, best_len = 0, 0
    i = 0
    while i < len(sigs):
        j = i
        while j < len(sigs) and sigs[j] == sigs[i]:
            j += 1
        if j - i > best_len and not (isinstance(sigs[i][0], str)
                                     and sigs[i][0] == "__boundary_changing__"):
            best_start, best_len = i, j - i
        i = j
    if best_len < n_stages:
        raise ValueError(
            f"Pipeline needs >= {n_stages} structurally identical "
            f"consecutive layers; longest homogeneous run is {best_len}. "
            "Pipeline parallelism targets repeated-block architectures "
            "(transformer/MLP stacks).")
    use = (best_len // n_stages) * n_stages
    # the TRAILING `use` layers of the run form the body, so a
    # shape-changing first instance stays in the prologue
    body_start = best_start + (best_len - use)
    body_end = body_start + use
    return (list(range(0, body_start)),
            list(range(body_start, body_end)),
            list(range(body_end, len(layers))))


class PipelineParallel:
    """Pipeline(+data)-parallel trainer for a MultiLayerNetwork
    (module docstring).

    Usage, on every rank of the job:
        mesh = build_mesh({"data": 2, "pipe": 4})
        pp = PipelineParallel(net, mesh, n_microbatches=8)
        pp.fit(x, y)          # x, y: the global batch
    """

    def __init__(self, net, mesh, n_microbatches=4,
                 pipe_axis=_mesh.PIPE_AXIS, batch_axis=_mesh.DATA_AXIS):
        if pipe_axis not in mesh.shape:
            raise ValueError(f"mesh has no '{pipe_axis}' axis")
        self.net = net
        self.mesh = mesh
        self.pipe_axis = pipe_axis
        self.batch_axis = batch_axis if batch_axis in mesh.shape else None
        self.S = int(mesh.shape[pipe_axis])
        self.M = int(n_microbatches)
        if self.M < 1:
            raise ValueError("n_microbatches must be >= 1")
        self.pipe = _mesh.axis_group(mesh, pipe_axis)
        self.data = _mesh.axis_group(mesh, batch_axis)
        self._org = None  # (pro_idx, body_idx, epi_idx, k_per_stage)
        self._bshape = {}  # microbatch shape -> boundary (shape, dtype)
        self.last_step = {}

    # ------------------------------------------------------------------
    def _organize(self):
        """Partition the net's layers; refuse stateful layers."""
        n = self.net
        n._require_init()
        pro_i, body_i, epi_i = partition_stages(
            n.layers, n._params, self.S,
            input_sizes=stage_input_sizes(n.conf))
        k = len(body_i) // self.S
        # everywhere, not just the body: the pipelined step keeps no
        # forward state (BN running statistics would stay at init)
        for i in range(len(n.layers)):
            st = n._states[i]
            if st and any(kk not in ("h", "c") for kk in st):
                raise ValueError(
                    f"Layer {i} ({type(n.layers[i]).__name__}) carries "
                    "persistent state (e.g. BN running stats); "
                    "PipelineParallel supports stateless layers only — "
                    "train BN-bearing nets with dp/tp instead")
        self._org = (pro_i, body_i, epi_i, k)

    def _mine(self):
        """The layer indices this rank trains: prologue, its stage,
        epilogue."""
        pro_i, body_i, epi_i, k = self._org
        s = self.pipe.rank
        return pro_i, body_i[s * k:(s + 1) * k], epi_i

    def _run(self, idx, h, key, train=True, fold=None):
        """Layers `idx` of the net on `h` (training mode, each drawing
        from ``key.fold(fold(j, i))``)."""
        from deeplearning4j_tpu_torch.nn.multilayer import (
            forward_params, layer_trains,
        )

        n = self.net
        for j, i in enumerate(idx):
            layer = n.layers[i]
            pp = n.conf.preprocessors.get(i)
            if pp is not None:
                if hasattr(pp, "batch"):
                    pp.batch = h.shape[0]
                h = pp.preProcess(h, None)
            lt = layer_trains(layer, train)
            lk = None if key is None or not lt else key.fold(fold(j, i))
            p = forward_params(layer, n._params[i], lk, n._compute_dtype,
                               n._param_dtype)
            h, _ = layer.forward(p, n._states[i], h, lt, lk, None)
        return h

    def _prologue(self, x, kt):
        n = self.net
        return self._run(self._org[0], n._entry(x), kt,
                         fold=lambda j, i: i)

    def _stage(self, h, kt):
        return self._run(self._mine()[1], h, kt,
                         fold=lambda j, i: 1000 + j)

    def _epilogue_loss(self, h, y, kt):
        from deeplearning4j_tpu_torch.nn.multilayer import (
            forward_params, layer_trains, loss_for_head,
        )

        n = self.net
        epi_i = self._org[2]
        h = self._run(epi_i[:-1], h, kt, fold=lambda j, i: i)
        i = epi_i[-1]
        last = n.layers[i]
        lt = layer_trains(last, True)
        lk = None if kt is None or not lt else kt.fold(i)
        p = forward_params(last, n._params[i], lk, n._compute_dtype,
                           n._param_dtype)
        h = last._dropout_input(h, lt, lk)
        pre = last.preoutput(p, h)
        return loss_for_head(last, pre, y, None, n._api_nhwc, p)

    def _boundary(self, x0):
        """The boundary activation's shape and dtype, from the prologue
        and this rank's stage on one microbatch; refuses a stage that
        changes it."""
        with torch.no_grad():
            b = self._prologue(x0, None)
            out = self._stage(b, None)
        if tuple(out.shape) != tuple(b.shape):
            raise ValueError(
                f"Pipeline stages must preserve the boundary activation "
                f"shape; stage maps {tuple(b.shape)} -> "
                f"{tuple(out.shape)}")
        return tuple(b.shape), b.dtype

    # ------------------------------------------------------------------
    def fit(self, data, labels=None, epochs=None):
        """fit(x, y) | fit(DataSet) | fit(DataSetIterator[, epochs]): one
        pipelined step per (global) batch, then ``sync_to_net``."""
        from deeplearning4j_tpu_torch.data.dataset import DataSet

        n = self.net
        if self._org is None:
            self._organize()
        if labels is not None:
            self._fit_batch(DataSet(data, labels))
        elif isinstance(data, DataSet):
            self._fit_batch(data)
        else:
            for _ in range(epochs or 1):
                data.reset()
                while data.hasNext():
                    self._fit_batch(data.next())
                n._epoch += 1
        self.sync_to_net()
        return self

    def _fit_batch(self, ds):
        import time

        from deeplearning4j_tpu_torch.nn.conf.dropout import StepKey
        from deeplearning4j_tpu_torch.nn.multilayer import (
            _unwrap, update_layer,
        )
        from deeplearning4j_tpu_torch.parallel import sharding as _sh
        from deeplearning4j_tpu_torch.parallel.trainer import (
            _flat_apply, _leaves, _rebuild,
        )

        n = self.net
        x = _unwrap(ds.getFeatures(), n.device)
        y = _unwrap(ds.getLabels(), n.device)
        B = x.shape[0]
        dp = self.data.size
        S, M = self.S, self.M
        if B % (M * dp) != 0:
            raise ValueError(
                f"Batch {B} not divisible by n_microbatches*dp = "
                f"{M}*{dp}")
        mb = B // M
        x_mb = x.reshape(M, mb, *x.shape[1:])
        y_mb = y.reshape(M, mb, *y.shape[1:])
        if dp > 1:
            x_mb = _sh.shard_batch(x_mb, self.mesh, self.batch_axis, dim=1)
            y_mb = _sh.shard_batch(y_mb, self.mesh, self.batch_axis, dim=1)
        sig = tuple(x_mb.shape[1:])
        if sig not in self._bshape:
            self._bshape[sig] = self._boundary(x_mb[0])
        shape, dtype = self._bshape[sig]
        s = self.pipe.rank
        it = n._iteration
        key = StepKey(int(n.conf.seed) ^ 0x9199, it)
        if dp > 1:
            key = key.fold(self.data.rank)
        t0 = time.perf_counter()
        before = _coll.totals()
        buf = torch.zeros(shape, dtype=dtype, device=n.device)
        loss = torch.zeros((), dtype=torch.float32, device=n.device)
        h = None
        ticks = []
        for t in range(M + S - 1):
            ticks.append(time.perf_counter())
            kt = key.fold(t)
            if s == 0:
                h = self._prologue(x_mb[min(t, M - 1)], kt) + 0 * buf
            else:
                h = buf
            h = self._stage(h, kt)
            out_t = t - (S - 1)
            if s == S - 1 and out_t >= 0:
                loss = loss + self._epilogue_loss(h, y_mb[out_t], kt)
            if t < M + S - 2:
                buf = _coll.ppermute_grad(h, self.pipe, 1, cyclic=False)
        ticks.append(time.perf_counter())
        objective = loss / M + 0 * h.float().sum()
        objective.backward()

        pro_i, _, epi_i, _ = self._org
        shared = list(pro_i) + list(epi_i)     # the same on every rank
        order = shared + list(self._mine()[1])
        grads = [{k: t.grad if t.grad is not None else torch.zeros_like(t)
                  for k, t in n._params[i].items()} for i in order]
        head = grads[:len(shared)]
        grads[:len(shared)] = _rebuild(head, iter(_flat_apply(
            _leaves(head), lambda f: _coll.all_reduce(f, self.pipe))))
        if dp > 1:
            grads = _rebuild(grads, iter(_sh.mean_all(_leaves(grads),
                                                      self.data)))
        with torch.no_grad():
            for i, g in zip(order, grads):
                n._upd_states[i] = update_layer(
                    n.layers[i], n._updaters[i], g, n._upd_states[i], it,
                    n._params[i])
        for p in n._params:
            for t in p.values():
                t.grad = None
        total = _coll.all_reduce(loss.detach().reshape(1).clone(),
                                 self.pipe) / M
        if dp > 1:
            total = _sh.mean_all([total], self.data)[0]
        n._score = float(total[0])
        calls, _, wire = (a - b for a, b in zip(_coll.totals(), before))
        self.last_step = {"collectives": calls, "wire_bytes": wire,
                          "ticks": M + S - 1,
                          "tick_s": [b - a for a, b in zip(ticks, ticks[1:])],
                          "step_s": time.perf_counter() - t0}
        n._iteration += 1
        for lst in n._listeners:
            lst.iterationDone(n, n._iteration, n._epoch)

    def sync_to_net(self):
        """Every stage's params and updater state gathered into the net on
        every rank (its body layers are this rank's only while it
        trains)."""
        if self._org is None or self.S == 1:
            return
        from deeplearning4j_tpu_torch.parallel.trainer import _leaves

        n = self.net
        pro_i, body_i, epi_i, k = self._org
        s = self.pipe.rank
        mine = body_i[s * k:(s + 1) * k]
        with torch.no_grad():
            for tree_of in (lambda i: n._params[i],
                            lambda i: n._upd_states[i]):
                leaves = _leaves([tree_of(i) for i in mine])
                if not leaves:
                    continue
                rows = _coll.all_gather(
                    torch.cat([t.reshape(-1) for t in leaves]), self.pipe)
                for st in range(self.S):
                    if st == s:
                        continue
                    idx = body_i[st * k:(st + 1) * k]
                    dst = _leaves([tree_of(i) for i in idx])
                    for t, v in zip(dst, rows[st].split(
                            [t.numel() for t in dst])):
                        t.copy_(v.view(t.shape).to(t.dtype))
