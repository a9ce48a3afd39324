"""Partition-plan analyzer: static sharding/collective validation and a
per-card memory fit prediction (reference:
``deeplearning4j_tpu/analysis/partitioning.py``, whose plan model, checks
and codes this copies).

Every statically decidable partitioning mistake becomes a diagnostic in
a host-only pre-flight, in the collecting style of the shape pass. The
pass accepts ``data``, ``model`` and ``pipe`` meshes as plans, the axes
the port executes (``parallel/mesh.py``, ``sharding.shard_params``,
``pipeline.PipelineParallel``); ``report.plan["shards"]`` names the
leaves the plan shards over the model axis, the ones ``shard_params``
shards.

- PAR01  plan names a mesh axis that does not exist (or an axis twice
         in one spec, or a non-positive axis size)
- PAR02  partition spec rank exceeds the parameter's rank
- PAR03  a sharded dimension is not divisible by its mesh axis size
         (error for explicit specs; warning for default-derived specs)
- PAR04  a collective's axis or group name in a trainer path is not an
         axis of the mesh (AST pass over ``parallel/{trainer,sharding,
         spark}.py``; resolves string literals, module constants, the
         canonical ``parallel.mesh`` axis names, ``*_axis=`` defaults,
         and ``group=``/axis strings handed to ``parallel.collectives``)
- PAR05  pipeline-stage balance (``parallel.pipeline.partition_stages``)
- PAR06  predicted per-card memory high-water mark exceeds (error) or
         crowds (>90%, warning) the budget

PAR06 is a stated deviation from the reference. The reference's
residency model (``util/hbm_ledger.static_memory_terms``, copied into
the port's ``util/hbm_ledger.py``) describes XLA's fused program; the
port's step is eager, and autograd keeps every saved activation until
the backward frees it, so that model under-predicts the port by about
3x. The port predicts ITS OWN high-water mark: it builds the network on
``torch.device("meta")`` and runs the network's own train step (forward,
backward, gradient normalization, updater) on meta tensors at the
per-card batch, counting the bytes every aten op allocates and frees
(storages are tracked by their tensors' lifetimes, each rounded up to
the caching allocator's 512-byte blocks). The peak of that count, over
the resident parameters, layer state, updater state and the batch, is
the prediction for ``torch.cuda.max_memory_allocated`` of an eager fit
step; a captured step (``precompile``) adds its static input buffers and
the warm-up's snapshot of the step state. The budget gate holds the
captured total, the larger, so a batch that fits only eagerly is
refused. Nothing is allocated and no kernel runs. A step that does not
run on meta tensors is an error naming its layer when a budget is set
(the gate cannot be off unseen), a warning when none is.

Not counted: the process's one-time cuBLAS workspaces (34 MiB) and
allocator fragmentation. cuDNN's convolution workspaces are counted only
where they are large: with cuDNN's TF32 off, each f32 convolution call
holds ``F32_CONV_WORKSPACE_RATIO`` (4.25x) its input plus output bytes
while it runs, the median of what ``scripts/conv_workspace.py``
measured over every convolution of eight zoo steps on the H100 (1.41x
at most in bf16, 2.29x in f32 with TF32, 55x without, where cuDNN's
first call of a shape may hold an FFT engine's). The workspace is added
to the live count at its call only, since cuDNN frees it after the call,
so it raises the peak only where it overlaps the step's tensors (SimpleCNN
f32 b64 at 64², deterministic, TF32 off: the first convolution's
backward; prediction / measured peak 0.727 before the term). At
PyTorch's default cuDNN settings the workspaces that overlap the step's
peak stay small (SimpleCNN 0.987; ResNet-50 and YOLO2 bf16 0.98-0.99)
and none is counted; PAR06 warns on f32 convolutions with TF32 off.
On a model or pipe axis the parameter, gradient and updater terms are
divided as the plan shards them; the step's activations are not (an
upper bound: under tensor parallelism each rank holds the whole
activations after each gather, and its column blocks beside them). The
budget defaults to
the card's ``total_memory`` when a card is visible.

Entry point:

    from deeplearning4j_tpu_torch.analysis import validate_plan
    report = validate_plan(model, mesh={"data": 4, "model": 2},
                           batchSize=32, hbm_gb=80)

`model` is anything validate_model accepts; `mesh` is an axis-name ->
size dict, a ``parallel.mesh.DataGroup`` (anything with a ``.shape``
mapping), or a "data=4,model=2" string (the CLI form).
"""

from __future__ import annotations

import ast

import numpy as np

from deeplearning4j_tpu_torch.analysis.diagnostics import ERROR, WARNING, Report

__all__ = ["validate_plan", "ShardingPlan", "normalize_mesh",
           "check_collectives", "pipeline_balance"]


# canonical mesh axes (parallel/mesh.py + linalg's row/col aliases); the
# PAR04 resolver knows them by constant name so `lax.psum(x, DATA_AXIS)`
# and `row_axis=ROW_AXIS` defaults check without imports
_CANONICAL_AXES = {"DATA_AXIS": "data", "MODEL_AXIS": "model",
                   "SEQ_AXIS": "seq", "PIPE_AXIS": "pipe",
                   "ROW_AXIS": "data", "COL_AXIS": "model"}

# skew ratio between effective pipeline-stage loads past which PAR05
# warns (the schedule runs at the slowest stage's pace)
_BALANCE_SKEW = 1.5


def normalize_mesh(mesh):
    """-> ordered {axis_name: size}. Accepts a dict, a DataGroup (or
    anything with a .shape mapping), or the CLI string form
    "data=4,model=2"."""
    if isinstance(mesh, str):
        out = {}
        for part in mesh.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(
                    f"bad mesh spec {mesh!r}: expected axis=size pairs "
                    "like 'data=4,model=2'")
            name, _, size = part.partition("=")
            out[name.strip()] = int(size)
        if not out:
            raise ValueError(f"empty mesh spec {mesh!r}")
        return out
    if hasattr(mesh, "shape") and not isinstance(mesh, dict):
        return dict(mesh.shape)  # a DataGroup: {axis: size}
    return dict(mesh)


def _mesh_tag(axes):
    return "x".join(f"{k}{v}" for k, v in axes.items())


class ShardingPlan:
    """How arrays map onto the mesh — the static twin of what
    parallel.trainer/sharding/pipeline do at runtime.

    batch_axis/model_axis/pipe_axis name the mesh axes used for data/
    tensor/pipeline parallelism; each is only APPLIED when present in
    the mesh, but naming one explicitly that the mesh lacks is a PAR01
    error (a silent no-op plan is exactly the mistake this pass exists
    to catch). param_specs maps "layerKey.paramName" (layerKey = layer
    index or graph vertex name) to an explicit PartitionSpec-like tuple
    of axis names / None; explicit specs are validated strictly.
    Everything unlisted falls back to the runtime default
    (parallel.sharding.spec_for_param over model_axis).
    """

    _UNSET = object()

    def __init__(self, batch_axis=_UNSET, model_axis=_UNSET,
                 pipe_axis=_UNSET, param_specs=None,
                 min_shard_size=2 ** 16, microbatches=None,
                 weight_update="replicated",
                 weight_update_min_shard=2 ** 16,
                 gradient_compression=None, compression_block=None,
                 encoding_capacity=None, compression_group=None):
        # axes the user wrote down themselves get strict PAR01 checking;
        # the canonical defaults adapt to whatever the mesh carries
        self.explicit_axes = set()
        if batch_axis is ShardingPlan._UNSET:
            batch_axis = "data"
        elif batch_axis is not None:
            self.explicit_axes.add(batch_axis)
        if model_axis is ShardingPlan._UNSET:
            model_axis = "model"
        elif model_axis is not None:
            self.explicit_axes.add(model_axis)
        if pipe_axis is ShardingPlan._UNSET:
            pipe_axis = "pipe"
        elif pipe_axis is not None:
            self.explicit_axes.add(pipe_axis)
        self.batch_axis = batch_axis
        self.model_axis = model_axis
        self.pipe_axis = pipe_axis
        self.param_specs = dict(param_specs or {})
        self.min_shard_size = int(min_shard_size)
        self.microbatches = microbatches
        # ZeRO cross-replica weight-update sharding (runtime twin:
        # ParallelWrapper(weight_update="sharded") /
        # parallel.sharding.ZeroShardedUpdate): "sharded" divides the
        # per-card updater-state residency by the data-parallel degree
        # for every ELIGIBLE param leaf (>= weight_update_min_shard
        # elements and divisible by dp; the rest replicate — the
        # explicit pad-or-replicate policy, reported as PAR03 info)
        if weight_update not in ("replicated", "sharded"):
            raise ValueError(
                "weight_update must be 'replicated' or 'sharded', got "
                f"{weight_update!r}")
        self.weight_update = weight_update
        self.weight_update_min_shard = int(weight_update_min_shard)
        # compressed gradient collectives (runtime twin:
        # ParallelWrapper gradient_compression=): the plan
        # bills the per-replica bytes-on-wire of the gradient reduction
        # per mode (PAR06 grad_collective row). "threshold" does not
        # compose with weight_update="sharded" — same runtime rule.
        from deeplearning4j_tpu_torch.parallel.sharding import COMPRESSION_MODES

        if gradient_compression not in COMPRESSION_MODES:
            raise ValueError(
                "gradient_compression must be one of "
                f"{COMPRESSION_MODES}, got {gradient_compression!r}")
        if gradient_compression in ("threshold", "hierarchical") \
                and weight_update == "sharded":
            raise ValueError(
                f"gradient_compression={gradient_compression!r} does "
                "not compose with weight_update='sharded' (no "
                "per-parameter reduce-scatter form); pick "
                "'int8'/'block_int8' or the replicated update — the "
                "runtime trainer enforces the same rule")
        if compression_group is not None \
                and gradient_compression != "hierarchical":
            raise ValueError(
                f"compression_group given together with "
                f"gradient_compression={gradient_compression!r}: the "
                "node-group size only applies to the 'hierarchical' "
                "2-hop exchange — the runtime trainer enforces the "
                "same rule")
        self.gradient_compression = gradient_compression
        self.compression_block = compression_block
        self.encoding_capacity = encoding_capacity
        self.compression_group = compression_group

    def spec_for(self, layer_key, pname, shape):
        """(spec tuple, explicit?) for one parameter."""
        key = f"{layer_key}.{pname}"
        if key in self.param_specs:
            return tuple(self.param_specs[key]), True
        if self.model_axis is None:
            return (), False
        from deeplearning4j_tpu_torch.parallel.sharding import spec_for_param

        spec = spec_for_param(pname, shape, model_axis=self.model_axis,
                              min_shard_size=self.min_shard_size)
        return tuple(spec), False


def _plan_from(plan):
    """Resolve the plan argument (None / kwargs dict / ShardingPlan).
    Always returns a private copy — validate_plan neutralizes roles
    whose axis the mesh lacks, and must not mutate the caller's plan."""
    import copy

    if plan is None:
        return ShardingPlan()
    if isinstance(plan, dict):
        return ShardingPlan(**plan)
    return copy.copy(plan)


# ----------------------------------------------------------------------
# PAR01/02/03 — spec validation over the model's parameters
# ----------------------------------------------------------------------

def _check_spec(report, where, spec, shape, axes, explicit):
    """Validate one PartitionSpec-like tuple against one array shape.
    Returns the per-dim shard factors (1 where unsharded) or None when
    the spec is unusable."""
    sev = ERROR if explicit else WARNING
    seen = set()
    for axis in spec:
        if axis is None:
            continue
        for a in (axis if isinstance(axis, (tuple, list)) else (axis,)):
            if a not in axes:
                report.add("PAR01", ERROR, where,
                           f"spec {spec} names mesh axis '{a}' but the "
                           f"mesh axes are {sorted(axes)}",
                           hint="fix the axis name or add the axis to "
                                "build_mesh(...)")
                return None
            if a in seen:
                report.add("PAR01", ERROR, where,
                           f"spec {spec} uses mesh axis '{a}' more than "
                           "once; an axis can shard at most one dim")
                return None
            seen.add(a)
    if len(spec) > len(shape):
        report.add("PAR02", ERROR, where,
                   f"spec {spec} has rank {len(spec)} but the array has "
                   f"rank {len(shape)} (shape {tuple(shape)})",
                   hint="a PartitionSpec may have at most one entry per "
                        "array dimension")
        return None
    factors = []
    for d, axis in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        f = 1
        if axis is not None:
            for a in (axis if isinstance(axis, (tuple, list)) else (axis,)):
                f *= axes[a]
        if f > 1 and d % f != 0:
            report.add(
                "PAR03", sev, where,
                f"dim of size {d} is sharded {f}-way over "
                f"'{axis}' but {d} % {f} != 0"
                + ("" if explicit else
                   " — the runtime will silently REPLICATE this "
                   "parameter instead (parallel.sharding.shard_params)"),
                hint="pad the layer width to a multiple of the axis "
                     "size, or replicate it explicitly")
            if explicit:
                return None
            f = 1  # mirror the runtime fallback
        factors.append(f)
    return factors


def _check_mesh(report, axes, devices=None):
    for name, size in axes.items():
        if int(size) <= 0:
            report.add("PAR01", ERROR, f"mesh axis '{name}'",
                       f"axis size must be positive, got {size}")
            return False
    if devices is not None:
        total = int(np.prod(list(axes.values())))
        if total > devices:
            report.add("PAR01", ERROR, "mesh",
                       f"mesh {axes} needs {total} devices, have "
                       f"{devices}")
            return False
    return True


# ----------------------------------------------------------------------
# updater state accounting (exact, from the layer's own updater)
# ----------------------------------------------------------------------

# state leaves per param leaf, by updater class name; anything unknown
# is measured on meta tensors through the updater's own init()
_UPDATER_SLOTS = {"NoOp": 0, "Sgd": 0, "Nesterovs": 1, "AdaGrad": 1,
                  "RmsProp": 1, "Adam": 2, "AdamW": 2, "AdaMax": 2,
                  "Nadam": 2, "AdaDelta": 2, "AMSGrad": 3}


def _updater_state_elems(updater, param_shapes):
    """Exact element count of the updater state for one layer's params
    (dict name -> shape tuple)."""
    if updater is None or not param_shapes:
        return 0
    n = int(sum(int(np.prod(s)) for s in param_shapes.values()))
    slots = _UPDATER_SLOTS.get(type(updater).__name__)
    if slots is not None:
        return slots * n
    import torch

    from deeplearning4j_tpu_torch.analysis.shapes import _leaves

    abstract = {k: torch.empty(tuple(s), device="meta")
                for k, s in param_shapes.items()}
    try:
        state = updater.init(abstract)
    except Exception:
        return n  # conservative: one slot
    return int(sum(l.numel() for l in _leaves(state)))


def _layer_updater(conf, key):
    """The updater OBJECT a layer at `key` would train with (explicit
    layer updater, else the config-level default)."""
    from deeplearning4j_tpu_torch.nn import updaters as _upd

    layer = None
    if hasattr(conf, "layers") and isinstance(key, int):
        if key < len(conf.layers):
            layer = conf.layers[key]
    elif hasattr(conf, "nodes"):
        node = conf.nodes.get(key)
        layer = getattr(node, "payload", None) if node is not None else None
    u = getattr(layer, "updater", None) if layer is not None else None
    if u is None:
        defaults = getattr(conf, "defaults", None) or {}
        u = defaults.get("updater")
    try:
        return _upd.resolve(u) if u is not None else _upd.Sgd()
    except ValueError:
        return _upd.Sgd()


# ----------------------------------------------------------------------
# PAR05 — pipeline-stage balance
# ----------------------------------------------------------------------

def layer_step_flops(param_count, out_shape, out_kind="feedforward"):
    """Forward FLOP estimate of one layer from its parameter count and
    internal output shape (the reference's ``parallel/costmodel.py``
    rule, in the port's layouts): 2 * params * batch * positions, the
    positions being 1 for FF [B, N], H*W for CNN [B, C, H, W], D*H*W for
    CNN3D [B, C, D, H, W] and T for RNN [B, F, T]."""
    if not param_count or not out_shape or len(out_shape) < 2:
        return 0
    batch = out_shape[0] or 1
    if out_kind == "recurrent":
        positions = out_shape[2] if len(out_shape) > 2 and out_shape[2] \
            else 1
    else:
        positions = 1
        for d in out_shape[2:]:
            positions *= d or 1
    return int(2 * param_count * batch * positions)


def pipeline_balance(conf, rows, n_stages, batchSize):
    """Partition a sequential config's layers into GPipe stages (the
    same partition_stages the runtime uses) and report per-stage
    parameter/FLOP loads. -> dict or raises ValueError with the
    runtime's own message when the net cannot be pipelined."""
    import torch

    from deeplearning4j_tpu_torch.parallel.pipeline import (
        partition_stages, stage_input_sizes,
    )

    by_key = {r["key"]: r for r in rows}
    layers = conf.layers
    abstract = []
    for i in range(len(layers)):
        shapes = (by_key.get(i) or {}).get("param_shapes") or {}
        abstract.append({k: torch.empty(tuple(s), device="meta")
                         for k, s in shapes.items()})
    # the inputs the reference's PipelineParallel._organize feeds
    # partition_stages, via the shared helper
    pro_i, body_i, epi_i = partition_stages(
        layers, abstract, n_stages, input_sizes=stage_input_sizes(conf))
    k = len(body_i) // n_stages

    def load(idxs):
        p = f = 0
        for i in idxs:
            row = by_key.get(i)
            if row is None:
                continue
            p += row["params"]
            f += layer_step_flops(row["params"], row.get("out_shape"),
                                  row.get("out_kind", "feedforward"))
        return p, f

    stages = [load(body_i[s * k:(s + 1) * k]) for s in range(n_stages)]
    pro = load(pro_i)
    epi = load(epi_i)
    # effective load: the first stage also runs the (replicated)
    # prologue every tick, the last also runs the epilogue+loss
    eff = [list(s) for s in stages]
    eff[0] = [eff[0][0] + pro[0], eff[0][1] + pro[1]]
    eff[-1] = [eff[-1][0] + epi[0], eff[-1][1] + epi[1]]
    flops = [f for _, f in map(tuple, eff)]
    params = [p for p, _ in map(tuple, eff)]
    skew_f = (max(flops) / max(1, min(flops))) if any(flops) else 1.0
    skew_p = (max(params) / max(1, min(params))) if any(params) else 1.0
    return {
        "n_stages": n_stages,
        "layers_per_stage": k,
        "prologue": {"layers": pro_i, "params": pro[0], "flops": pro[1]},
        "epilogue": {"layers": epi_i, "params": epi[0], "flops": epi[1]},
        "stage_params": [p for p, _ in stages],
        "stage_flops": [f for _, f in stages],
        "effective_params": params,
        "effective_flops": flops,
        "param_skew": round(skew_p, 3),
        "flop_skew": round(skew_f, 3),
    }


def _check_pipeline(report, conf, rows, axes, plan, batchSize):
    pipe = plan.pipe_axis
    if pipe is None or pipe not in axes:
        return None
    S = axes[pipe]
    where = f"pipeline over '{pipe}' ({S} stages)"
    if not hasattr(conf, "layers"):
        report.add("PAR05", WARNING, where,
                   "pipeline parallelism supports sequential "
                   "MultiLayerNetwork configs only; this graph config "
                   "would have to train under dp/tp",
                   hint="drop the pipe axis or convert the model")
        return None
    try:
        bal = pipeline_balance(conf, rows, S, batchSize)
    except ValueError as e:
        report.add("PAR05", WARNING, where, str(e),
                   hint="pipeline-parallelise repeated-block "
                        "architectures; train this net with dp/tp")
        return None
    M = plan.microbatches
    if M is not None:
        dp = axes.get(plan.batch_axis, 1) if plan.batch_axis else 1
        if batchSize % (M * dp) != 0:
            report.add("PAR03", ERROR, where,
                       f"batch {batchSize} not divisible by "
                       f"n_microbatches*dp = {M}*{dp}",
                       hint="pick a microbatch count dividing the "
                            "per-replica batch")
    skew = max(bal["param_skew"], bal["flop_skew"])
    if skew > _BALANCE_SKEW:
        report.add(
            "PAR05", WARNING, where,
            f"stage loads are skewed {skew:.2f}x (effective FLOPs "
            f"{bal['effective_flops']}, params {bal['effective_params']}"
            "): every tick runs at the slowest stage's pace",
            hint="move layers between prologue/body/epilogue or change "
                 "the stage count")
    return bal


# ----------------------------------------------------------------------
# PAR06 — per-card memory fit prediction
# ----------------------------------------------------------------------

#: the sequence length a recurrent input without a timeSeriesLength is
#: predicted at (the shape pass's too)
_T_DEFAULT = 8

#: cuDNN's workspace of an f32 convolution call with TF32 off, as a
#: multiple of the call's input plus output bytes: the median over the 58
#: f32 calls ``scripts/conv_workspace.py`` measured on the H100 under the
#: deterministic setting (the smoke's; 2.0 without it, 54.9 the largest)
F32_CONV_WORKSPACE_RATIO = 4.25


class _LiveBytes:
    """A dispatch mode counting the bytes the aten ops under it
    allocate and free: each new storage (rounded up to the caching
    allocator's 512-byte blocks) is live while any tensor over it is;
    storages in `resident` (parameters, states, the batch) are not
    counted. ``peak`` is the high-water mark of the count;
    ``f32_convolutions`` counts the f32 convolution calls (forward and
    backward), whose cuDNN workspaces are the largest with TF32 off.
    With `workspace_ratio` > 0 each such call also holds a workspace of
    that many times its input plus output bytes (a forward's input and
    output, a backward's output gradient and input) while it runs: cuDNN
    frees it after the call, so it adds to the count at that call only
    and can raise the peak there; ``tensor_peak`` is the peak without
    the workspaces."""

    def __init__(self, resident, workspace_ratio=0.0):
        self.resident = set(resident)
        self.workspace_ratio = float(workspace_ratio)
        self.live = self.peak = self.tensor_peak = self.f32_convolutions = 0
        self._refs, self._size = {}, {}

    def _release(self, sid):
        n = self._refs[sid] - 1
        self._refs[sid] = n
        if n == 0:
            self.live -= self._size.pop(sid)
            del self._refs[sid]

    def __enter__(self):
        import weakref

        import torch
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_flatten

        owner = self
        convs = (torch.ops.aten.convolution.default,
                 torch.ops.aten.convolution_backward.default)

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                f32_conv = func in convs and args[1].dtype == torch.float32
                if f32_conv:
                    owner.f32_convolutions += 1
                for t in tree_flatten(out)[0]:
                    if not isinstance(t, torch.Tensor):
                        continue
                    st = t.untyped_storage()
                    sid = st._cdata
                    if sid in owner.resident:
                        continue
                    if sid not in owner._refs:
                        n = -(-st.nbytes() // 512) * 512
                        owner._size[sid], owner._refs[sid] = n, 0
                        owner.live += n
                        owner.peak = max(owner.peak, owner.live)
                        owner.tensor_peak = max(owner.tensor_peak,
                                                owner.live)
                    owner._refs[sid] += 1
                    weakref.finalize(t, owner._release, sid)
                if f32_conv and owner.workspace_ratio:
                    io = args[0].numel() + (out.numel() if func is convs[0]
                                            else args[1].numel())
                    ws = int(owner.workspace_ratio * io * 4)
                    owner.peak = max(owner.peak, owner.live + ws)
                return out

        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def _nbytes(tensors):
    seen, n = set(), 0
    for t in tensors:
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            n += -(-st.nbytes() // 512) * 512
    return n


def _label_shape(net, B):
    """The label shape of one batch of `B` in the API layout ``fit``
    takes, for a single-output network."""
    from deeplearning4j_tpu_torch.nn.conf.graph import \
        ComputationGraphConfiguration

    conf = net.conf
    if isinstance(conf, ComputationGraphConfiguration):
        head = conf.nodes[conf.networkOutputs[0]]
        layer, it = head.payload, head.layerInputType
    else:
        layer, it = net.layers[-1], conf.layerInputTypes[-1]
    from deeplearning4j_tpu_torch.nn.multilayer import \
        shape_for_output_type

    anchors = getattr(layer, "anchors", None)
    if anchors is not None:          # Yolo2OutputLayer: [B, 4+C, gh, gw]
        A = len(anchors)
        c = 4 + it.channels // A - 5
        return (B, it.height, it.width, c) if net._api_nhwc \
            else (B, c, it.height, it.width)
    return shape_for_output_type(layer.getOutputType(it), B,
                                 api_nhwc=net._api_nhwc)


def _failing_layer(net, exc):
    """"key (Type)" of the innermost layer of `net` on `exc`'s
    traceback, or None."""
    if hasattr(net, "_layer_names"):
        layers = {id(net.conf.nodes[n].payload): n
                  for n in net._layer_names}
    else:
        layers = {id(layer): str(i) for i, layer in enumerate(net.layers)}
    found, tb = None, exc.__traceback__
    while tb is not None:
        me = tb.tb_frame.f_locals.get("self")
        if me is not None and id(me) in layers:
            found = f"{layers[id(me)]} ({type(me).__name__})"
        tb = tb.tb_next
    return found


def step_high_water(conf, batchSize):
    """The port's predicted peak device bytes of one eager fit step of a
    network built from `conf` at `batchSize`, from its own train step
    run on meta tensors (module docstring). Returns {params_bytes,
    layer_state_bytes, optimizer_state_bytes, input_bytes,
    step_peak_bytes, total_bytes, f32_convolutions,
    conv_workspace_bytes, captured_total_bytes}. With cuDNN's TF32 off
    the peak holds each f32 convolution's workspace while its call runs
    (``F32_CONV_WORKSPACE_RATIO``); ``conv_workspace_bytes`` is what the
    workspaces add to the peak."""
    import copy

    import torch

    from deeplearning4j_tpu_torch.analysis.shapes import _leaves
    from deeplearning4j_tpu_torch.nn.conf.graph import \
        ComputationGraphConfiguration
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel.inference import \
        shape_for_input_type

    meta = torch.device("meta")
    conf = copy.deepcopy(conf)
    if hasattr(conf, "build"):       # a builder: the conf it builds
        conf = conf.build()
    graph = isinstance(conf, ComputationGraphConfiguration)
    B = int(batchSize)

    def feature_shape(it):
        if it is not None and it.kind == InputType.RNN \
                and not it.dims.get("timeSeriesLength"):
            return (B, it.size, _T_DEFAULT)
        return shape_for_input_type(it, B)

    with torch.device(meta):
        net = (ComputationGraph(conf, meta) if graph
               else MultiLayerNetwork(conf, meta)).init()
        if graph:
            x = {n: torch.empty(feature_shape(conf.inputTypes.get(n)))
                 for n in conf.networkInputs}
            y = [torch.empty(_label_shape(net, B))]
            batch = list(x.values()) + y
        else:
            x = torch.empty(feature_shape(conf.inputType))
            ls = _label_shape(net, B)
            if len(x.shape) == 3 and len(ls) == 2:
                ls = ls + (x.shape[2],)     # per-step labels [B, n, T]
            y = torch.empty(ls)
            batch = [x, y]
    params = _leaves(net._params)
    states = _leaves(net._states)
    opt = _leaves(net._upd_states)
    resident = params + states + opt + batch
    ratio = F32_CONV_WORKSPACE_RATIO if torch.backends.cudnn.enabled \
        and not torch.backends.cudnn.allow_tf32 else 0.0
    try:
        with _LiveBytes([t.untyped_storage()._cdata
                         for t in resident], ratio) as live:
            net._train_step(x, y, None, None, iteration=0)
    except Exception as e:
        where = _failing_layer(net, e)
        raise RuntimeError(
            f"the train step did not run on meta tensors"
            f"{f' in layer {where}' if where else ''} "
            f"({type(e).__name__}: {e})") from e
    terms = {"params_bytes": _nbytes(params),
             "layer_state_bytes": _nbytes(states),
             "optimizer_state_bytes": _nbytes(opt),
             "input_bytes": _nbytes(batch),
             "step_peak_bytes": int(live.peak)}
    terms["total_bytes"] = sum(terms.values())
    terms["f32_convolutions"] = live.f32_convolutions
    terms["conv_workspace_bytes"] = int(live.peak - live.tensor_peak)
    # a capture (``runtime.aot``) holds static copies of its inputs, and
    # its warm-up a snapshot of the step's state (params, updater and
    # layer state) while it captures
    terms["captured_total_bytes"] = terms["total_bytes"] \
        + terms["input_bytes"] + terms["params_bytes"] \
        + terms["optimizer_state_bytes"] + terms["layer_state_bytes"]
    return terms


def _predict_hbm(report, conf, rows, axes, plan, batchSize, balance,
                 gated):
    """The port's per-card high-water mark (module docstring), after the
    plan's divisions: the step at the per-card batch on the data axis;
    parameters, gradients and updater state divided as the model and
    pipe axes shard them. A step that cannot be predicted is an error
    where a budget is `gated` (the fit gate cannot be off unseen), else
    a warning."""
    dp = axes.get(plan.batch_axis, 1) if plan.batch_axis else 1
    pp = axes.get(plan.pipe_axis, 1) if plan.pipe_axis else 1

    stage_share = {}
    if balance is not None:
        S = balance["n_stages"]
        k = balance["layers_per_stage"]
        heaviest = max(range(S),
                       key=lambda s: balance["effective_params"][s])
        pro = set(balance["prologue"]["layers"])
        epi = set(balance["epilogue"]["layers"])
        all_body = [r["key"] for r in rows
                    if r["key"] not in pro and r["key"] not in epi]
        owned = set(all_body[heaviest * k:(heaviest + 1) * k])
        for r in rows:
            stage_share[r["key"]] = 1 if (r["key"] in pro or r["key"] in epi
                                          or r["key"] in owned) else 0

    # spec validation runs over EVERY layer first — a bogus explicit
    # spec must be caught even on layers the pipeline placement below
    # excludes from this card's residency
    factors_by = {}
    for row in rows:
        for pname, shape in (row.get("param_shapes") or {}).items():
            spec, explicit = plan.spec_for(row["key"], pname, shape)
            factors = _check_spec(
                report, f"layer {row['key']} param '{pname}'", spec,
                shape, axes, explicit) if spec else [1] * len(shape)
            factors_by[(row["key"], pname)] = \
                factors if factors is not None else [1] * len(shape)

    dp_w = dp if (plan.weight_update == "sharded"
                  and plan.batch_axis is not None) else 1

    full_elems = card_elems = 0
    opt_full = opt_card = opt_tp = 0.0
    for row in rows:
        key = row["key"]
        shapes = row.get("param_shapes") or {}
        full = int(sum(int(np.prod(s)) for s in shapes.values()))
        full_elems += full
        if balance is not None and stage_share.get(key, 1) == 0:
            continue
        layer_elems = elig_elems = 0
        for pname, shape in shapes.items():
            factors = factors_by[(key, pname)]
            n = int(np.prod(shape)) if shape else 1
            layer_elems += n // max(1, int(np.prod(factors)))
            if dp_w > 1 and n >= plan.weight_update_min_shard:
                if n % dp_w == 0:
                    elig_elems += n
                else:
                    report.add(
                        "PAR03", WARNING,
                        f"layer {key} param '{pname}' (weight-update "
                        "sharding)",
                        f"{n} elements are not divisible by the "
                        f"data-parallel degree {dp_w}: a sharded update "
                        "would REPLICATE this leaf's updater state "
                        "instead of padding",
                        hint="pad the layer width so the flat size "
                             "divides dp, or accept the replicated "
                             "fallback")
        card_elems += layer_elems
        if layer_elems:
            state = _updater_state_elems(_layer_updater(conf, key), shapes)
            share = layer_elems / max(1, full)
            opt_full += state
            opt_tp += state * share
            if dp_w > 1:
                f_e = elig_elems / max(1, full)
                opt_card += state * (f_e / dp_w + (1 - f_e) * share)
            else:
                opt_card += state * share

    per_card = -(-int(batchSize) // max(1, dp))
    try:
        step = step_high_water(conf, per_card)
    except Exception as e:
        report.add("PAR06", ERROR if gated else WARNING,
                   f"hbm @ {_mesh_tag(axes)}",
                   f"the per-card high-water mark could not be predicted: "
                   f"{e}",
                   hint="the fit cannot be checked against the budget; "
                        "fix the layer's meta path, or validate without "
                        "hbm_gb and measure torch.cuda.max_memory_allocated"
                   if gated else "no budget was set, so nothing is gated")
        return None
    import torch

    if step["f32_convolutions"] and torch.backends.cudnn.enabled \
            and not torch.backends.cudnn.allow_tf32:
        report.add("PAR06", WARNING, f"hbm @ {_mesh_tag(axes)}",
                   f"{step['f32_convolutions']} f32 convolution calls run "
                   "with cuDNN's TF32 off: their workspaces are counted at "
                   f"the measured median, {F32_CONV_WORKSPACE_RATIO}x a "
                   "call's input and output bytes, but one may hold up to "
                   "55x (an FFT engine's first call), so the measured peak "
                   "can exceed the prediction",
                   hint="leave a margin under the budget, or turn "
                        "torch.backends.cudnn.allow_tf32 on")
    # parameters, their gradients and the updater state shrink by the
    # plan's tensor/pipeline division; the step's activations do not
    p_share = card_elems / max(1, full_elems)
    o_share = opt_card / opt_full if opt_full else 1.0
    params_b = int(step["params_bytes"] * p_share)
    opt_b = int(step["optimizer_state_bytes"] * o_share)
    grads_b = int(step["params_bytes"] * p_share)
    saved = (step["params_bytes"] - params_b) \
        + (step["optimizer_state_bytes"] - opt_b) \
        + (step["params_bytes"] - grads_b)
    total = max(0, step["total_bytes"] - saved)
    terms = {"params_bytes": params_b, "grads_bytes": grads_b,
             "optimizer_state_bytes": opt_b,
             "layer_state_bytes": step["layer_state_bytes"],
             "input_bytes": step["input_bytes"],
             "step_peak_bytes": step["step_peak_bytes"],
             "activations_bytes": max(
                 0, step["step_peak_bytes"] - step["params_bytes"]),
             "per_card_batch": per_card,
             "total_bytes": total,
             "captured_total_bytes": total + step["input_bytes"]
             + params_b + opt_b + step["layer_state_bytes"]}
    terms["per_card_gb"] = round(terms["total_bytes"] / 1e9, 4)
    terms["weight_update"] = plan.weight_update
    # the updater state the plan's tensor/pipeline placement would hold
    # over what the ZeRO layout holds a card (reference:
    # ``weight_update_sharding``; < 1 where tp > dp)
    terms["weight_update_sharding"] = round(opt_tp / opt_card, 6) \
        if opt_card else 1.0
    terms["mesh"] = dict(axes)
    terms["pipeline_stages"] = pp if balance is not None else 1
    terms["gradient_compression"] = plan.gradient_compression
    if dp > 1:
        from deeplearning4j_tpu_torch.parallel.sharding import \
            compressed_wire_bytes

        terms["grad_collective"] = compressed_wire_bytes(
            card_elems * 4, dp, plan.gradient_compression,
            block=plan.compression_block,
            capacity=plan.encoding_capacity,
            group_size=plan.compression_group
            if plan.gradient_compression == "hierarchical" else None)
    return terms


# ----------------------------------------------------------------------
# PAR04 — collective/axis-name consistency (AST pass)
# ----------------------------------------------------------------------

_COLLECTIVES = {
    # callee name -> positional index of the axis-name argument
    "psum": 1, "pmean": 1, "pmax": 1, "pmin": 1, "ppermute": 1,
    "all_gather": 1, "psum_scatter": 1, "pshuffle": 1, "all_to_all": 1,
    "axis_index": 0, "axis_size": 0, "pbroadcast": 1,
    # the port's choke point (parallel/collectives.py): the group is the
    # second argument; a string there names an axis
    "all_reduce": 1, "broadcast": 1, "int8_lane_sum": 1,
    "reduce_scatter": 1, "int8_lane_scatter": 1, "scatter_mean": 1,
    "quantized_psum_scatter_mean": 1,
    "quantized_psum_mean": 1, "threshold_psum_mean": 4,
    "shard_batch": 2,
}

#: keywords that carry an axis or a group
_AXIS_KEYWORDS = ("axis_name", "axis", "group", "batch_axis")


class _AxisResolver(ast.NodeVisitor):
    """Collect module-level string constants so `AX = "data"` and the
    canonical parallel.mesh names resolve to axis strings."""

    def __init__(self):
        self.consts = dict(_CANONICAL_AXES)

    def visit_Assign(self, node):
        if isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, str):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self.consts[t.id] = node.value.value
        self.generic_visit(node)

    def resolve(self, expr):
        """-> list of axis-name strings, or None when not static."""
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return [expr.value]
        if isinstance(expr, (ast.Tuple, ast.List)):
            out = []
            for e in expr.elts:
                r = self.resolve(e)
                if r is None:
                    return None
                out.extend(r)
            return out
        if isinstance(expr, ast.Name):
            v = self.consts.get(expr.id)
            return [v] if v is not None else None
        if isinstance(expr, ast.Attribute):
            v = self.consts.get(expr.attr)
            return [v] if v is not None else None
        return None


def check_collectives(source, mesh_axes, path="<string>"):
    """PAR04 over one source string: every statically resolvable axis
    name handed to a collective (lax.psum/pmean/ppermute/axis_index/…),
    written in a shard_map in_specs/out_specs P(...), or defaulted by a
    `*_axis=`/`axis_name=` parameter must be an axis of `mesh_axes`.
    Returns a Report."""
    report = Report(subject=f"collectives:{path}")
    axes = set(mesh_axes)
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        report.add("LNT00", ERROR, f"{path}:{e.lineno or 0}",
                   f"file does not parse: {e.msg}")
        return report
    resolver = _AxisResolver()
    resolver.visit(tree)

    def flag(node, axis, what):
        report.add("PAR04", ERROR, f"{path}:{node.lineno}",
                   f"{what} uses axis '{axis}' but the mesh axes are "
                   f"{sorted(axes)}",
                   hint="rename the axis or add it to build_mesh(...)")

    def callee(node):
        f = node.func
        if isinstance(f, ast.Attribute):
            return f.attr
        if isinstance(f, ast.Name):
            return f.id
        return None

    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # `batch_axis=DATA_AXIS`-style defaults declare which axis a
            # trainer path will use when invoked unconfigured. ast
            # spreads `defaults` jointly over posonlyargs+args, so both
            # lists pad together or the pairing shifts.
            a = node.args
            positional = list(a.posonlyargs) + list(a.args)
            named = positional + list(a.kwonlyargs)
            defaults = ([None] * (len(positional) - len(a.defaults))
                        + list(a.defaults) + list(a.kw_defaults))
            for arg, d in zip(named, defaults):
                if d is None or not (arg.arg == "axis_name"
                                     or arg.arg.endswith("_axis")
                                     or arg.arg == "axis"):
                    continue
                r = resolver.resolve(d)
                for ax in (r or []):
                    if ax not in axes:
                        # a default can be overridden at the call site,
                        # so this flavor warns instead of erroring
                        report.add(
                            "PAR04", WARNING, f"{path}:{d.lineno}",
                            f"default {arg.arg}={ax!r} of {node.name}() "
                            f"is not a mesh axis ({sorted(axes)}); "
                            "callers must override it",
                            hint="pass the axis explicitly or add it "
                                 "to build_mesh(...)")
            continue
        if not isinstance(node, ast.Call):
            continue
        name = callee(node)
        if name == "P" or name == "PartitionSpec":
            for arg in node.args:
                r = resolver.resolve(arg)
                for ax in (r or []):
                    if ax is not None and ax not in axes:
                        flag(node, ax, "PartitionSpec")
        elif name in _COLLECTIVES:
            pos = _COLLECTIVES[name]
            cand = None
            if len(node.args) > pos:
                cand = node.args[pos]
            for kw in node.keywords:
                if kw.arg in _AXIS_KEYWORDS:
                    cand = kw.value
            if cand is None:
                continue
            r = resolver.resolve(cand)
            for ax in (r or []):
                if ax not in axes:
                    flag(node, ax, f"collective {name}()")
    return report


#: the port's trainer-path modules whose collectives are linted; the
#: second element names the mesh axes that make the module relevant
_TRAINER_PATHS = (("trainer.py", ("data",)),
                  ("sharding.py", ("model",)),
                  ("spark.py", ("data",)))


#: memo for the trainer-path lint: the result depends only on the mesh
#: axes (CLI --zoo runs validate_plan 16x per mesh; re-parsing the same
#: three modules per model would be pure waste)
_TRAINER_LINT_CACHE = {}


def _check_trainer_paths(report, axes):
    import os

    key = frozenset(axes)
    cached = _TRAINER_LINT_CACHE.get(key)
    if cached is None:
        import deeplearning4j_tpu_torch.parallel as par

        base = os.path.dirname(os.path.abspath(par.__file__))
        cached = []
        for fname, need in _TRAINER_PATHS:
            if not any(a in axes for a in need):
                continue
            path = os.path.join(base, fname)
            try:
                with open(path, "r", encoding="utf-8") as fh:
                    src = fh.read()
            except OSError:
                continue
            cached.extend(check_collectives(src, axes,
                                            path=path).diagnostics)
        _TRAINER_LINT_CACHE[key] = cached
    report.diagnostics.extend(cached)


# ----------------------------------------------------------------------
# entry point
# ----------------------------------------------------------------------

def validate_plan(model, mesh, plan=None, batchSize=32, hbm_gb=None,
                  devices=None, check_trainers=True):
    """Static partition-plan validation. Returns a Report (raises
    nothing); report.plan carries the machine-readable balance/memory
    summaries. `hbm_gb` (GB of 1e9 bytes) defaults to the visible card's
    ``total_memory``; with no card and no budget the fit is predicted
    but not gated."""
    from deeplearning4j_tpu_torch.analysis.shapes import validate_model

    axes = normalize_mesh(mesh)
    report = validate_model(model, batchSize=batchSize)
    report.subject = f"{report.subject} @ {_mesh_tag(axes)}"
    if not _check_mesh(report, axes, devices):
        return report
    plan = _plan_from(plan)

    # explicitly requested plan axes must exist (PAR01); canonical
    # defaults simply switch off when the mesh lacks their axis (a
    # dp-only mesh is not a tensor-parallel mistake). Either way a role
    # whose axis is absent is neutralized so it cannot cascade into a
    # PAR01 per parameter below.
    for role in ("batch_axis", "model_axis", "pipe_axis"):
        axis = getattr(plan, role)
        if axis is None or axis in axes:
            continue
        if axis in plan.explicit_axes:
            report.add("PAR01", ERROR, f"plan.{role}",
                       f"plan names mesh axis '{axis}' but the mesh "
                       f"axes are {sorted(axes)}",
                       hint="fix the plan or add the axis to the mesh")
        setattr(plan, role, None)

    # batch divisibility over the data-parallel axis (PAR03 — the same
    # check parallel.sharding.shard_batch enforces at runtime)
    dp_axis = plan.batch_axis
    if dp_axis is not None and dp_axis in axes:
        dp = axes[dp_axis]
        if batchSize % dp != 0:
            report.add("PAR03", ERROR, "batch",
                       f"global batch {batchSize} is not divisible by "
                       f"mesh axis '{dp_axis}' (size {dp})",
                       hint="pick a batch size that is a multiple of "
                            "the data-parallel width")

    # resolve the underlying config for updater/pipeline lookups; the
    # rows were produced by validate_model above
    conf = model
    if hasattr(conf, "conf"):
        c = conf.conf
        conf = c() if callable(c) else c

    rows = report.layers
    balance = _check_pipeline(report, conf, rows, axes, plan, batchSize)
    if hbm_gb is None:
        import torch

        if torch.cuda.is_available():
            hbm_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    # the step runs only on a config the shape pass accepted
    memory = _predict_hbm(report, conf, rows, axes, plan, batchSize,
                          balance, hbm_gb is not None) \
        if report.ok else None

    if hbm_gb is not None and memory is not None:
        # the gate holds the captured step's high-water (``precompile``),
        # the larger of the two: a batch that fits only eagerly is refused
        budget = float(hbm_gb) * 1e9
        used = memory["captured_total_bytes"]
        detail = (f"params {memory['params_bytes'] / 1e9:.3f} GB, grads "
                  f"{memory['grads_bytes'] / 1e9:.3f} GB, optimizer "
                  f"{memory['optimizer_state_bytes'] / 1e9:.3f} GB, "
                  f"step peak {memory['step_peak_bytes'] / 1e9:.3f} GB, "
                  f"eager total {memory['total_bytes'] / 1e9:.3f} GB "
                  f"at a per-card batch of {memory['per_card_batch']}")
        if used > budget:
            report.add(
                "PAR06", ERROR, f"hbm @ {_mesh_tag(axes)}",
                f"predicted per-card high-water {used / 1e9:.3f} GB "
                f"(captured) exceeds the {float(hbm_gb):g} GB budget "
                f"({detail})",
                hint="shrink the per-card batch, add data-parallel "
                     "ranks, or set a remat checkpointPolicy")
        elif used > 0.9 * budget:
            report.add(
                "PAR06", WARNING, f"hbm @ {_mesh_tag(axes)}",
                f"predicted per-card high-water {used / 1e9:.3f} GB "
                f"(captured) is within 10% of the {float(hbm_gb):g} GB "
                f"budget ({detail})",
                hint="cuDNN workspaces and allocator fragmentation can "
                     "push a >90% fit over the edge")

    if check_trainers:
        _check_trainer_paths(report, axes)

    report.plan = {"mesh": dict(axes), "balance": balance,
                   "memory": memory,
                   "shards": _model_shards(rows, plan, axes)}
    return report


def _model_shards(rows, plan, axes):
    """{"layerKey.param": dimension} of the leaves the plan shards over its
    model axis, an indivisible one left out as the runtime replicates it
    (``parallel.sharding.shard_plan`` names the same leaves)."""
    out = {}
    m = plan.model_axis
    if m is None or int(axes.get(m, 1)) <= 1:
        return out
    for row in rows:
        for pname, shape in (row.get("param_shapes") or {}).items():
            spec, _ = plan.spec_for(row["key"], pname, shape)
            for d, (n, a) in enumerate(zip(shape, spec)):
                if a == m and n % int(axes[m]) == 0:
                    out[f"{row['key']}.{pname}"] = d
    return out
