"""A train step's memory traffic: the per-op ledger, the analytic floor
and the attribution of the gap (reference:
``deeplearning4j_tpu/util/hbm_ledger.py``).

The model arithmetic is the reference's, ported exactly:

* ``train_step_floor(net, x_shape)``: the least bytes one step must move,
  from the model (fp32 master params read and written, the compute-dtype
  copy, the updater's state, the gradients, the input once and four
  touches of every conv/dense/pool boundary activation);
* ``static_memory_terms(...)``: the residency at the step's high-water
  mark (params, gradients, updater state, the cast copy, the boundary
  activations, the input);
* ``boundary_activation_elems(net, x_shape)``: each boundary layer's
  output elements, from the layers' output types (the reference traces
  the forward abstractly; the types give the same shapes).

The reference's ledger reads XLA's HLO. The port has no compiled program:
its count is ``util.profiler.compiled_cost``'s, every non-view aten op's
input and output tensor bytes as one step dispatches them, here kept per
op (``record_step``) with its phase and layer scope: "forward:<layer>"
while a layer's forward runs, "loss", "backward" inside the autograd
engine, "update" for the optimizer's in-place step. Over those rows:

* ``ledger(rows)``: the total (exactly ``compiled_cost``'s) and the
  top ops;
* ``attribute_ledger(net, x_shape)``: every counted byte in exactly one
  bin, so the bins sum to the total: ``collective`` (c10d ops),
  ``weight_update`` (the update phase), ``layout_copies`` (copies,
  clones, pads, concatenations that compute nothing), ``dtype_widening``
  (the excess of float tensors wider than the compute dtype at
  activation scale: an fp32 activation in a bf16 step is half excess),
  ``grad_double_touch`` (reads of a compute-dtype activation beyond its
  first) and ``compute`` (the rest), with the floor and the total's
  ratio to it beside them;
* ``audit_activation_dtypes(net, x_shape)``: the ops whose OUTPUT is a
  float wider than the compute dtype at activation scale (more elements
  than the largest parameter): clean under the default ("compute") BN
  and loss tails, flagged under "wide".

On the card, ``residency(net, x_shape)`` sets ``torch.cuda``'s peak
beside ``static_memory_terms``. ``weight_update_bill(net)`` is the
data-parallel weight update's bill (``dp_weight_update_bytes``), sharded
under a ZeRO hook: the reduce-scatter and all-gather a sharded step
records meet it.
"""

from __future__ import annotations

import contextvars
import weakref

import numpy as np
import torch

__all__ = ["train_step_floor", "static_memory_terms",
           "boundary_activation_elems", "record_step", "ledger",
           "attribute_ledger", "audit_activation_dtypes",
           "assert_activation_dtype_clean", "format_attribution",
           "static_memory_for", "residency", "weight_update_bill"]

_BOUNDARY_LAYERS = ("ConvolutionLayer", "Convolution2D", "DenseLayer",
                    "SubsamplingLayer", "SeparableConvolution2D",
                    "DepthwiseConvolution2D", "Deconvolution2D",
                    "OutputLayer")


def _itemsize(dtype):
    return torch.empty((), dtype=dtype).element_size()


def _params_list(net):
    from deeplearning4j_tpu_torch.nn.multilayer import tree_leaves

    return [t for t in tree_leaves(net._params)
            if isinstance(t, torch.Tensor)]


def _boundary_types(net):
    """The output type of every boundary layer whose forward the
    inference pass runs, in order: a network's output head computes its
    pre-activation instead (``preoutput``), so the reference's forward
    spy never records it."""
    if hasattr(net, "layers"):
        return [l.getOutputType(it) for l, it in
                list(zip(net.layers, net.conf.layerInputTypes))[:-1]
                if type(l).__name__ in _BOUNDARY_LAYERS]
    outs = set(net.conf.networkOutputs)
    return [n.inputType for name, n in net.conf.nodes.items()
            if n.kind == "layer" and name not in outs
            and type(n.payload).__name__ in _BOUNDARY_LAYERS]


def _input_shapes(net, x_shape):
    """`x_shape` as {input: shape} for a ComputationGraph (a dict for a
    multi-input graph), the tuple for a MultiLayerNetwork (reference:
    ``_input_shapes``)."""
    if hasattr(net, "layers"):
        if isinstance(x_shape, dict):
            raise ValueError(
                "MultiLayerNetwork takes one input shape tuple, not a dict")
        return tuple(x_shape)
    names = list(net.conf.networkInputs)
    if isinstance(x_shape, dict):
        missing = [n for n in names if n not in x_shape]
        if missing:
            raise ValueError(
                f"x_shape dict is missing graph input(s) {missing} "
                f"(graph inputs: {names})")
        return {n: tuple(x_shape[n]) for n in names}
    if len(names) == 1:
        return {names[0]: tuple(x_shape)}
    raise ValueError(
        f"graph has {len(names)} inputs ({names}); pass x_shape as a "
        "dict of input shapes, e.g. {name: (B, ...), ...}")


def _type_elems(t):
    """Elements of one example of an InputType."""
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType as IT

    if t.kind == IT.FF:
        return int(t.size)
    if t.kind == IT.RNN:
        return int(t.size) * int(t.dims.get("timeSeriesLength") or 1)
    if t.kind in (IT.CNN, IT.CNN_FLAT):
        return int(t.height) * int(t.width) * int(t.channels)
    if t.kind == IT.CNN3D:
        return (int(t.depth) * int(t.height) * int(t.width)
                * int(t.channels))
    raise ValueError(f"unsupported output type {t!r}")


def boundary_activation_elems(net, x_shape):
    """Each conv/dense/pool boundary layer's output elements for a batch
    of `x_shape` (reference: ``boundary_activation_elems``)."""
    shapes = _input_shapes(net, x_shape)
    B = (shapes[0] if isinstance(shapes, tuple)
         else next(iter(shapes.values()))[0])
    return [int(B) * _type_elems(t) for t in _boundary_types(net)]


def train_step_floor(net, x_shape, optimizer_slots=1):
    """The analytic least bytes of one train step (reference:
    ``train_step_floor``; module docstring)."""
    cb = _itemsize(net._compute_dtype)
    pb = _itemsize(net._param_dtype)
    P = int(sum(t.numel() for t in _params_list(net)))
    A = int(sum(boundary_activation_elems(net, x_shape)))
    shapes = _input_shapes(net, x_shape)
    if isinstance(shapes, dict):
        Bx = int(sum(np.prod(s) for s in shapes.values()))
    else:
        Bx = int(np.prod(shapes))
    copy_bytes = 3 * P * cb if cb != pb else 2 * P * pb
    terms = {
        "params_master_rw": 2 * P * pb,
        "params_compute_copy": copy_bytes,
        "optimizer_state_rw": 2 * optimizer_slots * P * pb,
        "grads_wr": 2 * P * pb,
        "input_read": Bx * cb,
        "activations_4touch": 4 * A * cb,
    }
    return {"floor_bytes": int(sum(terms.values())), "terms": terms,
            "param_count": P, "boundary_activation_elems": A}


def static_memory_terms(param_elems, opt_state_elems, boundary_act_bytes,
                        compute_itemsize, param_itemsize, input_bytes=0,
                        grad_itemsize=None, weight_update_sharding=1.0):
    """Residency at the train step's high-water mark from per-card
    element counts (reference: ``static_memory_terms``)."""
    gb = param_itemsize if grad_itemsize is None else grad_itemsize
    wf = float(weight_update_sharding)
    if wf <= 0.0:
        raise ValueError(
            f"weight_update_sharding must be > 0, got {wf}")
    terms = {
        "params_bytes": int(param_elems * param_itemsize),
        "grads_bytes": int(param_elems * gb),
        "optimizer_state_bytes": int(opt_state_elems * param_itemsize
                                     / wf),
        "params_cast_copy_bytes": (int(param_elems * compute_itemsize)
                                   if compute_itemsize != param_itemsize
                                   else 0),
        "activations_bytes": int(boundary_act_bytes),
        "input_bytes": int(input_bytes),
    }
    terms["total_bytes"] = int(sum(terms.values()))
    terms["weight_update_sharding"] = round(wf, 4)
    return terms


def static_memory_for(net, x_shape):
    """``static_memory_terms`` of `net` at a batch of `x_shape`: the
    updater state's exact element count, the boundary activations at
    the compute dtype, the input at fp32 (as ``fit`` receives it)."""
    from deeplearning4j_tpu_torch.nn.multilayer import tree_leaves

    cb = _itemsize(net._compute_dtype)
    shapes = _input_shapes(net, x_shape)
    Bx = int(sum(np.prod(s) for s in shapes.values())) \
        if isinstance(shapes, dict) else int(np.prod(shapes))
    opt = sum(t.numel() for t in tree_leaves(net._upd_states)
              if isinstance(t, torch.Tensor))
    return static_memory_terms(
        sum(t.numel() for t in _params_list(net)), opt,
        sum(boundary_activation_elems(net, x_shape)) * cb, cb,
        _itemsize(net._param_dtype), input_bytes=Bx * 4)


def weight_update_bill(net, dp=None, sharded=None, compression=None):
    """``parallel.sharding.dp_weight_update_bytes`` of `net`: G and M its
    trainable params' bytes, S its updater state's in the canonical
    layout (sized on meta tensors, so a ZeRO layout bills what the whole
    state holds). `dp` and `sharded` default to the installed ZeRO
    hook's (``_update_impl``), else 1 and replicated. Under
    ``weight_update="sharded"`` ``reduce_scatter_bytes`` plus
    ``all_gather_bytes`` (``collective_wire_bytes``) is the bill the
    step's recorded reduce-scatter and all-gather meet
    (``parallel.collectives``)."""
    from deeplearning4j_tpu_torch.nn.multilayer import tree_leaves
    from deeplearning4j_tpu_torch.parallel.sharding import \
        dp_weight_update_bytes

    z = getattr(net, "_update_impl", None)
    dp = (z.dp if z is not None else 1) if dp is None else int(dp)
    sharded = z is not None if sharded is None else bool(sharded)
    G = S = 0
    for k in net._unit_keys():
        params = net._params[k]
        if not params or getattr(net._unit_layer(k), "frozen", False):
            continue
        G += sum(t.numel() * t.element_size() for t in params.values())
        with torch.device("meta"):
            st = net._updaters[k].init({n: torch.empty_like(t,
                                                           device="meta")
                                        for n, t in params.items()})
        S += sum(t.numel() * t.element_size() for t in tree_leaves(st)
                 if isinstance(t, torch.Tensor))
    return dp_weight_update_bytes(G, dp, master_bytes=G, opt_state_bytes=S,
                                  sharded=sharded, compression=compression)


# ----------------------------------------------------------------------
# the per-op count of one step
# ----------------------------------------------------------------------

_SCOPE = contextvars.ContextVar("hbm_scope", default="step")

#: ops that move bytes without computing anything the floor recognises
_LAYOUT_OPS = {"copy_", "clone", "_to_copy", "cat", "constant_pad_nd",
               "repeat", "repeat_interleave", "expand_copy",
               "permute_copy", "contiguous", "stack", "slice_scatter",
               "index_select", "new_zeros", "zeros_like", "fill_",
               "zero_"}


def _op_name(func):
    return func.__name__.split(".")[0]


def _phase():
    if torch._C._current_graph_task_id() != -1:
        return "backward"
    return "forward" if torch.is_grad_enabled() else "update"


def _tmeta(t):
    return (t.dtype, t.numel())


def record_step(net, x_shape, seed=0):
    """Run ONE train step of `net` on a random batch of `x_shape` under a
    dispatch mode and return its rows, one a non-view aten op: {"scope",
    "phase", "op", "ns", "bytes", "out_bytes", "in_bytes", "out" [(dtype,
    numel)], "reads" [(dtype, numel, bytes, again)]}, `again` true when
    that very tensor was read before in the step (its identity is held
    by a weak reference, so the count keeps nothing alive). The
    network's state is put back afterwards."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    from deeplearning4j_tpu_torch.runtime.autotune import _step_args

    rows = []
    seen = {}

    def read(t):
        ref = seen.get(id(t))
        again = ref is not None and ref() is t
        if not again:
            seen[id(t)] = weakref.ref(t)
        return (t.dtype, t.numel(), t.numel() * t.element_size(), again)

    class _Rec(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), kw=None):
            out = func(*a, **(kw or {}))
            if func.is_view:
                return out
            ins, _ = tree_flatten((a, kw))
            outs, _ = tree_flatten(out)
            ins = [t for t in ins if isinstance(t, torch.Tensor)]
            outs = [t for t in outs if isinstance(t, torch.Tensor)]
            ib = sum(t.numel() * t.element_size() for t in ins)
            ob = sum(t.numel() * t.element_size() for t in outs)
            phase = _phase()
            rows.append({
                "scope": _SCOPE.get() if phase == "forward" else phase,
                "phase": phase, "op": _op_name(func),
                "ns": func.namespace, "bytes": ib + ob, "in_bytes": ib,
                "out_bytes": ob, "out": [_tmeta(t) for t in outs],
                "reads": [read(t) for t in ins]})
            return out

    args = _step_args(net, x_shape, seed)
    wrapped = []
    for name, layer in _named_layers(net):
        for meth in ("forward", "preoutput"):
            orig = getattr(layer, meth, None)
            if orig is None:
                continue

            def spy(*a, _orig=orig, _name=name, **k):
                token = _SCOPE.set(f"forward:{_name}")
                try:
                    return _orig(*a, **k)
                finally:
                    _SCOPE.reset(token)

            setattr(layer, meth, spy)
            wrapped.append((layer, meth))
    snap = net._snapshot()
    token = _SCOPE.set("loss")
    try:
        with _Rec():
            net._train_step(*args, iteration=0)
    finally:
        _SCOPE.reset(token)
        for layer, meth in wrapped:
            layer.__dict__.pop(meth, None)
        net._restore(snap)
    return rows


def _named_layers(net):
    if hasattr(net, "layers"):
        return [(f"{i}:{type(l).__name__}", l)
                for i, l in enumerate(net.layers)]
    return [(n, node.payload) for n, node in net.conf.nodes.items()
            if getattr(node, "payload", None) is not None]


def ledger(rows, top=15):
    """{"total_bytes", "by_opcode", "by_scope", "top"} over a step's rows
    (``record_step``); the total is ``compiled_cost``'s
    ``bytes_accessed`` for the same step."""
    by_op, by_scope = {}, {}
    for r in rows:
        by_op[r["op"]] = by_op.get(r["op"], 0) + r["bytes"]
        by_scope[r["scope"]] = by_scope.get(r["scope"], 0) + r["bytes"]
    ranked = sorted(rows, key=lambda r: -r["bytes"])[:top]
    return {"total_bytes": int(sum(r["bytes"] for r in rows)),
            "by_opcode": dict(sorted(by_op.items(), key=lambda kv: -kv[1])),
            "by_scope": dict(sorted(by_scope.items(),
                                    key=lambda kv: -kv[1])),
            "top": [{"scope": r["scope"], "op": r["op"],
                     "bytes": r["bytes"], "out_bytes": r["out_bytes"],
                     "in_bytes": r["in_bytes"]} for r in ranked]}


def _threshold(net):
    return max((t.numel() for t in _params_list(net)), default=0)


def _wide_excess(meta, nbytes, cbits):
    dt, _ = meta
    if not dt.is_floating_point:
        return 0
    bits = _itemsize(dt) * 8
    if bits <= cbits:
        return 0
    return int(round(nbytes * (1.0 - cbits / bits)))


def attribute_ledger(net, x_shape, optimizer_slots=1, compute_dtype=None,
                     act_threshold_elems=None, top=6, rows=None):
    """Every counted byte of one step in exactly one bin (module
    docstring): ``sum(bins) == ledger_total_bytes``. With the floor, the
    gap and the total's ratio to the floor."""
    if rows is None:
        rows = record_step(net, x_shape)
    cdt = net._compute_dtype if compute_dtype is None else compute_dtype
    cbits = _itemsize(cdt) * 8
    thr = _threshold(net) if act_threshold_elems is None \
        else int(act_threshold_elems)
    floor = train_step_floor(net, x_shape, optimizer_slots)
    bins = {"collective": 0, "weight_update": 0, "layout_copies": 0,
            "dtype_widening": 0, "grad_double_touch": 0, "compute": 0}
    contrib = {k: [] for k in bins}
    for r in rows:
        n = r["bytes"]
        if r["ns"] == "c10d" or r["op"].startswith(("all_reduce",
                                                    "allreduce")):
            kind = "collective"
        elif r["phase"] == "update":
            kind = "weight_update"
        elif r["op"] in _LAYOUT_OPS and not (
                r["op"] in ("_to_copy", "copy_")
                and len({m[0] for m in r["out"]}
                        | {m[0] for m in r["reads"]}) > 1):
            kind = "layout_copies"
        else:
            kind = None
        if kind is not None:
            bins[kind] += n
            contrib[kind].append((r["scope"], r["op"], n))
            continue
        wid = sum(_wide_excess(m, m[1] * _itemsize(m[0]), cbits)
                  for m in r["out"] if m[1] > thr)
        twice = 0
        for dt, numel, b, again in r["reads"]:
            if numel > thr:
                wid += _wide_excess((dt, numel), b, cbits)
                if again and dt.is_floating_point \
                        and _itemsize(dt) * 8 <= cbits:
                    twice += b
        wid = min(wid, n)
        twice = min(twice, n - wid)
        bins["dtype_widening"] += wid
        bins["grad_double_touch"] += twice
        bins["compute"] += n - wid - twice
        for key, v in (("dtype_widening", wid), ("grad_double_touch", twice),
                       ("compute", n - wid - twice)):
            if v:
                contrib[key].append((r["scope"], r["op"], v))
    total = int(sum(r["bytes"] for r in rows))
    rec = {
        "ledger_total_bytes": total,
        "floor_bytes": int(floor["floor_bytes"]),
        "floor_terms": dict(floor["terms"]),
        "bins": {k: int(v) for k, v in bins.items()},
        "bin_top": {k: [{"scope": s, "op": o, "bytes": int(b)}
                        for s, o, b in sorted(v, key=lambda x: -x[2])[:top]]
                    for k, v in contrib.items()},
        "gap_bytes": total - int(floor["floor_bytes"]),
        "ratio_to_floor": (total / floor["floor_bytes"]
                           if floor["floor_bytes"] else None),
        "compute_dtype": str(cdt).replace("torch.", ""),
        "act_threshold_elems": thr,
    }
    from deeplearning4j_tpu_torch.runtime import telemetry

    g = telemetry.get_registry().gauge(
        "dl4j_hbm_attributed_bytes",
        "last attribute_ledger bill: counted bytes by bin",
        labels=("bin",))
    g.labels(bin="total").set(total)
    g.labels(bin="floor").set(rec["floor_bytes"])
    for b, v in rec["bins"].items():
        g.labels(bin=b).set(v)
    return rec


def audit_activation_dtypes(net, x_shape, compute_dtype=None,
                            act_threshold_elems=None, rows=None):
    """The ops of one step whose output is a float wider than the compute
    dtype at activation scale: [{"scope", "op", "dtype", "elems",
    "bytes"}], largest first; [] for a clean step."""
    if rows is None:
        rows = record_step(net, x_shape)
    cdt = net._compute_dtype if compute_dtype is None else compute_dtype
    cbits = _itemsize(cdt) * 8
    thr = _threshold(net) if act_threshold_elems is None \
        else int(act_threshold_elems)
    out = []
    for r in rows:
        if r["phase"] == "update":
            continue
        for dt, numel in r["out"]:
            if numel > thr and dt.is_floating_point \
                    and _itemsize(dt) * 8 > cbits:
                out.append({"scope": r["scope"], "op": r["op"],
                            "dtype": str(dt).replace("torch.", ""),
                            "elems": int(numel),
                            "bytes": int(numel * _itemsize(dt))})
    out.sort(key=lambda r: -r["bytes"])
    return out


def assert_activation_dtype_clean(net, x_shape, **kwargs):
    """Raise AssertionError naming every wide activation-scale output of
    the step (``audit_activation_dtypes``)."""
    off = audit_activation_dtypes(net, x_shape, **kwargs)
    if off:
        lines = [f"  {r['scope'][:40]:<42} {r['op']:<20} {r['dtype']:<8} "
                 f"{r['elems']:>12} elems  {r['bytes']:>12} B"
                 for r in off[:12]]
        raise AssertionError(
            f"{len(off)} wide-float activation-scale output(s) in a step "
            "whose compute dtype should bound activation widths:\n"
            + "\n".join(lines))


def format_attribution(rec, gb=True):
    """The attribution as a table (the analysis CLI's form)."""
    unit, div = ("GB", 1e9) if gb else ("MB", 1e6)

    def f(b):
        return f"{b / div:10.3f} {unit}"

    lines = [f"ledger total     {f(rec['ledger_total_bytes'])}",
             f"analytic floor   {f(rec['floor_bytes'])}"]
    for term, b in rec["floor_terms"].items():
        lines.append(f"  floor.{term:<22} {f(b)}")
    for name, b in sorted(rec["bins"].items(), key=lambda kv: -kv[1]):
        lines.append(f"  bin.{name:<24} {f(b)}")
        for t in rec["bin_top"].get(name, [])[:3]:
            lines.append(f"      {t['scope'][:30]:<32} {t['op'][:16]:<17}"
                         f"{f(t['bytes'])}")
    if rec.get("ratio_to_floor"):
        lines.append(f"total / floor    {rec['ratio_to_floor']:.3f}")
    return "\n".join(lines)


def residency(net, x_shape):
    """On the card: ``static_memory_for`` beside ``torch.cuda``'s
    allocated bytes and peak (the caller resets the peak before the
    step it measures)."""
    if net.device.type != "cuda":
        raise RuntimeError("residency reads the card's allocator: the "
                           "network is on " + str(net.device))
    terms = static_memory_for(net, x_shape)
    stats = torch.cuda.memory_stats(net.device)
    return {"static": terms,
            "allocated_bytes": int(stats["allocated_bytes.all.current"]),
            "max_allocated_bytes": int(torch.cuda.max_memory_allocated(
                net.device)),
            "reserved_bytes": int(stats["reserved_bytes.all.current"])}
