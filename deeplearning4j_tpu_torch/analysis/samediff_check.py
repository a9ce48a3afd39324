"""SameDiff graph validator.

The port's ``deeplearning4j_tpu/analysis/samediff_check.py``, pointed at
the port's op table and graphs: pre-execution validation (unknown ops,
dangling edges, cycles, unfed placeholders, as a runtime rejects them
before placement) of a SameDiff's op list. A malformed graph (loaded
from disk, hand-edited, or produced by an importer) would otherwise
explode at its first output()/fit(), mid-interpretation. This pass walks
the recorded op list statically, with no tensor touched.

Checks:
- GRF01 unknown op (opName absent from the OPS registry)
- GRF02 duplicate variable (two ops claim the same output name, or an
  op output collides with a VARIABLE/CONSTANT/placeholder)
- GRF03 dangling variable (op input that nothing defines)
- GRF04 use-before-def (consumer appears before its producer — the op
  list is definition-ordered, so this is a cycle)
- GRF05 unfed placeholder (required by the requested outputs but absent
  from the fed set)
- GRF06 dead subgraph (ops outside the backward slice of every
  loss/output — compiled for nothing, warning)
- DTY02 implicit dtype promotion (an op mixing float widths, which
  torch silently upcasts: an accidental fp32->fp64 or bf16->fp32 path)
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.analysis.diagnostics import (
    ERROR, WARNING, Report,
)
from deeplearning4j_tpu_torch.ndarray.dtype import resolve

__all__ = ["validate_samediff"]


def _op_where(i, op):
    outs = ",".join(op.outputs)
    return f"op {i} ({op.opName} -> {outs})"


# ops whose output dtype is NOT result_type(inputs): cast sets it from
# its kwarg; comparisons emit bool; arg-reductions emit integer indices.
# Without this, a castTo(f32) downstream of an f64 constant would keep
# propagating f64 and the DTY02 hint ("castTo an input") could never
# clear its own warning.
_BOOL_OPS = frozenset({"lt", "lte", "gt", "gte", "eq", "neq", "isnan",
                       "isinf", "isfinite", "and", "or", "not", "xor"})
_INT_OPS = frozenset({"argmax", "argmin"})


def _result_type(dtypes):
    out = dtypes[0]
    for d in dtypes[1:]:
        out = torch.promote_types(out, d)
    return out


def _op_out_dtype(op, in_dtypes):
    if op.opName == "cast" and op.kwargs.get("dtype"):
        try:
            return resolve(op.kwargs["dtype"])
        except (TypeError, ValueError):
            return None
    if op.opName in _BOOL_OPS:
        return torch.bool
    if op.opName in _INT_OPS:
        return torch.int64
    return _result_type(in_dtypes) if in_dtypes else None


def _known_dtype(sd, name, dtypes):
    if name in dtypes:
        return dtypes[name]
    v = sd._vars.get(name)
    if v is not None and getattr(v, "_ph_dtype", None) is not None:
        return v._ph_dtype
    arr = sd._arrays.get(name)
    return None if arr is None else arr.dtype


def validate_samediff(sd, placeholders=None, outputs=None):
    """Validate a SameDiff graph statically. Returns a Report.

    placeholders: iterable of names the caller will feed. None means
    "derive from the TrainingConfig mappings if one is set, else skip
    the unfed-placeholder check" (an un-configured graph legitimately
    doesn't know its feeds yet).
    outputs: names/SDVariables to treat as the graph's requested
    outputs. None falls back to the declared loss variables, else every
    sink variable (consumed by no op).
    """
    from deeplearning4j_tpu_torch.autodiff.ops_impl import OPS
    from deeplearning4j_tpu_torch.autodiff.samediff import (
        SDVariable, VariableType,
    )

    report = Report(subject="SameDiff")
    produced = {}        # var name -> producing op index
    dtypes = {}          # var name -> inferred np dtype (best effort)

    defined_before = set(sd._arrays)
    defined_before.update(
        n for n, v in sd._vars.items()
        if v.variableType in (VariableType.PLACEHOLDER,
                              VariableType.VARIABLE,
                              VariableType.CONSTANT))

    for i, op in enumerate(sd._ops):
        where = _op_where(i, op)
        if op.opName not in OPS:
            report.add("GRF01", ERROR, where,
                       f"unknown op '{op.opName}' (not in the OPS registry)",
                       hint="register it via autodiff.ops_impl.OPS or fix "
                            "the imported graph")
        for n in op.outputs:
            if n in produced:
                report.add("GRF02", ERROR, where,
                           f"variable '{n}' already produced by op "
                           f"{produced[n]} "
                           f"({sd._ops[produced[n]].opName})")
            elif n in defined_before:
                report.add("GRF02", ERROR, where,
                           f"op output '{n}' collides with a declared "
                           "variable/constant/placeholder")
            produced[n] = i
        for n in op.inputs:
            if n not in sd._vars and n not in sd._arrays:
                report.add("GRF03", ERROR, where,
                           f"input '{n}' is not defined anywhere in the "
                           "graph")
                continue
            src = produced.get(n)
            v = sd._vars.get(n)
            if (src is None and n not in defined_before
                    and v is not None
                    and v.variableType == VariableType.ARRAY):
                later = sd._producer.get(n)
                if later is not None and later >= i:
                    report.add("GRF04", ERROR, where,
                               f"input '{n}' is produced by the LATER op "
                               f"{later} ({sd._ops[later].opName}) — "
                               "use-before-def / cycle")
                else:
                    report.add("GRF03", ERROR, where,
                               f"input '{n}' has no producer and no value")
        # dtype promotion (only when every input dtype is known)
        in_dts = [_known_dtype(sd, n, dtypes) for n in op.inputs]
        known = [d for d in in_dts if d is not None]
        if known and len(known) == len(in_dts):
            floats = {d for d in known if d.is_floating_point}
            if len(floats) > 1 and op.opName != "cast":
                out_dt = _result_type(known)
                report.add(
                    "DTY02", WARNING, where,
                    "mixed float inputs "
                    + "/".join(sorted(str(d).replace("torch.", "")
                                      for d in floats))
                    + " silently promote to "
                    + str(out_dt).replace("torch.", ""),
                    hint="castTo(...) an input explicitly so the compute "
                         "dtype is intentional")
            res = _op_out_dtype(op, known)
            if res is not None:
                for n in op.outputs:
                    dtypes[n] = res

    # ---- slice-based checks -------------------------------------------
    if outputs is not None:
        out_names = [o.name if isinstance(o, SDVariable) else o
                     for o in outputs]
    elif sd._loss_vars:
        out_names = list(sd._loss_vars)
    else:
        consumed = {n for op in sd._ops for n in op.inputs}
        out_names = [n for op in sd._ops for n in op.outputs
                     if n not in consumed]

    live_ops = set(sd._slice_for(out_names)) if out_names else set()
    needed = set(out_names)
    for i in live_ops:
        needed.update(sd._ops[i].inputs)
        needed.update(sd._ops[i].outputs)

    fed = None
    if placeholders is not None:
        fed = {p.name if isinstance(p, SDVariable) else p
               for p in placeholders}
    elif sd._tc is not None:
        fed = set(getattr(sd._tc, "dataSetFeatureMapping", None) or [])
        fed |= set(getattr(sd._tc, "dataSetLabelMapping", None) or [])
    if fed is not None:
        for n, v in sd._vars.items():
            if (v.variableType == VariableType.PLACEHOLDER
                    and n in needed and n not in fed):
                report.add("GRF05", ERROR, f"placeholder '{n}'",
                           "required by the requested outputs but not in "
                           "the fed set "
                           f"({sorted(fed) if fed else 'nothing fed'})",
                           hint="feed it, or map it in "
                                "TrainingConfig.dataSetFeatureMapping")

    if out_names:
        for i, op in enumerate(sd._ops):
            if i not in live_ops:
                report.add("GRF06", WARNING, _op_where(i, op),
                           "unreachable from any requested output/loss "
                           f"({out_names}) — dead subgraph",
                           hint="drop the op or mark its result as an "
                                "output")
    return report
