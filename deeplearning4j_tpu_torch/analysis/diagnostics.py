"""The diagnostic model shared by every static-analysis pass.

The port's copy of ``deeplearning4j_tpu/analysis/diagnostics.py``: a
collecting validator (passes append ``Diagnostic`` records instead of
raising on the first problem, so one run reports every mistake with its
location and a fix hint), with the reference's whole catalogue. The
codes are the reference's, so tests and suppressions key on the same
names; where a pass inspects a PyTorch construct in place of a JAX one,
its description says which:

shape/config   SHP01 nIn mismatch          SHP02 non-positive spatial dim
               SHP03 format adaptation     SHP04 merge/elementwise rank
               SHP05 layer config error    SHP06 missing nOut
dtype          DTY01 fp64 on the card      DTY02 implicit dtype promotion
SameDiff graph GRF01 unknown op            GRF02 duplicate variable
               GRF03 dangling variable     GRF04 cycle (use-before-def)
               GRF05 unfed placeholder     GRF06 dead subgraph
capture purity PUR01 print under capture   PUR02 host sync
               PUR03 untracked host RNG    PUR04 closed-over mutation
               PUR05 non-hashable static arg
partitioning   PAR01 unknown mesh axis     PAR02 spec rank mismatch
               PAR03 indivisible shard dim PAR04 collective axis mismatch
               PAR05 pipeline imbalance    PAR06 per-card memory over budget
recapture      RTC01 varying capture key   RTC02 unhashable static arg
               RTC03 shape-polymorphic feed
collectives    COL01 collective under divergent control flow (or ranks
                     whose recorded signatures differ)
               COL02 collective group/axis unknown to the mesh
               COL03 int8 lane accumulator disagreement
               COL04 recorded-vs-declared signature drift
               COL05 analytic-vs-measured collective bytes divergence
               COL06 malformed ring
threads        THR01 guarded state accessed outside its lock
               THR02 lock-order inversion  THR03 blocking call under lock
               THR04 unguarded lazy init of shared state
faults         FLT01 swallowed exception   FLT02 seamless dispatch boundary
               FLT03 unbounded blocking call
               FLT04 fault seam under a held lock
               FLT05 unbounded retry/poll loop
               FLT06 seam-name integrity (typo'd or dead seam)
"""

from __future__ import annotations

ERROR = "error"
WARNING = "warning"

#: every stable diagnostic code with a one-line description (the CLI's
#: --codes listing is generated from this)
ALL_CODES = {
    "SHP01": "explicit nIn disagrees with the propagated input size",
    "SHP02": "conv/pool arithmetic yields a non-positive spatial dim",
    "SHP03": "no preprocessor exists for the required format adaptation",
    "SHP04": "merge/elementwise vertex inputs disagree in rank or shape",
    "SHP05": "layer/vertex configuration error raised during inference",
    "SHP06": "layer requires nOut but none was configured",
    "DTY01": "fp64 dataType runs far below the card's bf16/f32 rates and "
             "the attention kernels take f32 and bf16 only",
    "DTY02": "op silently promotes mixed input dtypes",
    "GRF01": "op name not present in the OPS registry",
    "GRF02": "variable produced by more than one op",
    "GRF03": "op consumes a variable that nothing defines",
    "GRF04": "variable used before its producer (cycle)",
    "GRF05": "placeholder required by the outputs but never fed",
    "GRF06": "op does not contribute to any loss/output",
    "LNT00": "file could not be linted (parse or read failure)",
    "PUR01": "print() inside a captured step",
    "PUR02": "host sync on a device value inside a captured step",
    "PUR03": "untracked host RNG inside a captured step",
    "PUR04": "mutation of closed-over state inside a captured step",
    "PUR05": "non-hashable default for a static capture argument",
    "PAR01": "plan names a mesh axis that does not exist (or reuses one)",
    "PAR02": "partition spec rank exceeds the array rank",
    "PAR03": "sharded dimension not divisible by its mesh axis size",
    "PAR04": "collective axis/group name absent from the mesh",
    "PAR05": "pipeline stages unbalanced (or net not pipelineable)",
    "PAR06": "predicted per-card memory high-water mark exceeds the budget",
    "RTC01": "captured step keyed on a varying Python value (recapture "
             "loop)",
    "RTC02": "unhashable/mutable value passed for a static capture "
             "argument",
    "RTC03": "shape-polymorphic argument stream forces recapture",
    "COL01": "collective under rank-dependent control flow, or ranks "
             "whose collective signatures differ (deadlock hazard)",
    "COL02": "collective reduces over a group/axis the mesh does not carry",
    "COL03": "int8 lane accumulator disagrees between analyzer, bill and "
             "lane packing",
    "COL04": "recorded collective signature drifted from the declared "
             "CollectiveContract",
    "COL05": "measured collective bytes diverge >tolerance from the "
             "analytic bill",
    "COL06": "ring is not a permutation (or carries self-cycles)",
    "THR01": "shared guarded attribute accessed outside its lock",
    "THR02": "lock-order inversion in the acquired-while-held graph",
    "THR03": "blocking call while holding a lock",
    "THR04": "unguarded lazy initialization of shared state",
    "FLT01": "broad except swallows the error class (no raise/classify/"
             "count)",
    "FLT02": "dispatch boundary with no reachable chaos fault_point seam",
    "FLT03": "blocking call with no timeout (defeats the deadline "
             "contract)",
    "FLT04": "fault_point reachable while a lock is held (wedge becomes "
             "deadlock)",
    "FLT05": "retry/poll loop with no bound, budget, or backoff",
    "FLT06": "fault_point literal not a registered seam, or a seam no "
             "code invokes",
}


class Diagnostic:
    """One finding: code + severity + location + message (+ fix hint)."""

    __slots__ = ("code", "severity", "where", "message", "hint", "suppressed")

    def __init__(self, code, severity, where, message, hint=None,
                 suppressed=False):
        if code not in ALL_CODES:
            raise ValueError(f"unknown diagnostic code {code!r}")
        self.code = code
        self.severity = severity
        self.where = where
        self.message = message
        self.hint = hint
        self.suppressed = suppressed

    def format(self):
        tag = "suppressed" if self.suppressed else self.severity
        s = f"{self.code} [{tag}] {self.where}: {self.message}"
        if self.hint:
            s += f"; hint: {self.hint}"
        return s

    def __repr__(self):
        return f"<Diagnostic {self.format()}>"


class Report:
    """Accumulated diagnostics from one analysis pass (or several merged).

    `layers` optionally carries the per-layer parameter-count /
    activation-memory table produced by the shape pass.
    """

    def __init__(self, subject=""):
        self.subject = subject
        self.diagnostics = []
        self.layers = []   # [{index,name,type,in,out,params,activation_bytes}]

    def add(self, code, severity, where, message, hint=None, suppressed=False):
        d = Diagnostic(code, severity, where, message, hint, suppressed)
        self.diagnostics.append(d)
        return d

    def extend(self, other: "Report"):
        self.diagnostics.extend(other.diagnostics)
        self.layers.extend(other.layers)
        return self

    @property
    def errors(self):
        return [d for d in self.diagnostics
                if d.severity == ERROR and not d.suppressed]

    @property
    def warnings(self):
        return [d for d in self.diagnostics
                if d.severity == WARNING and not d.suppressed]

    @property
    def suppressed(self):
        return [d for d in self.diagnostics if d.suppressed]

    @property
    def ok(self):
        return not self.errors

    def codes(self):
        return sorted({d.code for d in self.diagnostics if not d.suppressed})

    def totalParams(self):
        return sum(row.get("params", 0) for row in self.layers)

    def format(self, verbose=False):
        lines = []
        head = self.subject or "analysis"
        lines.append(f"== {head}: {len(self.errors)} error(s), "
                     f"{len(self.warnings)} warning(s), "
                     f"{len(self.suppressed)} suppressed ==")
        for d in self.diagnostics:
            if d.suppressed and not verbose:
                continue
            lines.append("  " + d.format())
        if verbose and self.layers:
            lines.append(f"  -- {len(self.layers)} layer(s), "
                         f"{self.totalParams():,} params --")
            for row in self.layers:
                lines.append(
                    "  [{index:>3}] {name:<28} {type:<24} "
                    "{out:<34} params={params:<12,} "
                    "act={activation_bytes:,}B".format(**row))
        return "\n".join(lines)


class ConfigValidationError(ValueError):
    """Raised by the opt-in eager check (init(validate=True)) when the
    shape/dtype (or partition-plan) pass finds errors. Carries the full
    Report."""

    def __init__(self, report: Report):
        self.report = report
        super().__init__(
            "model configuration failed static validation:\n"
            + report.format())
