"""The diagnostic model of the static-analysis passes.

The port's copy of ``deeplearning4j_tpu/analysis/diagnostics.py``'s
``Diagnostic`` and ``Report`` (a collecting validator: passes append
records instead of raising on the first problem, so one run reports
every mistake with its location and a fix hint), with the codes of the
passes the port has: the SameDiff graph validator's.

Diagnostic codes are stable identifiers (tests and suppressions key on
them):

dtype          DTY02 implicit dtype promotion
SameDiff graph GRF01 unknown op            GRF02 duplicate variable
               GRF03 dangling variable     GRF04 cycle (use-before-def)
               GRF05 unfed placeholder     GRF06 dead subgraph
"""

from __future__ import annotations

ERROR = "error"
WARNING = "warning"

#: every stable diagnostic code with a one-line description
ALL_CODES = {
    "DTY02": "op silently promotes mixed input dtypes",
    "GRF01": "op name not present in the OPS registry",
    "GRF02": "variable produced by more than one op",
    "GRF03": "op consumes a variable that nothing defines",
    "GRF04": "variable used before its producer (cycle)",
    "GRF05": "placeholder required by the outputs but never fed",
    "GRF06": "op does not contribute to any loss/output",
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
