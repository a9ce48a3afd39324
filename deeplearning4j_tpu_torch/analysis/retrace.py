"""The runtime half of the retrace pass (reference:
``deeplearning4j_tpu/analysis/retrace.py``): a capture counter.

The reference counts jit traces: a call pattern that varies its trace
key compiles every step. The port's counterpart of a trace is a CUDA
graph capture (``runtime.aot``): a step captured again and again (one
graph per batch size, a graph per knob flip) pays a warm-up and a
capture each time. ``RetraceSentinel`` counts the captures of each step
it watches and raises ``RetraceError`` past its budget; every count is
mirrored into ``dl4j_retrace_compiles_total``.

    sentinel = RetraceSentinel(max_compiles=1)
    step = sentinel.wrap(fn, "train_step")   # captures each new signature
    ...
    assert sentinel.compiles("train_step") == 1

or, for a network, ``sentinel.install(net)``: the net's train step then
captures each new signature on first sight and replays it after.

The static half (``lint_retrace``/``lint_retrace_paths``) finds the call
patterns that make a step capture again and again, keyed on what the
port's capture key holds (``runtime.aot``: ``abstract_signature`` — each
tensor's shape, dtype and device, a Python value's TYPE only — with the
knobs' live values, ``cache_key``). Codes are the reference's:

- RTC01  a captured step keyed on a varying Python value:
         * a ``CapturedStep``/``cached_jit``/``torch.compile``/
           ``torch.cuda.CUDAGraph``/``make_graphed_callables`` built
           INSIDE a loop: each owns a fresh table, so nothing replays;
         * a Python number fed to a captured step that varies per
           iteration (the key sees only its type: the replay reuses the
           value of the capture), or a ``static_argnames`` argument of
           ``torch.compile`` that varies (a recompile per value);
         * a knob set per iteration (``autotune.applied``/``install``
           with a loop-varying value): each setting is a capture of its
           own;
         * the same argument position a Python number at one call site
           and a tensor at another (two signatures, two captures).
- RTC02  an unhashable value (list/dict/set literal, an array) passed
         for a static argument, or as a knob value: the capture table's
         slot hashes the knob state, so this raises at call time.
- RTC03  a shape-polymorphic argument stream: a captured step fed a
         slice whose width varies per iteration (``x[:i]``) or an
         ``arange(n)``-style tensor of loop-varying extent — a new
         signature, hence a new capture, every iteration.

Suppressions use the purity pass's syntax (``# purity-ok[RTC01]:
reason``).
"""

from __future__ import annotations

import ast

from deeplearning4j_tpu_torch.analysis.diagnostics import ERROR, Report
from deeplearning4j_tpu_torch.analysis.purity import (
    _SUPPRESS_RE, _attr_chain, _call_name, iter_py_files,
)

__all__ = ["RetraceError", "RetraceSentinel", "lint_retrace",
           "lint_retrace_paths"]


class RetraceError(RuntimeError):
    """A step captured more often than its budget allows."""


class RetraceSentinel:
    """Counts captures of watched steps (module docstring)."""

    def __init__(self, max_compiles=1):
        self.max_compiles = int(max_compiles)
        self.counts = {}

    def _record(self, label):
        n = self.counts.get(label, 0) + 1
        self.counts[label] = n
        from deeplearning4j_tpu_torch.runtime import telemetry

        telemetry.get_registry().counter(
            "dl4j_retrace_compiles_total",
            "captures counted by RetraceSentinel-watched steps",
            labels=("fn",)).labels(fn=label).inc()
        if n > self.max_compiles:
            raise RetraceError(
                f"'{label}' is being captured for the {n}th time (budget "
                f"{self.max_compiles}): the call site varies its signature "
                "(shapes, dtypes) or the knobs per call")

    def compiles(self, name):
        return self.counts.get(name, 0)

    def watch(self, step, name):
        """Count `step`'s captures (an ``aot.CapturedStep``) under
        `name`, and let it capture each new signature on first sight."""
        step.auto = True
        step.observers.append(lambda: self._record(name))
        return step

    def wrap(self, fn, name=None, **kwargs):
        """`fn` as an ``aot.CapturedStep`` whose captures are counted;
        `kwargs` go to it (``fingerprint`` defaults to the label)."""
        from deeplearning4j_tpu_torch.runtime import aot

        label = name or getattr(fn, "__name__", repr(fn))
        kwargs.setdefault("fingerprint", label)
        return self.watch(aot.CapturedStep(fn, entry=label, **kwargs),
                          label)

    def install(self, net, name="train_step"):
        """Count captures of a MultiLayerNetwork/ComputationGraph's (or a
        ParallelWrapper's net's) train step. Returns self."""
        net = getattr(net, "net", net)
        self.watch(net._train_capture(), name)
        return self

    def install_fit_dataset(self, net, name="fit_dataset_loop"):
        """Count captures of the steps fitDataSet(stepsPerSync=k) runs:
        its blocks replay the train step's graphs, so this watches the
        same step under `name`. Returns self."""
        return self.install(net, name)


# ----------------------------------------------------------------------
# static pass
# ----------------------------------------------------------------------

def _static_positions(call):
    """(static_names, static_nums) requested by a capture
    constructor's keywords; names/ints only (non-literal specs are
    invisible)."""
    names, nums = set(), set()
    for kw in call.keywords:
        if kw.arg not in ("static_argnames", "static_argnums"):
            continue
        for n in ast.walk(kw.value):
            if isinstance(n, ast.Constant):
                if isinstance(n.value, str):
                    names.add(n.value)
                elif isinstance(n.value, int):
                    nums.add(n.value)
    return names, nums


#: constructors of a captured callable (the callable is their first
#: argument); ``compile`` counts only as ``torch.compile``
_CAPTURE_CTORS = {"CapturedStep", "cached_jit", "make_graphed_callables"}
#: what builds a fresh capture table or graph each time it is called
_FRESH_CAPTURE = _CAPTURE_CTORS | {"CUDAGraph"}
#: the knob setters (``runtime.autotune``)
_KNOB_SETTERS = {"applied", "install"}


def _is_torch_compile(func):
    chain = _attr_chain(func) or []
    return len(chain) == 2 and chain[0] == "torch" and chain[1] == "compile"


class _JitIndex(ast.NodeVisitor):
    """Find every name a captured callable is bound to, with its static
    argument spec and its function's params: ``s = CapturedStep(f)``,
    ``self._captured = aot.cached_jit(...)``, ``g = torch.compile(f,
    ...)``, and defs decorated with ``torch.compile``."""

    def __init__(self):
        self.jitted = {}       # callable name -> (static_names, static_nums)
        self.defs = {}         # function name -> FunctionDef (for params)
        self.targets = {}      # callable name -> name of the function

    def _is_jit(self, expr):
        if isinstance(expr, ast.Call):
            if _call_name(expr.func) in _CAPTURE_CTORS \
                    or _is_torch_compile(expr.func):
                return expr
            if _call_name(expr.func) == "partial" and expr.args \
                    and _is_torch_compile(expr.args[0]):
                return expr
        return None

    def visit_FunctionDef(self, node):
        self.defs[node.name] = node
        for dec in node.decorator_list:
            jc = self._is_jit(dec)
            if jc is not None:
                self.jitted[node.name] = _static_positions(jc)
                self.targets[node.name] = node.name
            elif _is_torch_compile(dec):
                self.jitted[node.name] = (set(), set())
                self.targets[node.name] = node.name
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Assign(self, node):
        jc = self._is_jit(node.value)
        if jc is not None:
            spec = _static_positions(jc)
            fn = jc.args[0] if jc.args else None
            fname = fn.id if isinstance(fn, ast.Name) else (
                fn.attr if isinstance(fn, ast.Attribute) else None)
            for t in node.targets:
                name = t.id if isinstance(t, ast.Name) else (
                    t.attr if isinstance(t, ast.Attribute) else None)
                if name is not None:
                    self.jitted[name] = spec
                    if fname is not None:
                        self.targets[name] = fname
        self.generic_visit(node)


class _LoopVars(ast.NodeVisitor):
    """Names that take a new value on each iteration of one loop."""

    def __init__(self, loop):
        self.names = set()
        if isinstance(loop, ast.For):
            for n in ast.walk(loop.target):
                if isinstance(n, ast.Name):
                    self.names.add(n.id)
        for st in loop.body:
            self.visit(st)

    def visit_Assign(self, node):
        for t in node.targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name):
                    self.names.add(n.id)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        for n in ast.walk(node.target):
            if isinstance(n, ast.Name):
                self.names.add(n.id)
        self.generic_visit(node)

    def visit_For(self, node):
        for n in ast.walk(node.target):
            if isinstance(n, ast.Name):
                self.names.add(n.id)
        self.generic_visit(node)

    visit_comprehension = visit_For


def _reads(expr, names):
    for n in ast.walk(expr):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                and n.id in names:
            return n.id
    return None


def _is_mutable_literal(expr):
    if isinstance(expr, (ast.List, ast.Dict, ast.Set)):
        return type(expr).__name__.lower()
    if isinstance(expr, ast.Call):
        name = _call_name(expr.func)
        if name in ("array", "asarray", "zeros", "ones", "arange"):
            return f"{name}(...) array"
        if name in ("list", "dict", "set", "bytearray"):
            return name
    return None


_ARANGE_LIKE = {"arange", "linspace", "ones", "zeros", "empty", "full"}


class _CallSiteChecker(ast.NodeVisitor):
    """Walk the module flagging hazardous call sites of captured
    callables; loop context is threaded down so per-iteration variation
    is recognizable."""

    def __init__(self, index, path, out):
        self.ix = index
        self.path = path
        self.out = out
        self.loop_stack = []   # [set(varying names)]
        # argument literal-ness per (fn, position) for the weak-type
        # flip check: {(fn, pos): {"literal", "other"}}
        self.arg_kinds = {}

    def _flag(self, node, code, msg):
        self.out.append((node.lineno, getattr(node, "col_offset", 0),
                         code, msg))

    def _varying(self):
        s = set()
        for v in self.loop_stack:
            s |= v
        return s

    # -- loops ----------------------------------------------------------
    def visit_For(self, node):
        self.loop_stack.append(_LoopVars(node).names)
        self.generic_visit(node)
        self.loop_stack.pop()

    visit_AsyncFor = visit_For

    def visit_While(self, node):
        self.loop_stack.append(_LoopVars(node).names)
        self.generic_visit(node)
        self.loop_stack.pop()

    # -- call sites -----------------------------------------------------
    def visit_Call(self, node):
        fname = _call_name(node.func)

        # a capture table / graph built inside a loop: nothing replays
        if self.loop_stack and (fname in _FRESH_CAPTURE
                                or _is_torch_compile(node.func)):
            what = "torch.compile" if _is_torch_compile(node.func) \
                else fname
            self._flag(node, "RTC01",
                       f"{what}(...) built inside a loop: every iteration "
                       "makes a NEW capture table (or graph) with nothing "
                       "in it, so each call captures again; hoist it out "
                       "of the loop")
        if fname in _KNOB_SETTERS and node.args:
            self._check_knobs(node, fname)

        spec = self.ix.jitted.get(fname)
        if spec is not None:
            self._check_jitted_call(node, fname, spec)
        self.generic_visit(node)

    def _check_knobs(self, node, fname):
        arg = node.args[0]
        if isinstance(arg, ast.Dict):
            for v in arg.values:
                mut = _is_mutable_literal(v)
                if mut is not None:
                    self._flag(v, "RTC02",
                               f"knob value passed to {fname}() is a "
                               f"{mut}: the knob state is part of the "
                               "capture table's slot, which hashes it, so "
                               "this raises TypeError at call time; pass "
                               "a string or a number")
        if self.loop_stack:
            v = _reads(arg, self._varying())
            if v is not None:
                self._flag(node, "RTC01",
                           f"knobs set by {fname}() vary with loop "
                           f"variable '{v}': each setting is a capture of "
                           "its own; tune once (autotune) and set the "
                           "knobs outside the loop")

    def _param_names(self, fname):
        d = self.ix.defs.get(self.ix.targets.get(fname, fname))
        if d is None:
            return []
        return [a.arg for a in d.args.args]

    def _check_jitted_call(self, node, fname, spec):
        static_names, static_nums = spec
        params = self._param_names(fname)
        varying = self._varying()

        for pos, arg in enumerate(node.args):
            pname = params[pos] if pos < len(params) else None
            is_static = pos in static_nums or (pname in static_names)
            self._check_one(node, fname, arg, pos, pname, is_static,
                            varying)
        for kw in node.keywords:
            if kw.arg is None:
                continue
            is_static = kw.arg in static_names
            self._check_one(node, fname, kw.value, None, kw.arg,
                            is_static, varying)

    def _check_one(self, node, fname, arg, pos, pname, is_static,
                   varying):
        label = pname or (f"arg {pos}" if pos is not None else "arg")

        if is_static:
            mut = _is_mutable_literal(arg)
            if mut is not None:
                self._flag(arg, "RTC02",
                           f"static argument '{label}' of {fname}() is "
                           f"passed a {mut}: static args are hashed "
                           "for the guard lookup, so this raises "
                           "TypeError at call time; pass a "
                           "tuple/frozenset or make the arg a tensor")
                return
            v = _reads(arg, varying)
            if v is not None:
                self._flag(arg, "RTC01",
                           f"static argument '{label}' of {fname}() "
                           f"varies with loop variable '{v}': every "
                           "distinct value compiles a NEW graph; make it "
                           "a tensor or hoist it out of the loop")
                return
        else:
            v = _python_number(arg, varying)
            if v is not None:
                self._flag(arg, "RTC01",
                           f"argument '{label}' of {fname}() is a Python "
                           f"number varying with loop variable '{v}': the "
                           "capture key holds only its type, so the "
                           "replay reuses the value of the capture; pass "
                           "it as a device tensor (or a host value the "
                           "prologue writes)")
                return

        # weak-type flip: same position literal at one site, not at
        # another (recorded across the whole module walk)
        if pos is not None:
            kind = "literal" if isinstance(arg, ast.Constant) \
                and isinstance(arg.value, (int, float, complex)) \
                and not isinstance(arg.value, bool) else "other"
            kinds = self.arg_kinds.setdefault((fname, pos), {})
            kinds.setdefault(kind, arg)
            if len(kinds) == 2:
                lit = kinds["literal"]
                self._flag(
                    lit if kind == "literal" else arg, "RTC01",
                    f"argument {pos} of {fname}() is a bare Python "
                    f"number at line {lit.lineno} but a non-literal "
                    "elsewhere: a number keys by type and a tensor by "
                    "shape, so the two sites capture twice; pass a "
                    "tensor at both")
                kinds["reported"] = True

        # shape polymorphism: slice bounds / extent constructors that
        # read a loop-varying name
        v = self._poly_shape(arg, varying)
        if v is not None and not is_static:
            self._flag(arg, "RTC03",
                       f"argument '{label}' of {fname}() has a shape "
                       f"that varies with loop variable '{v}' "
                       "(slice/arange extent): every iteration "
                       "presents a new signature and captures again; "
                       "pad to a fixed bucket (aot.pad_batch)")

    def _poly_shape(self, arg, varying):
        for n in ast.walk(arg):
            if isinstance(n, ast.Subscript):
                sl = n.slice
                slices = sl.elts if isinstance(sl, ast.Tuple) else [sl]
                for s in slices:
                    if isinstance(s, ast.Slice):
                        v = self._slice_width_varies(s, varying)
                        if v is not None:
                            return v
            elif isinstance(n, ast.Call):
                cname = _call_name(n.func)
                if cname in _ARANGE_LIKE and n.args:
                    v = _reads(n.args[0], varying)
                    if v is not None:
                        return v
        return None

    @staticmethod
    def _slice_width_varies(s, varying):
        """Loop variable that makes the slice WIDTH vary, or None.
        `x[s : s + B]` is the standard minibatch window: both bounds
        move but the width is fixed (the ragged tail costs ONE extra
        capture, not one per iteration) — only width-varying slices
        (`x[:i]`, `x[i:]`, `x[a:b]` with independent bounds) capture
        again every step."""
        lo, hi = s.lower, s.upper
        v_lo = None if lo is None else _reads(lo, varying)
        v_hi = None if hi is None else _reads(hi, varying)
        if v_lo is None and v_hi is None:
            return None
        if v_lo is not None and v_hi is not None:
            # fixed-width pattern: lower is `v`, upper is `v <op> k`
            # (or mirrored) with the offset not itself loop-varying
            if isinstance(lo, ast.Name) and isinstance(hi, ast.BinOp) \
                    and isinstance(hi.left, ast.Name) \
                    and hi.left.id == lo.id \
                    and _reads(hi.right, varying) is None:
                return None
            return v_lo
        return v_lo or v_hi


def _python_number(arg, varying):
    """The loop variable a Python-number argument varies with, or None:
    a bare loop name, ``int``/``float`` of one, or arithmetic over names
    and numbers only (a subscript or a method call is a tensor)."""
    if isinstance(arg, ast.Call) and isinstance(arg.func, ast.Name) \
            and arg.func.id in ("int", "float") and len(arg.args) == 1:
        return _python_number(arg.args[0], varying)
    for n in ast.walk(arg):
        if not isinstance(n, (ast.Name, ast.Constant, ast.BinOp,
                              ast.UnaryOp, ast.operator, ast.unaryop,
                              ast.Load)):
            return None
    return _reads(arg, varying)


def lint_retrace(source, path="<string>"):
    """Static recapture-hazard lint of one source string -> Report.
    Suppressions use the purity pass's comment syntax
    (`# purity-ok[RTC01]: reason`)."""
    report = Report(subject=f"retrace:{path}")
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        report.add("LNT00", ERROR, f"{path}:{e.lineno or 0}",
                   f"file does not parse: {e.msg}")
        return report
    index = _JitIndex()
    index.visit(tree)
    out = []
    _CallSiteChecker(index, path, out).visit(tree)

    lines = source.splitlines()
    seen = set()
    for line, col, code, msg in sorted(out):
        if (line, col, code) in seen:
            continue
        seen.add((line, col, code))
        suppressed = False
        text = lines[line - 1] if 0 < line <= len(lines) else ""
        m = _SUPPRESS_RE.search(text)
        if m:
            codes = {c.strip() for c in m.group("codes").split(",")}
            suppressed = "*" in codes or code in codes
        report.add(code, ERROR, f"{path}:{line}:{col}", msg,
                   suppressed=suppressed)
    return report


def lint_retrace_paths(paths):
    """Lint files/directories for recapture hazards -> merged Report."""
    report = Report(subject="retrace")
    for path in iter_py_files(paths):
        try:
            with open(path, "r", encoding="utf-8") as fh:
                src = fh.read()
        except OSError as e:
            report.add("LNT00", ERROR, path, f"unreadable: {e}")
            continue
        report.extend(lint_retrace(src, path))
    return report
