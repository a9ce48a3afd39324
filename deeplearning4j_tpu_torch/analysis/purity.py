"""Capture-purity linter: an AST pass flagging side effects inside a
captured step (reference: ``deeplearning4j_tpu/analysis/purity.py``, a
JAX-purity lint, retargeted).

Under a CUDA-graph capture, as under ``jit``, the step's Python body
runs once, at capture; every replay re-launches the recorded kernels
and nothing else. A ``print`` fires once, a ``np.random`` draw is baked
into the graph as a constant, a mutated closure desynchronizes from the
replays, and a host sync (``.item()``, ``float(t)``, ``.cpu()``) is
refused by the capture (or, eagerly, stalls the stream every step). The
runtime twin of this pass is ``runtime.aot.HostReadGuard``, which
refuses any host read inside a captured region as it runs; this pass
finds the same mistakes in the source, before anything runs.

The captured ("traced") functions are the ones handed to the port's
capture surfaces:

- ``aot.CapturedStep(fn, ...)`` and ``aot.cached_jit(fn, ...)`` (what
  ``precompile`` and the schedulers capture), and every function a
  captured function calls in the same module (``f(...)``,
  ``self.f(...)``);
- the body of a ``with torch.cuda.graph(...)`` block;
- ``torch.cuda.make_graphed_callables(fn_or_tuple, ...)``;
- ``torch.compile(fn)`` and ``@torch.compile`` (its graphs are traced
  once per guard set as well).

Codes (the reference's, with their capture meanings):
- PUR01 print() in a captured step (fires once, at capture)
- PUR02 host sync: float()/int()/bool() on a step-local value,
  ``.item()``, ``.cpu()``, ``.numpy()``, ``.tolist()``,
  ``torch.cuda.synchronize()``, numpy ``asarray``/``array`` of a
  step-local value
- PUR03 untracked host RNG: ``numpy.random.*`` / stdlib ``random.*``
  (drawn once at capture; draw from a device generator the capture
  registers)
- PUR04 mutation of closed-over state: global/nonlocal declarations,
  ``self.attr`` writes, append/extend/update/... on closed-over objects
- PUR05 non-hashable default for a static argument of ``torch.compile``
  (``static_argnames``/``static_argnums`` on a capture constructor)

Suppression: a violation is downgraded to "suppressed" when its line
carries a justification comment of the form

    n = int(t.shape[0])  # purity-ok[PUR02]: a shape, not a device value

The code list may be comma-separated or `*`; the justification text
after the colon/dash is REQUIRED — a bare tag does not suppress.
"""

from __future__ import annotations

import ast
import os
import re

from deeplearning4j_tpu_torch.analysis.diagnostics import ERROR, Report

__all__ = ["lint_source", "lint_paths", "iter_py_files"]

# constructors whose first argument is captured
_CAPTURE_CTORS = {"CapturedStep", "cached_jit", "make_graphed_callables"}
# ``torch.compile`` (a bare ``compile`` is the builtin)
_COMPILE = "compile"
# the capture context manager: ``with torch.cuda.graph(g):``
_GRAPH_CTX = "graph"

_MUTATORS = {"append", "extend", "insert", "add", "update", "pop",
             "popitem", "remove", "discard", "clear", "setdefault",
             "write", "writelines"}

# tensor methods that read a device value back to the host
_HOST_READS = {"item", "cpu", "numpy", "tolist"}

_SUPPRESS_RE = re.compile(
    r"#\s*purity-ok\[(?P<codes>[A-Z0-9*,\s]+)\]\s*[:—-]\s*(?P<why>\S.*)")


class Violation:
    __slots__ = ("path", "line", "col", "code", "message", "suppressed")

    def __init__(self, path, line, col, code, message, suppressed=False):
        self.path, self.line, self.col = path, line, col
        self.code, self.message = code, message
        self.suppressed = suppressed

    def format(self):
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.path}:{self.line}:{self.col}: {self.code} " \
               f"{self.message}{tag}"


def _call_name(func):
    """Trailing name of a call target: aot.CapturedStep -> 'CapturedStep'."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _root_name(node):
    """Leftmost Name of an attribute/subscript chain, else None."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _attr_chain(node):
    """Dotted parts of an attribute chain rooted at a Name:
    np.random.randn -> ['np', 'random', 'randn']."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return parts
    return None


class _ModuleIndex(ast.NodeVisitor):
    """First pass: import aliases, every function def, and which defs /
    lambdas / ``with torch.cuda.graph`` bodies are captured."""

    def __init__(self):
        self.numpy_aliases = set()
        self.numpy_random_aliases = set()   # numpy.random bound directly
        self.stdlib_random_aliases = set()
        self.torch_aliases = {"torch"}
        self.torch_names = {}   # local name -> original (from torch import)
        self.functools_partial = {"partial"}
        self.defs = {}          # name -> [FunctionDef nodes]
        self.traced = set()     # id(node) of captured def/lambda nodes
        self.traced_blocks = []  # With nodes whose body is captured
        self.callback_fns = set()   # kept for the checker's interface
        self.static_mutable = []    # (kw node, fn name, site) for PUR05

    # -- imports --------------------------------------------------------
    def visit_Import(self, node):
        for a in node.names:
            asname = a.asname or a.name.split(".")[0]
            if a.name == "numpy":
                self.numpy_aliases.add(asname)
            elif a.name == "numpy.random":
                if a.asname:          # import numpy.random as npr
                    self.numpy_random_aliases.add(a.asname)
                else:                 # import numpy.random binds 'numpy'
                    self.numpy_aliases.add("numpy")
            elif a.name.startswith("numpy."):
                self.numpy_aliases.add(asname)
            if a.name == "random":
                self.stdlib_random_aliases.add(asname)
            if a.name == "torch" and a.asname:
                self.torch_aliases.add(a.asname)
        self.generic_visit(node)

    def visit_ImportFrom(self, node):
        if node.module == "numpy":
            for a in node.names:
                if a.name == "random":  # from numpy import random [as r]
                    self.numpy_random_aliases.add(a.asname or "random")
        elif node.module and (node.module == "torch"
                              or node.module.startswith("torch.")):
            for a in node.names:
                self.torch_names[a.asname or a.name] = a.name
        self.generic_visit(node)

    def _is_torch_compile(self, expr):
        """``torch.compile`` (or an alias of it), not the builtin."""
        chain = _attr_chain(expr) or []
        if len(chain) == 2 and chain[0] in self.torch_aliases \
                and chain[1] == _COMPILE:
            return True
        return isinstance(expr, ast.Name) \
            and self.torch_names.get(expr.id) == _COMPILE

    def _is_graph_ctx(self, expr):
        """``torch.cuda.graph(...)`` / ``cuda.graph(...)`` / an imported
        ``graph``."""
        if not isinstance(expr, ast.Call):
            return False
        chain = _attr_chain(expr.func) or []
        if len(chain) >= 2 and chain[-1] == _GRAPH_CTX \
                and chain[-2] == "cuda":
            return True
        return isinstance(expr.func, ast.Name) \
            and self.torch_names.get(expr.func.id) == _GRAPH_CTX

    # -- defs -----------------------------------------------------------
    def visit_FunctionDef(self, node):
        self.defs.setdefault(node.name, []).append(node)
        for dec in node.decorator_list:
            if self._is_capture_expr(dec):
                self.traced.add(id(node))
                self._check_static_defaults(dec, node)
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def _is_capture_expr(self, expr):
        """@torch.compile / @torch.compile(...) / @partial(torch.compile,
        ...)."""
        if self._is_torch_compile(expr):
            return True
        if isinstance(expr, ast.Call):
            if self._is_torch_compile(expr.func):
                return True
            if _call_name(expr.func) in self.functools_partial \
                    and expr.args:
                return self._is_capture_expr(expr.args[0])
        return False

    def visit_With(self, node):
        if any(self._is_graph_ctx(it.context_expr) for it in node.items):
            self.traced_blocks.append(node)
        self.generic_visit(node)

    visit_AsyncWith = visit_With

    # -- call sites -----------------------------------------------------
    def visit_Call(self, node):
        name = _call_name(node.func)
        if name in _CAPTURE_CTORS or self._is_torch_compile(node.func):
            for c in node.args[:1]:
                self._mark(c, self.traced)
            self._note_static_call(node)
        self.generic_visit(node)

    def _mark(self, expr, into):
        if isinstance(expr, ast.Lambda):
            into.add(id(expr))
        elif isinstance(expr, ast.Name):
            # defs appearing AFTER the call site resolve in finalize()
            into.add(("name", expr.id))
        elif isinstance(expr, ast.Attribute):
            # CapturedStep(self._train_step): resolve by method name
            into.add(("name", expr.attr))
        elif isinstance(expr, ast.Call):
            # CapturedStep(partial(f, ...)) — best effort
            for a in expr.args:
                self._mark(a, into)
        elif isinstance(expr, (ast.Tuple, ast.List)):
            # make_graphed_callables((f, g), ...)
            for a in expr.elts:
                self._mark(a, into)
        elif isinstance(expr, (ast.BoolOp, ast.IfExp)):
            parts = expr.values if isinstance(expr, ast.BoolOp) \
                else [expr.body, expr.orelse]
            for p in parts:
                self._mark(p, into)

    def _note_static_call(self, call):
        """torch.compile(f, static_argnames=...) — pair the static names
        with f's defaults for the PUR05 check."""
        static = None
        for kw in call.keywords:
            if kw.arg in ("static_argnames", "static_argnums"):
                static = kw
        if static is None or not call.args:
            return
        target = call.args[0]
        if isinstance(target, ast.Name):
            self.static_mutable.append((static, target.id, call))

    def _check_static_defaults(self, dec, fndef):
        if not isinstance(dec, ast.Call):
            return
        for kw in dec.keywords:
            if kw.arg in ("static_argnames", "static_argnums"):
                self.static_mutable.append((kw, fndef.name, dec))

    def finalize(self):
        """Resolve name-based marks to def nodes, and mark the functions
        a captured ``with`` block calls."""
        for blk in self.traced_blocks:
            for n in ast.walk(blk):
                if isinstance(n, ast.Call):
                    callee = None
                    if isinstance(n.func, ast.Name):
                        callee = n.func.id
                    elif isinstance(n.func, ast.Attribute) \
                            and isinstance(n.func.value, ast.Name) \
                            and n.func.value.id == "self":
                        callee = n.func.attr
                    if callee is not None:
                        self.traced.add(("name", callee))
        for item in list(self.traced):
            if isinstance(item, tuple):
                self.traced.discard(item)
                for d in self.defs.get(item[1], []):
                    self.traced.add(id(d))


def _propagate_traced(index):
    """Transitive closure WITHIN the module: a function called (as
    `f(...)` or `self.f(...)`) from a captured function also runs under
    that capture. Cross-module calls are invisible — the linter is
    per-file by design (each module's own traced surface is checked
    where it is defined)."""
    id2def = {}
    for defs in index.defs.values():
        for d in defs:
            id2def[id(d)] = d
    changed = True
    while changed:
        changed = False
        for did in list(index.traced):
            d = id2def.get(did)
            if d is None:
                continue
            for n in ast.walk(d):
                if not isinstance(n, ast.Call):
                    continue
                callee = None
                if isinstance(n.func, ast.Name):
                    callee = n.func.id
                elif isinstance(n.func, ast.Attribute) \
                        and isinstance(n.func.value, ast.Name) \
                        and n.func.value.id == "self":
                    callee = n.func.attr
                if callee is None:
                    continue
                for cd in index.defs.get(callee, []):
                    if id(cd) not in index.traced \
                            and id(cd) not in index.callback_fns:
                        index.traced.add(id(cd))
                        changed = True


def _static_names(kw_node, fndef):
    """Param names referenced by a static_argnames/static_argnums kw."""
    val = kw_node.value
    names = []
    consts = []
    for n in ast.walk(val):
        if isinstance(n, ast.Constant):
            consts.append(n.value)
    params = [a.arg for a in fndef.args.args]
    for c in consts:
        if isinstance(c, str) and c in params:
            names.append(c)
        elif isinstance(c, int) and 0 <= c < len(params):
            names.append(params[c])
    return names


class _TracedBodyChecker(ast.NodeVisitor):
    """Second pass: walk ONE captured function body flagging
    impurities."""

    def __init__(self, index, path, out):
        self.ix = index
        self.path = path
        self.out = out
        self.local_names = set()

    def run_block(self, stmts, scope):
        """Check the body of a ``with torch.cuda.graph(...)`` block; the
        names bound in its enclosing `scope` are step values."""
        for st in (scope.body if hasattr(scope, "body")
                   and isinstance(scope.body, list) else []):
            self._collect_locals(st)
        if hasattr(scope, "args"):
            a = scope.args
            for arg in list(a.args) + list(a.posonlyargs) \
                    + list(a.kwonlyargs):
                self.local_names.add(arg.arg)
        for st in stmts:
            self.visit(st)

    def run(self, fn):
        a = fn.args
        for arg in list(a.args) + list(a.posonlyargs) + list(a.kwonlyargs):
            self.local_names.add(arg.arg)
        if a.vararg:
            self.local_names.add(a.vararg.arg)
        if a.kwarg:
            self.local_names.add(a.kwarg.arg)
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        for st in body:
            self._collect_locals(st)
        for st in body:
            self.visit(st)

    def _collect_locals(self, node):
        for n in ast.walk(node):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.local_names.add(n.name)
            elif isinstance(n, ast.arg):
                # params of nested defs/lambdas are locals of the region
                self.local_names.add(n.arg)
            elif isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                self.local_names.add(n.id)
            elif isinstance(n, (ast.comprehension,)):
                for t in ast.walk(n.target):
                    if isinstance(t, ast.Name):
                        self.local_names.add(t.id)

    def _flag(self, node, code, msg):
        self.out.append(Violation(self.path, node.lineno, node.col_offset,
                                  code, msg))

    def _touches_local(self, expr):
        """True when the expression reads any name bound inside the
        captured function — i.e. it can be a device value. Closed-over
        names are static Python config at capture: float(closure) is
        legal and common, float(local_tensor) is the bug."""
        for n in ast.walk(expr):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                    and n.id in self.local_names:
                return True
        return False

    # -- statements -----------------------------------------------------
    def visit_Global(self, node):
        self._flag(node, "PUR04",
                   f"`global {', '.join(node.names)}` inside a captured "
                   "step: the write happens once at capture, not per "
                   "replay")

    def visit_Nonlocal(self, node):
        self._flag(node, "PUR04",
                   f"`nonlocal {', '.join(node.names)}` inside a "
                   "captured step: a capture-time-only mutation")

    def _check_target(self, tgt):
        root = _root_name(tgt)
        if isinstance(tgt, ast.Attribute) and root == "self":
            self._flag(tgt, "PUR04",
                       f"writes self.{tgt.attr} in a captured step: the "
                       "object mutates at capture only, never on a "
                       "replay; return the value or write a device "
                       "tensor in place")
        elif isinstance(tgt, (ast.Attribute, ast.Subscript)) \
                and root is not None and root not in self.local_names:
            self._flag(tgt, "PUR04",
                       f"mutates closed-over '{root}' in a captured step "
                       "(a capture-time-only side effect)")

    def visit_Assign(self, node):
        for t in node.targets:
            self._check_target(t)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        self._check_target(node.target)
        self.generic_visit(node)

    def visit_FunctionDef(self, node):
        # nested defs run under the same capture
        if id(node) in self.ix.callback_fns:
            return
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    # -- calls ----------------------------------------------------------
    def visit_Call(self, node):
        chain = _attr_chain(node.func) or []

        if isinstance(node.func, ast.Name) and node.func.id == "print":
            self._flag(node, "PUR01",
                       "print() in a captured step runs once, at capture; "
                       "replays print nothing")
        elif isinstance(node.func, ast.Name) \
                and node.func.id in ("float", "int", "bool") \
                and len(node.args) == 1 \
                and not isinstance(node.args[0], ast.Constant) \
                and self._touches_local(node.args[0]):
            self._flag(node, "PUR02",
                       f"{node.func.id}(...) on a step value reads it back "
                       "to the host: a capture refuses it (and an eager "
                       "step stalls on it); keep it a 0-d tensor or hoist "
                       "it out of the step")
        elif isinstance(node.func, ast.Attribute) \
                and node.func.attr in _HOST_READS and not node.args \
                and self._touches_local(node.func.value):
            self._flag(node, "PUR02",
                       f".{node.func.attr}() on a step value is a host "
                       "read: a capture refuses it")
        elif len(chain) >= 2 and chain[-1] == "synchronize" \
                and chain[-2] == "cuda":
            self._flag(node, "PUR02",
                       f"{'.'.join(chain)}() in a captured step: a host "
                       "sync the capture refuses")
        elif chain and chain[0] in self.ix.numpy_random_aliases \
                and len(chain) >= 2:
            self._flag(node, "PUR03",
                       f"{'.'.join(chain)} in a captured step is drawn ONCE "
                       "at capture and replayed as a constant; draw from "
                       "a device generator the graph registers")
        elif chain and chain[0] in self.ix.numpy_aliases:
            if len(chain) >= 2 and chain[1] == "random":
                self._flag(node, "PUR03",
                           f"{'.'.join(chain)} in a captured step is drawn "
                           "ONCE at capture and replayed as a constant; "
                           "draw from a device generator the graph "
                           "registers")
            elif chain[-1] in ("asarray", "array", "frombuffer") \
                    and any(self._touches_local(a) for a in node.args):
                self._flag(node, "PUR02",
                           f"{'.'.join(chain)}(...) on a step value is a "
                           "host read: a capture refuses it")
        elif chain and chain[0] in self.ix.stdlib_random_aliases \
                and len(chain) >= 2:
            self._flag(node, "PUR03",
                       f"{'.'.join(chain)} in a captured step: host RNG "
                       "drawn once at capture")
        elif isinstance(node.func, ast.Attribute) \
                and node.func.attr in _MUTATORS:
            root = _root_name(node.func.value)
            if root is not None and root not in self.local_names \
                    and root != "self":
                self._flag(node, "PUR04",
                           f"{root}.{node.func.attr}(...) mutates "
                           "closed-over state in a captured step (once, "
                           "at capture)")
        self.generic_visit(node)


def _check_static_args(index, path, out):
    """PUR05: static capture args whose function-side default is a
    mutable (unhashable) literal."""
    for kw, target_name, site in index.static_mutable:
        for fndef in index.defs.get(target_name, []):
            names = _static_names(kw, fndef)
            args = fndef.args
            defaults = dict(zip([a.arg for a in args.args][-len(args.defaults):]
                                if args.defaults else [], args.defaults))
            defaults.update({a.arg: d for a, d in
                             zip(args.kwonlyargs, args.kw_defaults) if d})
            for n in names:
                d = defaults.get(n)
                if isinstance(d, (ast.List, ast.Dict, ast.Set)):
                    out.append(Violation(
                        path, d.lineno, d.col_offset, "PUR05",
                        f"static argument '{n}' of {fndef.name}() "
                        f"defaults to a {type(d).__name__.lower()} "
                        "literal: unhashable, so the guard lookup "
                        "raises at call time; use a tuple/frozenset or "
                        "None"))


def lint_source(source, path="<string>"):
    """Lint one Python source string. Returns [Violation]."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Violation(path, e.lineno or 0, 0, "LNT00",
                          f"file does not parse: {e.msg}")]
    index = _ModuleIndex()
    index.visit(tree)
    index.finalize()
    _propagate_traced(index)

    out = []
    seen_fn = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and id(node) in index.traced:
            if id(node) in seen_fn or id(node) in index.callback_fns:
                continue
            seen_fn.add(id(node))
            _TracedBodyChecker(index, path, out).run(node)
    for blk in index.traced_blocks:
        _TracedBodyChecker(index, path, out).run_block(
            blk.body, _enclosing(tree, blk))
    _check_static_args(index, path, out)

    # apply per-line suppressions
    lines = source.splitlines()
    deduped = {}
    for v in out:
        line = lines[v.line - 1] if 0 < v.line <= len(lines) else ""
        m = _SUPPRESS_RE.search(line)
        if m:
            codes = {c.strip() for c in m.group("codes").split(",")}
            if "*" in codes or v.code in codes:
                v.suppressed = True
        deduped.setdefault((v.line, v.col, v.code), v)
    return sorted(deduped.values(), key=lambda v: (v.line, v.col, v.code))


def _enclosing(tree, node):
    """The innermost function def holding `node` (else the module)."""
    best = tree
    for n in ast.walk(tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and any(c is node for c in ast.walk(n)):
            if best is tree or any(c is n for c in ast.walk(best)):
                best = n
    return best


def iter_py_files(paths):
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = [d for d in dirs
                           if d not in ("__pycache__", ".git", "build")]
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)
        elif p.endswith(".py"):
            yield p


def lint_paths(paths):
    """Lint files/directories. Returns a Report (violations become
    PUR* diagnostics; suppressed ones are carried but don't fail)."""
    report = Report(subject="purity")
    for path in iter_py_files(paths):
        try:
            with open(path, "r", encoding="utf-8") as fh:
                src = fh.read()
        except OSError as e:
            report.add("LNT00", ERROR, path, f"unreadable: {e}")
            continue
        for v in lint_source(src, path):
            report.add(v.code, ERROR, f"{v.path}:{v.line}:{v.col}",
                       v.message, suppressed=v.suppressed)
    return report
