"""Failure-path lint + seam-coverage proof (reference:
``deeplearning4j_tpu/analysis/faults.py``, whose codes, rules and
suppressions this copies, over the port's threaded tier and its
``runtime/chaos.py`` inventory).

The serving tier is hardened with deterministic fault injection
(``runtime/chaos.py`` seams) and fleet failure domains, but nothing
*verifies* those guarantees as the code grows: a new dispatch boundary
can ship without a ``fault_point()`` seam, a broad ``except`` can
swallow an error class the breaker/metrics never see, and an unbounded
blocking call can defeat the deadline contract. This pass lints the
failure-handling *discipline* the way the thread pass lints the locking
discipline: pure AST, no imports of the linted code, no execution,
per-file — plus a runtime twin (``seam_coverage``) that proves every
registered seam actually fires under a soak, gated like line coverage.

Scope: the same ``THREADED_TIER`` the thread pass lints (serving/ +
runtime/chaos+telemetry+aot+autotune+resilience+async_iterator +
parallel/inference + util/httpserve+profiler).

Codes (stable; suppressions and tests key on them):

- FLT01  swallowed exception: a broad handler (bare ``except``,
         ``except Exception``/``BaseException``) that neither
         re-raises, uses the caught exception (classify/store/fail a
         request with it), increments a telemetry instrument
         (``.inc``/``.observe``/``.set``), nor bumps a stats counter
         (``stats[...] += 1``) — the error class vanishes and the
         breaker/metrics never see it.
- FLT02  dispatch boundary with no reachable chaos seam: a spawned
         thread target (``Thread(target=...)``), an HTTP handler
         (``handle_GET``/``handle_POST`` — the repo convention, see
         util/httpserve.py), or a function doing disk I/O
         (``open(...)``, or ``os.fdopen(...)``: the atomic write's
         open, which the port adds to the reference's rule) from which no ``fault_point()`` call is
         reachable through same-class/same-module calls. The
         micro-batcher/scheduler queue-dispatch loops are covered as
         spawned-thread targets. A boundary without a seam is a
         failure path the chaos soak can never exercise.
- FLT03  unbounded blocking call: ``.wait()``/``.join()``/``.get()``/
         ``.acquire()``/``.recv()``/``.accept()`` with no argument and
         no ``timeout=`` — one wedged peer and the caller blocks
         forever, defeating the serving deadline contract.
- FLT04  ``fault_point()`` reachable while a lock is held (lexically,
         or via a one-level same-class call): a ``wedge``/``slow``
         fault injected there becomes a deadlock-under-lock, so a
         chaos run would report a hang the production code does not
         have (or worse, mask one it does).
- FLT05  retry/poll loop with no bound or backoff: ``sleep(0)`` inside
         a loop (a busy spin burning a core), or ``while True`` with a
         broad swallow-and-continue handler and no sleep/wait in the
         body (a hot retry loop with no budget).
- FLT06  seam-name integrity: a ``fault_point("name")`` literal that
         is not a registered seam (a typo'd seam silently never
         fires), or — over the full default tier — a registered seam
         no linted code invokes (dead inventory). The universe is
         ``chaos.registered_seams()`` plus every
         ``register_seam("name")`` literal found statically in the
         linted sources (runtime registration must not depend on
         import order).

Suppression mirrors the thread pass, with its own tag::

    except Exception:  # fault-ok[FLT01]: probe outcome is counted below

The code list may be comma-separated or ``*``; the justification text
is REQUIRED — a bare tag does not suppress.

The runtime twin: ``seam_coverage(run)`` arms a counting plan (a
duck-typed ``_fire`` that injects nothing), calls ``run()``, and
returns per-seam fire counts for every registered seam —
``coverage_gaps`` lists the seams that never fired. The tests gate
every seam of ``chaos.registered_seams()`` firing under a soak: fault
*injection* coverage, proved, not assumed.

Limits: per-file and name-based like every AST pass here. Reachability
follows ``self.m()`` within the class and bare-name calls within the
module (longest-lexical-scope match); cross-class and cross-module
calls are invisible, as are seams invoked through a variable seam
name. ``Thread(target=obj.attr.method)`` targets reached through
another object are skipped. The audit obligation is inverted
accordingly: the tier must lint clean in the self-check tests, so
every finding is either fixed or carries a reasoned ``fault-ok``.
"""

from __future__ import annotations

import ast
import os
import re
import threading

from deeplearning4j_tpu_torch.analysis.diagnostics import ERROR, Report
from deeplearning4j_tpu_torch.analysis.purity import iter_py_files
from deeplearning4j_tpu_torch.analysis.threads import (
    _THREAD_FACTORIES, _call_root_name, _dotted, _Finding,
    _is_lock_factory, _self_attr, threaded_tier_paths,
)

__all__ = ["lint_fault_source", "lint_fault_paths", "seam_coverage",
           "coverage_gaps"]

_SUPPRESS_RE = re.compile(
    r"#\s*fault-ok\[(?P<codes>[A-Z0-9*,\s]+)\]\s*[:—-]\s*(?P<why>\S.*)")

_BROAD_EXC = {"Exception", "BaseException"}

#: receiver-method names that classify/count an error when called
#: inside a broad handler (telemetry instruments; Event.set counts —
#: signalling a waiter IS surfacing the failure)
_TELEMETRY_ATTRS = {"inc", "observe", "set"}

#: the repo's HTTP-handler convention (util/httpserve.py JsonHandler:
#: subclasses implement handle_GET/handle_POST; do_* is the scaffold)
_HTTP_HANDLERS = {"handle_GET", "handle_POST"}

#: receiver-method names that block forever when called with no
#: argument and no timeout= — unambiguous by name; ``get`` is only
#: blocking on a queue.Queue receiver and is gated on the module's
#: known queue attributes (see _lint_tree)
_BLOCKING_NAMES = {"wait", "join", "acquire", "recv", "accept"}


def _seam_call_name(node):
    """'fault_point'-style callee name when node is a seam invocation
    (``fault_point(...)``, ``chaos.fault_point(...)``, or an aliased
    import ``_chaos_fault_point(...)``), else None."""
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    name = f.attr if isinstance(f, ast.Attribute) else (
        f.id if isinstance(f, ast.Name) else None)
    if name is not None and name.endswith("fault_point"):
        return name
    return None


def _seam_literal(node):
    """The seam-name string literal of a seam call, or None."""
    if node.args and isinstance(node.args[0], ast.Constant) \
            and isinstance(node.args[0].value, str):
        return node.args[0].value
    return None


def _is_broad_handler(h):
    t = h.type
    if t is None:
        return True          # bare except
    elts = t.elts if isinstance(t, ast.Tuple) else [t]
    for e in elts:
        d = _dotted(e)
        if d and d.split(".")[-1] in _BROAD_EXC:
            return True
    return False


def _handler_classifies(h):
    """True when the broad handler's body re-raises, uses the caught
    exception, touches a telemetry instrument, or bumps a stats
    subscript — i.e. the error class is NOT silently swallowed."""
    for n in ast.walk(h):
        if isinstance(n, ast.Raise):
            return True
        if isinstance(n, ast.Call):
            f = n.func
            if isinstance(f, ast.Attribute) \
                    and f.attr in _TELEMETRY_ATTRS:
                return True
        if h.name and isinstance(n, ast.Name) and n.id == h.name \
                and isinstance(n.ctx, ast.Load):
            return True
        if isinstance(n, ast.AugAssign) \
                and isinstance(n.target, ast.Subscript):
            return True      # self.stats["corrupt"] += 1 and kin
    return False


class _Fn:
    """One function/method/nested def and its own-body facts (nested
    defs are separate _Fn entries; their bodies are excluded here)."""

    __slots__ = ("node", "name", "scope", "cls", "calls", "self_calls",
                 "seams", "spawns", "opens", "blocking")

    def __init__(self, node, scope, cls):
        self.node = node
        self.name = node.name
        self.scope = scope          # tuple of enclosing scope names
        self.cls = cls              # immediate enclosing class, or None
        self.calls = set()          # bare names called
        self.self_calls = set()     # self.X() attrs called
        self.seams = []             # [(literal-or-None, call node)]
        self.spawns = []            # [(kind, name, call node)]
        self.opens = []             # open(...) call nodes
        self.blocking = []          # [(label, call node)]

    @property
    def has_seam(self):
        return bool(self.seams)


class _OwnBody(ast.NodeVisitor):
    """Walk one function's body WITHOUT descending into nested defs
    (they are their own _Fn); record calls, seams, spawns, blocking."""

    def __init__(self, fn):
        self.fn = fn
        self._depth = 0

    def visit_FunctionDef(self, node):
        if self._depth == 0 and node is self.fn.node:
            self._depth += 1
            self.generic_visit(node)
            self._depth -= 1
        # nested def: skip (indexed separately)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        # a lambda body still runs in this function's failure context
        self.generic_visit(node)

    def visit_Call(self, node):
        fn = self.fn
        if _seam_call_name(node) is not None:
            fn.seams.append((_seam_literal(node), node))
        f = node.func
        if isinstance(f, ast.Name):
            fn.calls.add(f.id)
            if f.id == "open":
                fn.opens.append(node)
        elif isinstance(f, ast.Attribute):
            a = _self_attr(f)
            if a is not None:
                fn.self_calls.add(a)
            if f.attr == "fdopen":
                # os.fdopen(fd, "w"): the atomic-write idiom's open
                fn.opens.append(node)
        root = _call_root_name(f)
        if root in _THREAD_FACTORIES:
            for kw in node.keywords:
                if kw.arg == "target":
                    v = kw.value
                    if isinstance(v, ast.Name):
                        fn.spawns.append(("name", v.id, node))
                    else:
                        a = _self_attr(v)
                        if a is not None:
                            fn.spawns.append(("method", a, node))
        if isinstance(f, ast.Attribute) and not node.args \
                and not any(kw.arg in ("timeout", "block")
                            for kw in node.keywords):
            label = f"{_dotted(f) or f.attr}()"
            if f.attr in _BLOCKING_NAMES:
                fn.blocking.append((label, node, None))
            elif f.attr == "get":
                # blocking only on a queue.Queue receiver: resolved
                # against the module's known queue attrs in _lint_tree
                qattr = _self_attr(f.value)
                if qattr is not None:
                    fn.blocking.append((label, node, qattr))
        self.generic_visit(node)


class _Indexer(ast.NodeVisitor):
    """Index every function in the module with its lexical scope."""

    def __init__(self):
        self.fns = []
        self.by_name = {}           # bare name -> [_Fn]
        self.classes = {}           # class name -> {method -> _Fn}
        self._scope = []            # scope-name stack
        self._cls = []              # (classname, depth) stack

    def visit_ClassDef(self, node):
        self._scope.append(node.name)
        self._cls.append((node.name, len(self._scope)))
        self.generic_visit(node)
        self._cls.pop()
        self._scope.pop()

    def visit_FunctionDef(self, node):
        cls = None
        if self._cls and self._cls[-1][1] == len(self._scope):
            cls = self._cls[-1][0]   # immediate parent is a class body
        fn = _Fn(node, tuple(self._scope), cls)
        _OwnBody(fn).visit(node)
        self.fns.append(fn)
        self.by_name.setdefault(fn.name, []).append(fn)
        if cls is not None:
            self.classes.setdefault(cls, {})[fn.name] = fn
        self._scope.append(node.name)
        self.generic_visit(node)
        self._scope.pop()

    visit_AsyncFunctionDef = visit_FunctionDef


def _resolve(name, from_scope, by_name):
    """The _Fn named `name` with the longest common lexical-scope
    prefix with `from_scope`, or None."""
    best, best_len = None, -1
    for cand in by_name.get(name, ()):
        n = 0
        for a, b in zip(cand.scope, from_scope):
            if a != b:
                break
            n += 1
        if n > best_len:
            best, best_len = cand, n
    return best


def _reaches_seam(start, idx):
    """True when a fault_point call is reachable from `start` through
    same-class self.m() calls and same-module bare-name calls."""
    seen, todo = set(), [start]
    while todo:
        fn = todo.pop()
        if id(fn) in seen:
            continue
        seen.add(id(fn))
        if fn.has_seam:
            return True
        if fn.cls:
            methods = idx.classes.get(fn.cls, {})
            for m in fn.self_calls:
                if m in methods:
                    todo.append(methods[m])
        for g in fn.calls:
            cand = _resolve(g, fn.scope + (fn.name,), idx.by_name)
            if cand is not None:
                todo.append(cand)
    return False


class _LockSeamWalker(ast.NodeVisitor):
    """FLT04: fault_point (direct, or via a one-level same-class call
    to a seam-bearing method) while a lock is lexically held."""

    def __init__(self, cls_name, lock_attrs, module_locks, methods,
                 findings):
        self.cls_name = cls_name
        self.lock_attrs = lock_attrs
        self.module_locks = module_locks
        self.methods = methods      # method name -> _Fn (same class)
        self.findings = findings
        self.lock_stack = []

    def _lock_key(self, expr):
        a = _self_attr(expr)
        if a is not None and a in self.lock_attrs:
            return f"{self.cls_name}.{a}"
        if isinstance(expr, ast.Name) and expr.id in self.module_locks:
            return f"<module>.{expr.id}"
        return None

    def visit_FunctionDef(self, node):
        return  # a nested def's body does not run under this lock

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_With(self, node):
        keys = []
        for item in node.items:
            k = self._lock_key(item.context_expr)
            if k is None:
                self.visit(item.context_expr)
            else:
                keys.append(k)
                self.lock_stack.append(k)
        for st in node.body:
            self.visit(st)
        for _ in keys:
            self.lock_stack.pop()

    visit_AsyncWith = visit_With

    def visit_Call(self, node):
        if self.lock_stack:
            held = self.lock_stack[-1]
            if _seam_call_name(node) is not None:
                self.findings.append(_Finding(
                    node.lineno, node.col_offset, "FLT04",
                    f"fault_point fires while {held} is held: a "
                    "wedge/slow rule injected here blocks WITH the "
                    "lock, turning a survivable slow fault into a "
                    "deadlock every other thread piles up behind",
                    hint="move the seam outside the critical section, "
                         "or suppress with the reason the lock is "
                         "this seam's own serialization contract"))
            else:
                callee = _self_attr(node.func)
                target = self.methods.get(callee) \
                    if callee is not None else None
                if target is not None and target.has_seam:
                    self.findings.append(_Finding(
                        node.lineno, node.col_offset, "FLT04",
                        f"self.{callee}() contains a fault_point and "
                        f"is called while {held} is held: a wedge/"
                        "slow rule injected there blocks with the "
                        "lock held",
                        hint="move the seam (or the call) outside the "
                             "critical section, or suppress with the "
                             "reason the lock is the seam's own "
                             "serialization contract"))
        self.generic_visit(node)


def _module_locks(tree):
    out = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and _is_lock_factory(node.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


def _class_lock_attrs(cls_node):
    """self.X / class-level X lock attributes of one class."""
    out = set()
    for node in ast.walk(cls_node):
        if not isinstance(node, ast.Assign) \
                or not _is_lock_factory(node.value):
            continue
        for t in node.targets:
            a = _self_attr(t)
            if a is not None:
                out.add(a)
            elif isinstance(t, ast.Name):
                out.add(t.id)
    return out


def _check_spin_loops(tree, findings):
    """FLT05 over every loop in the module."""
    for loop in ast.walk(tree):
        if not isinstance(loop, (ast.While, ast.For)):
            continue
        has_pause = False
        for n in ast.walk(loop):
            if not isinstance(n, ast.Call):
                continue
            name = _call_root_name(n.func)
            if name == "sleep" and len(n.args) == 1 \
                    and isinstance(n.args[0], ast.Constant) \
                    and n.args[0].value == 0:
                findings.append(_Finding(
                    n.lineno, n.col_offset, "FLT05",
                    "sleep(0) inside a loop is a busy spin: the "
                    "poll has no bound and no backoff, burning a "
                    "core while it waits",
                    hint="wait on a Condition/Event with a bounded "
                         "timeout (injectable-clock friendly) so "
                         "completion wakes the loop instead of the "
                         "scheduler"))
            elif name in ("sleep", "wait") and (
                    n.args or any(kw.arg == "timeout"
                                  for kw in n.keywords)):
                has_pause = True
        if isinstance(loop, ast.While) \
                and isinstance(loop.test, ast.Constant) \
                and loop.test.value is True and not has_pause:
            for n in ast.walk(loop):
                if isinstance(n, ast.ExceptHandler) \
                        and _is_broad_handler(n) \
                        and all(isinstance(s, (ast.Pass, ast.Continue))
                                for s in n.body):
                    findings.append(_Finding(
                        loop.lineno, loop.col_offset, "FLT05",
                        "unbounded retry: `while True` swallows every "
                        "exception and retries with no sleep, wait, "
                        "bound or backoff — a persistent failure "
                        "becomes a hot loop",
                        hint="add a retry budget/backoff (see "
                             "runtime.resilience.RetryPolicy) or a "
                             "bounded wait between attempts"))
                    break


def _lint_tree(tree, findings):
    """All single-file checks; returns the set of seam literals used
    (for the cross-file FLT06 dead-seam check)."""
    idx = _Indexer()
    idx.visit(tree)

    # FLT01: swallowed broad handlers
    for n in ast.walk(tree):
        if isinstance(n, ast.ExceptHandler) and _is_broad_handler(n) \
                and not _handler_classifies(n):
            findings.append(_Finding(
                n.lineno, n.col_offset, "FLT01",
                "broad except swallows the error class: nothing "
                "re-raises, stores/uses the caught exception, or "
                "counts it — the breaker, metrics and logs never "
                "learn this failure happened",
                hint="narrow the except, classify the error (fail "
                     "the request with it / store it / count it into "
                     "a labeled instrument), or suppress with the "
                     "reason the outcome is recorded elsewhere"))

    # FLT02: dispatch boundaries that no seam can reach
    flagged = set()

    def _flag_boundary(fn, what):
        key = (fn.node.lineno, id(fn))
        if key in flagged:
            return
        flagged.add(key)
        findings.append(_Finding(
            fn.node.lineno, fn.node.col_offset, "FLT02",
            f"{what} `{fn.name}` has no reachable fault_point(): "
            "this dispatch boundary's failure path can never be "
            "exercised by a ChaosPlan, so its error handling is "
            "untestable-by-injection",
            hint="wire a fault_point(<seam>) at the boundary (see "
                 "runtime/chaos.py seam inventory + register_seam), "
                 "or suppress with the reason faults are injected at "
                 "a covering seam"))

    for fn in idx.fns:
        for kind, name, call in fn.spawns:
            if kind == "method":
                target = idx.classes.get(fn.cls, {}).get(name) \
                    if fn.cls else None
            else:
                target = _resolve(name, fn.scope + (fn.name,),
                                  idx.by_name)
            if target is not None and not _reaches_seam(target, idx):
                _flag_boundary(target, "thread target")
        if fn.cls and fn.name in _HTTP_HANDLERS \
                and not _reaches_seam(fn, idx):
            _flag_boundary(fn, "HTTP handler")
        if fn.opens and not _reaches_seam(fn, idx):
            for call in fn.opens:
                findings.append(_Finding(
                    call.lineno, call.col_offset, "FLT02",
                    f"disk I/O in `{fn.name}` has no reachable "
                    "fault_point(): this read/write failure path can "
                    "never be exercised by a ChaosPlan",
                    hint="wire a fault_point(<seam>) around the I/O "
                         "(aot.disk_read-style), or suppress with "
                         "the reason the persistence is best-effort "
                         "and failure-tolerant by design"))

    # FLT03: unbounded blocking calls (`get` only on known queue attrs)
    queue_attrs = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call) \
                and _call_root_name(n.value.func) in (
                    "Queue", "LifoQueue", "PriorityQueue", "SimpleQueue"):
            for t in n.targets:
                a = _self_attr(t)
                if a is not None:
                    queue_attrs.add(a)
    for fn in idx.fns:
        for label, node, qattr in fn.blocking:
            if qattr is not None and qattr not in queue_attrs:
                continue
            findings.append(_Finding(
                node.lineno, node.col_offset, "FLT03",
                f"unbounded blocking call {label}: no timeout means "
                "one wedged peer blocks this caller forever — the "
                "deadline contract cannot release it",
                hint="pass a timeout and re-check state in a loop "
                     "(bounded wait), so a dead owner is detected "
                     "instead of awaited"))

    # FLT04: seams under held locks
    mod_locks = _module_locks(tree)
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        lock_attrs = _class_lock_attrs(node)
        if not lock_attrs and not mod_locks:
            continue
        methods = idx.classes.get(node.name, {})
        walker = _LockSeamWalker(node.name, lock_attrs, mod_locks,
                                 methods, findings)
        for m in node.body:
            if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for st in m.body:
                    walker.visit(st)

    # FLT05
    _check_spin_loops(tree, findings)

    return idx


def _known_seams(seams=None):
    if seams is not None:
        return frozenset(seams)
    from deeplearning4j_tpu_torch.runtime import chaos

    return frozenset(chaos.registered_seams())


def _declared_seams(tree):
    """Seam literals registered via ``register_seam("name")`` in this
    tree — discovered statically, so the FLT06 universe never depends
    on which modules the current process happened to import before
    linting."""
    out = set()
    for n in ast.walk(tree):
        if not isinstance(n, ast.Call):
            continue
        f = n.func
        name = f.id if isinstance(f, ast.Name) else (
            f.attr if isinstance(f, ast.Attribute) else None)
        if name == "register_seam":
            lit = _seam_literal(n)
            if lit is not None:
                out.add(lit)
    return out


def _lint_source(source, path, seams):
    report = Report(subject=f"faults:{path}")
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        report.add("LNT00", ERROR, f"{path}:{e.lineno or 0}",
                   f"file does not parse: {e.msg}")
        return report, set()

    seams = frozenset(seams) | _declared_seams(tree)
    findings = []
    idx = _lint_tree(tree, findings)

    # FLT06a: typo'd seam literals
    used = set()
    for fn in idx.fns:
        for literal, node in fn.seams:
            if literal is None:
                continue
            used.add(literal)
            if literal not in seams:
                findings.append(_Finding(
                    node.lineno, node.col_offset, "FLT06",
                    f"fault_point({literal!r}) is not a registered "
                    "seam: a ChaosPlan scheduling the intended name "
                    "would silently never fire here",
                    hint="register it (chaos.register_seam) or fix "
                         "the literal to match chaos.SEAMS"))

    lines = source.splitlines()
    seen = set()
    for f in sorted(findings, key=lambda f: (f.line, f.col, f.code)):
        if (f.line, f.col, f.code) in seen:
            continue
        seen.add((f.line, f.col, f.code))
        text = lines[f.line - 1] if 0 < f.line <= len(lines) else ""
        suppressed = False
        m = _SUPPRESS_RE.search(text)
        if m:
            codes = {c.strip() for c in m.group("codes").split(",")}
            suppressed = "*" in codes or f.code in codes
        report.add(f.code, ERROR, f"{path}:{f.line}:{f.col}", f.message,
                   hint=f.hint, suppressed=suppressed)
    return report, used


def lint_fault_source(source, path="<string>", seams=None):
    """FLT01-06 over one source string -> Report (suppressed findings
    carried but non-failing, pass-7/8 style). `seams` is the seam
    universe for FLT06 (default: ``chaos.registered_seams()``)."""
    report, _ = _lint_source(source, path, _known_seams(seams))
    return report


def lint_fault_paths(paths=None, seams=None):
    """FLT01-06 over files/directories (default: the package's
    threaded tier) -> merged Report. When linting the full default
    tier, also runs the FLT06 dead-seam check: every registered seam
    must be invoked by some linted fault_point literal."""
    full_tier = paths is None
    universe = _known_seams(seams)
    report = Report(subject="faults")
    used = set()
    sources = []
    for path in iter_py_files(paths if paths is not None
                              else threaded_tier_paths()):
        try:
            with open(path, "r", encoding="utf-8") as fh:
                sources.append((path, fh.read()))
        except OSError as e:
            report.add("LNT00", ERROR, path, f"unreadable: {e}")
    # first pass: a seam register_seam()-ed in one linted file is a
    # valid target for fault_point literals in every other
    for path, src in sources:
        try:
            universe |= _declared_seams(ast.parse(src, filename=path))
        except SyntaxError:
            pass                     # LNT00 from _lint_source below
    for path, src in sources:
        rep, file_used = _lint_source(src, path, universe)
        used |= file_used
        report.extend(rep)
    if full_tier or seams is not None:
        for dead in sorted(universe - used):
            report.add(
                "FLT06", ERROR, f"chaos.SEAMS:{dead}",
                f"registered seam {dead!r} is invoked by no linted "
                "fault_point call: dead inventory a ChaosPlan can arm "
                "but never fire",
                hint="wire the seam at its dispatch boundary or "
                     "remove it from the registry")
    return report


# ----------------------------------------------------------------------
# the runtime twin: seam-coverage proof
# ----------------------------------------------------------------------
class _CoveragePlan:
    """Duck-typed counting plan: ``fault_point`` calls ``_fire`` on
    every armed invocation; this one injects nothing and counts every
    seam it sees. ``_rules`` is empty so arm-time validation passes."""

    def __init__(self):
        self._rules = {}
        self._lock = threading.Lock()
        self.counts = {}

    def _fire(self, seam, payload):
        with self._lock:
            self.counts[seam] = self.counts.get(seam, 0) + 1
        return payload


def seam_coverage(run, seams=None):
    """Arm a counting plan, call ``run()``, and return
    ``{seam: fire count}`` over every registered seam (zeros
    included) — fault-injection coverage, measured like line coverage.
    Any previously armed plan is restored afterwards."""
    from deeplearning4j_tpu_torch.runtime import chaos

    names = tuple(seams) if seams is not None \
        else chaos.registered_seams()
    plan = _CoveragePlan()
    prev = chaos.disarm()
    chaos.arm(plan)
    try:
        run()
    finally:
        chaos.disarm()
        if prev is not None:
            chaos.arm(prev)
    return {s: plan.counts.get(s, 0) for s in names}


def coverage_gaps(counts):
    """Seams whose fire count is zero — the gate asserts this is
    empty."""
    return sorted(s for s, n in counts.items() if not n)
