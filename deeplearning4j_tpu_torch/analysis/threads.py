"""Host-side thread-safety lint (reference:
``deeplearning4j_tpu/analysis/threads.py``, whose codes, scope rules and
suppressions this copies, over the port's threaded tier).

The serving/runtime tier is thread-heavy by design (handler threads,
the micro-batcher scheduler, warmup/staging threads), and the two
concurrency bugs the reference met — a profiler's defaultdicts racing
serving threads and a duplicate-batcher lazy-init race — are both
statically visible shapes. This AST pass lints the concurrency
*discipline* the same way purity is linted: no imports, no execution,
per-file.

Scope: a class is analyzed when it participates in concurrency —
it spawns threads (``threading.Thread``/``ThreadingHTTPServer``),
owns a lock attribute (``self._lock = threading.Lock()`` or a
class-level lock), or its docstring declares it thread-safe.

Codes (stable; suppressions and tests key on them):

- THR01  an attribute that is WRITTEN under ``with self._lock`` in one
         method (=> the class treats it as lock-guarded) is read or
         written outside any lock elsewhere — the racing-defaultdict
         shape. Methods named ``*_locked`` are the documented
         called-with-the-lock-held convention and are exempt, as is
         ``__init__`` (construction happens-before publication).
- THR02  lock-order inversion: the acquired-while-held graph (lock A
         held while taking lock B, via lexical nesting or a one-level
         same-class method call) contains a cycle — the classic ABBA
         deadlock. Reentrant self-edges (RLock) are not cycles.
- THR03  a blocking call under a held lock: sleep, thread join,
         ``queue.Queue`` get/put, ``.wait()`` on anything that is not
         the held lock/condition itself (a condition wait RELEASES its
         lock and is the correct pattern), and the device round trips:
         ``torch.cuda.synchronize()``, ``Event.synchronize()``,
         ``.item()``, ``.cpu()``, ``.tolist()``, a graph's ``replay()``,
         a ``CapturedStep`` call (``self._captured(...)``,
         ``self._capture(...)``, ``self._step_capture(...)``) and the
         dispatch helpers (``self._dispatch(...)``,
         ``self._run_batch(...)``), besides the reference's
         ``block_until_ready``/``device_get``/``lower(...).compile()`` —
         the lock outlives the device round-trip and every other thread
         piles up behind host work.
- THR04  unguarded lazy init of shared state: ``if self.x is None:
         self.x = ...`` outside any lock in a concurrent class — the
         duplicate-batcher shape (two first-requests each build
         the resource; one leaks with whatever thread/queue it
         spawned). The double-checked form (re-check + assign inside
         the lock) passes.

Suppression mirrors the purity pass::

    self._batcher  # thread-ok[THR01]: atomic reference read; ...

The code list may be comma-separated or ``*``; the justification text
is REQUIRED — a bare tag does not suppress.

Limits: per-file and name-based like every AST pass here (locks
reached through another object's attribute — ``self._parent._lock`` —
guard that OBJECT's class, not this one, and are ignored); aliasing a
lock through a local rebind is invisible; the one-level call edge
does not follow cross-class calls. The audit obligation is inverted
accordingly: the package's threaded tier (``THREADED_TIER``) must lint
clean in tier-1, so every finding is either fixed or carries a
reasoned ``thread-ok``.
"""

from __future__ import annotations

import ast
import os
import re

from deeplearning4j_tpu_torch.analysis.diagnostics import ERROR, Report
from deeplearning4j_tpu_torch.analysis.purity import iter_py_files

__all__ = ["lint_thread_source", "lint_thread_paths", "THREADED_TIER",
           "threaded_tier_paths"]

#: the port's thread-heavy modules — the default --concurrency subject
#: and the clean gate of its self-check tests
THREADED_TIER = (
    "serving",                 # includes breaker.py (failure domains)
    "runtime/chaos.py",        # fault seams fire on serving threads
    "runtime/telemetry.py",
    "runtime/aot.py",
    "runtime/autotune.py",
    "runtime/resilience.py",
    "runtime/async_iterator.py",
    "parallel/inference.py",
    "util/httpserve.py",
    "util/profiler.py",
)

_SUPPRESS_RE = re.compile(
    r"#\s*thread-ok\[(?P<codes>[A-Z0-9*,\s]+)\]\s*[:—-]\s*(?P<why>\S.*)")

_LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore",
                   "BoundedSemaphore"}
_THREAD_FACTORIES = {"Thread", "ThreadingHTTPServer", "Timer"}
_THREADSAFE_DOC = re.compile(r"thread[- ]?safe", re.IGNORECASE)

#: method-call names that mutate their receiver (shared with the
#: purity pass's closed-over-mutation set, plus deque/list movers)
_MUTATORS = {"append", "appendleft", "extend", "insert", "add", "update",
             "pop", "popleft", "popitem", "remove", "discard", "clear",
             "setdefault"}

#: receiver-attribute names that mean "this call blocks" regardless of
#: receiver type. NOTE: "compile" is deliberately NOT here — re.compile
#: under a lock is microseconds; only the jax AOT shape
#: `X.lower(...).compile()` is flagged (see _check_blocking)
_BLOCKING_ATTRS = {"sleep", "block_until_ready", "device_get",
                   "synchronize", "replay"}

#: tensor methods that wait for the device (a host read) when called
#: with no argument
_HOST_READS = {"item", "cpu", "tolist"}

#: self-attr callables whose invocation is a device dispatch (a
#: CapturedStep's replay included)
_DISPATCH_ATTRS = {"_jit", "_dispatch", "_fallback", "_bare",
                   "_run_batch", "_captured", "_capture", "_step_capture"}


def _dotted(node):
    """Dotted source form of a Name/Attribute chain, or None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return ".".join(parts)
    return None


def _call_root_name(func):
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _is_lock_factory(value):
    """True for threading.Lock() / Lock() / threading.Condition(...)."""
    if not isinstance(value, ast.Call):
        return False
    return _call_root_name(value.func) in _LOCK_FACTORIES


def _is_queue_factory(value):
    if not isinstance(value, ast.Call):
        return False
    return _call_root_name(value.func) in ("Queue", "LifoQueue",
                                           "PriorityQueue",
                                           "SimpleQueue")


def _is_thread_factory(value):
    if not isinstance(value, ast.Call):
        return False
    return _call_root_name(value.func) in _THREAD_FACTORIES


class _Finding:
    __slots__ = ("line", "col", "code", "message", "hint")

    def __init__(self, line, col, code, message, hint=None):
        self.line, self.col = line, col
        self.code, self.message, self.hint = code, message, hint


class _ClassInfo:
    """One class's concurrency surface, gathered in a first pass."""

    def __init__(self, node):
        self.node = node
        self.name = node.name
        self.lock_attrs = set()      # self.X / class-level X lock objects
        self.queue_attrs = set()
        self.thread_attrs = set()    # self.X = threading.Thread(...)
        self.spawns_threads = False
        doc = ast.get_docstring(node) or ""
        self.documented_safe = bool(_THREADSAFE_DOC.search(doc))
        self.locked_writes = {}      # attr -> [(method, node)]
        self.unlocked_writes = {}    # attr -> [(method, node)]
        self.unlocked_reads = {}     # attr -> [(method, node)]
        self.method_top_locks = {}   # method name -> set(lock keys taken)
        #: (held lock key, callee method name, call node): self.m()
        #: called while a lock is held — resolved into THR02 edges
        #: once every method's lock set is known
        self.pending_call_edges = []

    @property
    def concurrent(self):
        return (self.spawns_threads or bool(self.lock_attrs)
                or self.documented_safe)


def _self_attr(node):
    """'X' when node is self.X (Attribute on Name 'self' or 'cls')."""
    if isinstance(node, ast.Attribute) \
            and isinstance(node.value, ast.Name) \
            and node.value.id in ("self", "cls"):
        return node.attr
    return None


class _Collector(ast.NodeVisitor):
    """First pass over one class: lock/queue/thread attributes and the
    thread-spawning flag."""

    def __init__(self, info):
        self.info = info
        self._fn_depth = 0   # bare-Name lock assigns only count at
        #                      class-body depth (a method-local Lock()
        #                      is _MethodChecker's business; registering
        #                      it here would make any same-named local
        #                      in OTHER methods read as "lock held")

    def visit_FunctionDef(self, node):
        self._fn_depth += 1
        self.generic_visit(node)
        self._fn_depth -= 1

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Assign(self, node):
        for t in node.targets:
            attr = _self_attr(t)
            name = t.id if isinstance(t, ast.Name) else None
            if _is_lock_factory(node.value):
                if attr:
                    self.info.lock_attrs.add(attr)
                elif name and self._fn_depth == 0:
                    self.info.lock_attrs.add(name)  # class-level lock
            elif _is_queue_factory(node.value) and attr:
                self.info.queue_attrs.add(attr)
            elif _is_thread_factory(node.value) and attr:
                self.info.thread_attrs.add(attr)
        self.generic_visit(node)

    def visit_Call(self, node):
        if _call_root_name(node.func) in _THREAD_FACTORIES:
            self.info.spawns_threads = True
        self.generic_visit(node)


class _MethodChecker(ast.NodeVisitor):
    """Second pass over one method: lock-region tracking, access
    classification, THR02 edges, THR03 blocking calls, THR04 lazy
    init."""

    def __init__(self, info, method, module, out, exempt=False):
        self.info = info
        self.method = method
        self.module = module          # _ModuleState (edges, locals)
        self.out = out
        #: __init__/__del__/*_locked: accesses are construction-time or
        #: under a caller-held lock — they never enter the UNLOCKED
        #: books (they still contribute locked writes and THR02 edges)
        self.exempt = exempt
        self.lock_stack = []          # dotted lock keys currently held
        self.local_locks = set()      # locals assigned Lock() in method
        self.lock_alias = {}          # local name -> canonical lock key
        #: stack of (attrs guarded by `if self.X is None`, lock depth
        #: at which that check ran) — the depth is what separates a
        #: proper double-check (re-test INSIDE the lock) from a lock
        #: slapped around only the assignment
        self.lazy_guard_attrs = []

    # -- lock identification -------------------------------------------
    def _lock_key(self, expr):
        """Canonical key of a held-lock expression, or None when it is
        not a recognizable lock: self.X in the class's lock attrs, a
        bare class-level/module-level lock name, or a method-local
        Lock()."""
        d = _dotted(expr)
        if d is None:
            return None
        parts = d.split(".")
        if parts[0] in ("self", "cls") and len(parts) == 2 \
                and parts[1] in self.info.lock_attrs:
            return f"{self.info.name}.{parts[1]}"
        if len(parts) == 1:
            if parts[0] in self.lock_alias:
                return self.lock_alias[parts[0]]
            if parts[0] in self.local_locks:
                return f"{self.info.name}.{self.method}.<local>{parts[0]}"
            if parts[0] in self.info.lock_attrs:
                return f"{self.info.name}.{parts[0]}"
            if parts[0] in self.module.module_locks:
                return f"<module>.{parts[0]}"
        return None

    def _held(self):
        return bool(self.lock_stack)

    # -- visitors -------------------------------------------------------
    def visit_Assign(self, node):
        for t in node.targets:
            if isinstance(t, ast.Name):
                if _is_lock_factory(node.value):
                    self.local_locks.add(t.id)
                else:
                    # `lock = self._resp_lock`: a local alias of a
                    # known lock must still count as that lock held
                    a = _self_attr(node.value)
                    if a and a in self.info.lock_attrs:
                        self.lock_alias[t.id] = f"{self.info.name}.{a}"
        self._classify_targets(node.targets, node)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        self._classify_targets([node.target], node)
        self.generic_visit(node)

    def _classify_targets(self, targets, node):
        for t in targets:
            root = t
            while isinstance(root, ast.Subscript):
                root = root.value
            attr = _self_attr(root)
            if attr is None or attr in self.info.lock_attrs:
                continue
            self._record_write(attr, node)
            # nearest enclosing None-check governing this attr; the
            # init is SAFE only when that check ran at the assignment's
            # own (non-zero) lock depth — an outer unlocked check with
            # the lock taken only around the assignment still lets two
            # threads both pass the check and both build (finding: the
            # locked-but-not-re-checked variant of the duplicate-batcher shape)
            gd = None
            for attrs, depth in reversed(self.lazy_guard_attrs):
                if attr in attrs:
                    gd = depth
                    break
            if gd is not None and (not self._held()
                                   or gd < len(self.lock_stack)):
                self.out.append(_Finding(
                    node.lineno, node.col_offset, "THR04",
                    f"lazy init of self.{attr} is unguarded"
                    + ("" if not self._held() else
                       " (the None-check ran OUTSIDE the lock and is "
                       "not re-tested inside it)")
                    + ": two threads passing the None-check together "
                    "each build the resource (the duplicate-batcher "
                    "duplicate-batcher shape) — one copy leaks with "
                    "whatever thread/queue it spawned",
                    hint="take the lock around check+assign "
                         "(double-checked: re-test inside the lock)"))

    def _record_write(self, attr, node):
        if self._held():
            self.info.locked_writes.setdefault(attr, []).append(
                (self.method, node))
        elif not self.exempt:
            self.info.unlocked_writes.setdefault(attr, []).append(
                (self.method, node))

    def _record_read(self, attr, node):
        if not self._held() and not self.exempt:
            self.info.unlocked_reads.setdefault(attr, []).append(
                (self.method, node))

    def visit_Attribute(self, node):
        attr = _self_attr(node)
        if attr is not None and isinstance(node.ctx, ast.Load) \
                and attr not in self.info.lock_attrs:
            self._record_read(attr, node)
        self.generic_visit(node)

    def visit_With(self, node):
        keys = []
        for item in node.items:
            k = self._lock_key(item.context_expr)
            if k is None:
                # a non-lock context expression still EXECUTES (under
                # whatever locks are already held): reads and blocking
                # calls inside it must not escape THR01/THR03
                self.visit(item.context_expr)
            else:
                if self.lock_stack:
                    self.module.add_edge(self.lock_stack[-1], k, node,
                                         self.info, self.method)
                keys.append(k)
                self.lock_stack.append(k)
                self.info.method_top_locks.setdefault(
                    self.method, set()).add(k)
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        for st in node.body:
            self.visit(st)
        for _ in keys:
            self.lock_stack.pop()

    visit_AsyncWith = visit_With

    def visit_If(self, node):
        guarded = self._lazy_guard(node.test)
        if guarded:
            # the guard EXPRESSION itself is an access (an unlocked
            # read of a guarded attr in the test must not escape THR01)
            self.visit(node.test)
            self.lazy_guard_attrs.append(
                (guarded, len(self.lock_stack)))
            for st in node.body:
                self.visit(st)
            self.lazy_guard_attrs.pop()
            for st in node.orelse:
                self.visit(st)
            # a sibling early-return guard (`if self.x is not None:
            # return`) extends the lazy region over the REST of the
            # method; handled by the statement-list walk in run()
            return
        self.generic_visit(node)

    @staticmethod
    def _lazy_guard(test):
        """Attrs whose None-ness this test checks: `self.x is None`,
        `not self.x`."""
        out = set()
        if isinstance(test, ast.Compare) and len(test.ops) == 1 \
                and isinstance(test.ops[0], ast.Is) \
                and isinstance(test.comparators[0], ast.Constant) \
                and test.comparators[0].value is None:
            a = _self_attr(test.left)
            if a:
                out.add(a)
        elif isinstance(test, ast.UnaryOp) \
                and isinstance(test.op, ast.Not):
            a = _self_attr(test.operand)
            if a:
                out.add(a)
        return out

    @staticmethod
    def _early_return_guard(stmt):
        """Attr when stmt is `if self.x is not None: return ...` (the
        fast-path half of a lazy init)."""
        if not isinstance(stmt, ast.If) or stmt.orelse:
            return None
        if not stmt.body or not isinstance(stmt.body[-1], ast.Return):
            return None
        t = stmt.test
        if isinstance(t, ast.Compare) and len(t.ops) == 1 \
                and isinstance(t.ops[0], ast.IsNot) \
                and isinstance(t.comparators[0], ast.Constant) \
                and t.comparators[0].value is None:
            return _self_attr(t.left)
        return None

    # -- THR03 + mutator writes + THR02 call edges ----------------------
    def visit_Call(self, node):
        if self._held():
            self._check_blocking(node)
            # self.m() while holding a lock: a one-level THR02 edge to
            # every lock m's body takes — recorded here so the one
            # canonical _lock_key (aliases and all) feeds the lock
            # graph, resolved after every method is walked
            callee = _self_attr(node.func)
            if callee is not None:
                self.info.pending_call_edges.append(
                    (self.lock_stack[-1], callee, node))
        # self.X.append(...)-style mutation counts as a write of X for
        # the THR01 guarded-attribute inference
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _MUTATORS:
            attr = _self_attr(f.value)
            if attr is not None and attr not in self.info.lock_attrs:
                self._record_write(attr, node)
        self.generic_visit(node)

    def _check_blocking(self, node):
        f = node.func
        name = _call_root_name(f)
        blocked = None
        if name in _BLOCKING_ATTRS:
            blocked = name if not isinstance(f, ast.Attribute) \
                else _dotted(f) or name
        elif name == "compile" and isinstance(f, ast.Attribute) and (
                (isinstance(f.value, ast.Call)
                 and _call_root_name(f.value.func) == "lower")
                or (_dotted(f.value) or "").split(".")[-1]
                in ("lowered", "_lowered")):
            # the jax AOT shape — `jit(fn).lower(args).compile()` /
            # `lowered.compile()` — is an XLA compile (seconds to
            # minutes); a plain X.compile() (re.compile) is not
            blocked = "lower(...).compile"
        elif isinstance(f, ast.Attribute) and name in _HOST_READS \
                and not node.args and not node.keywords:
            # t.item() / t.cpu() / t.tolist(): a device round trip
            blocked = f"{_dotted(f.value) or '?'}.{name}()"
        elif isinstance(f, ast.Attribute) \
                and _self_attr(f) in _DISPATCH_ATTRS:
            # self._jit(x) / self._dispatch(feats): a device dispatch
            # while the lock is held
            blocked = f"self.{f.attr}(...)"
        elif isinstance(f, ast.Attribute):
            recv = _dotted(f.value)
            recv_attr = _self_attr(f.value)
            if name == "join" and (
                    (recv_attr and recv_attr in self.info.thread_attrs)
                    or any(kw.arg == "timeout" for kw in node.keywords)):
                blocked = f"{recv or '?'}.join"
            elif name in ("get", "put") and recv_attr \
                    and recv_attr in self.info.queue_attrs:
                blocked = f"{recv or '?'}.{name}"
            elif name == "wait":
                held = self.lock_stack[-1]
                k = self._lock_key(f.value)
                if k is None or k != held:
                    blocked = f"{recv or '?'}.wait"
            elif recv_attr in _DISPATCH_ATTRS:
                blocked = f"self.{recv_attr}(...)"
        elif isinstance(f, ast.Name) and f.id in _DISPATCH_ATTRS:
            blocked = f"{f.id}(...)"
        if blocked:
            self.out.append(_Finding(
                node.lineno, node.col_offset, "THR03",
                f"blocking call {blocked} while holding "
                f"{self.lock_stack[-1]}: the lock outlives the "
                "sleep/join/queue/dispatch and every other thread "
                "piles up behind it",
                hint="move the blocking work outside the critical "
                     "section (take what you need under the lock, "
                     "release, then block); a Condition.wait on the "
                     "HELD condition is fine — it releases the lock"))

    # -- driver ---------------------------------------------------------
    def run(self, fn):
        stmts = fn.body
        guard = None
        for i, st in enumerate(stmts):
            g = self._early_return_guard(st)
            if g is not None and guard is None:
                guard = g
                # the remainder of the method is the lazy-init slow
                # path for attr g (checked at the current — method
                # top-level, i.e. zero — lock depth)
                self.lazy_guard_attrs.append(
                    ({g}, len(self.lock_stack)))
                self.visit(st)
                for rest in stmts[i + 1:]:
                    self.visit(rest)
                self.lazy_guard_attrs.pop()
                return
            self.visit(st)


class _ModuleState:
    """Cross-class state for one file: module-level locks and the
    acquired-while-held graph."""

    def __init__(self):
        self.module_locks = set()
        self.edges = {}   # (lockA, lockB) -> node of the inner acquire

    def add_edge(self, a, b, node, info=None, method=None):
        if a == b:
            return  # reentrant (RLock) acquire, not an inversion
        self.edges.setdefault((a, b), node)


def _cycles(edges):
    """Edges participating in a cycle of the lock graph."""
    graph = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)

    def reachable(src, dst):
        seen, todo = set(), [src]
        while todo:
            n = todo.pop()
            if n == dst:
                return True
            if n in seen:
                continue
            seen.add(n)
            todo.extend(graph.get(n, ()))
        return False

    return [(a, b) for (a, b) in edges if reachable(b, a)]


def _resolve_call_edges(info, module):
    """One-level interprocedural THR02 edges: with lock A held, a call
    to self.m() whose body takes lock B adds edge A -> B. The held
    contexts were recorded by _MethodChecker (the one canonical lock
    resolver — aliases included); callee lock sets are only complete
    once every method has been walked, hence this second step."""
    for held, callee, node in info.pending_call_edges:
        for k in info.method_top_locks.get(callee, ()):
            module.add_edge(held, k, node)


def lint_thread_source(source, path="<string>"):
    """THR01-04 over one source string -> Report (suppressed findings
    carried but non-failing, purity-pass style)."""
    report = Report(subject=f"threads:{path}")
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        report.add("LNT00", ERROR, f"{path}:{e.lineno or 0}",
                   f"file does not parse: {e.msg}")
        return report

    module = _ModuleState()
    for node in tree.body:
        if isinstance(node, ast.Assign) and _is_lock_factory(node.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    module.module_locks.add(t.id)

    findings = []
    classes = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        info = _ClassInfo(node)
        _Collector(info).visit(node)
        classes.append(info)
        if not info.concurrent:
            continue
        for m in node.body:
            if not isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            exempt = m.name in ("__init__", "__new__", "__del__") \
                or m.name.endswith("_locked")
            # exempt methods (construction happens-before publication;
            # *_locked = called-with-the-lock-held convention) are
            # still scanned for nested-lock edges
            chk = _MethodChecker(info, m.name, module,
                                 [] if exempt else findings,
                                 exempt=exempt)
            chk.run(m)
        _resolve_call_edges(info, module)

        # THR01: attrs written under a lock somewhere, touched outside
        guarded = set(info.locked_writes)
        for attr in sorted(guarded):
            for method, node_w in info.unlocked_writes.get(attr, ()):
                findings.append(_Finding(
                    node_w.lineno, node_w.col_offset, "THR01",
                    f"self.{attr} is written under "
                    f"{info.name}'s lock in "
                    f"{sorted({m for m, _ in info.locked_writes[attr]})} "
                    f"but written WITHOUT it in {method}() — the two "
                    "writers race",
                    hint="take the lock here too, or rename the "
                         "method *_locked if the caller already "
                         "holds it"))
            for method, node_r in info.unlocked_reads.get(attr, ()):
                findings.append(_Finding(
                    node_r.lineno, node_r.col_offset, "THR01",
                    f"self.{attr} is lock-guarded (written under "
                    f"{info.name}'s lock) but read without it in "
                    f"{method}() — a torn/stale read races the "
                    "guarded writers",
                    hint="read under the lock, or suppress with a "
                         "reason if the single read is genuinely "
                         "atomic-and-benign"))

    # THR02 over the whole module's lock graph
    for (a, b) in _cycles(module.edges):
        node = module.edges[(a, b)]
        findings.append(_Finding(
            node.lineno, getattr(node, "col_offset", 0), "THR02",
            f"lock-order inversion: {a} is held while acquiring {b}, "
            "and the reverse order exists elsewhere in this module — "
            "two threads taking the two paths deadlock (ABBA)",
            hint="impose one global acquisition order, or collapse "
                 "the two locks into one"))

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
    return report


def threaded_tier_paths():
    """Absolute paths of the port's threaded-tier modules
    (THREADED_TIER), the default --concurrency subject."""
    import deeplearning4j_tpu_torch as pkg

    base = os.path.dirname(os.path.abspath(pkg.__file__))
    return [os.path.join(base, p) for p in THREADED_TIER]


def lint_thread_paths(paths=None):
    """THR01-04 over files/directories (default: the package's
    threaded tier) -> merged Report."""
    report = Report(subject="threads")
    for path in iter_py_files(paths if paths is not None
                              else threaded_tier_paths()):
        try:
            with open(path, "r", encoding="utf-8") as fh:
                src = fh.read()
        except OSError as e:
            report.add("LNT00", ERROR, path, f"unreadable: {e}")
            continue
        report.extend(lint_thread_source(src, path))
    return report
