"""luxlint-threads: the concurrency tier (LUX301-LUX305), the counterpart
of ``lux_tpu/analysis/threads.py``.

The port's serving substrate is multi-threaded — the MicroBatcher
worker, background snapshot warms, compaction daemons, the FIFO drain
barrier, the breaker's probe, thread-per-request HTTP. The AST tier
(rules.py) says nothing about thread-shared state; this tier
machine-checks the lock discipline the code otherwise only promises in
comments:

- LUX301 shared-state-without-lock: in any class that hands work to
  another thread (``threading.Thread(target=...)``, a nested thread
  target, or a method registered with a batcher/worker/context
  consumer), attributes touched from both the thread side and the
  caller side must be accessed under a ``with <...lock>:`` guard.
- LUX302 lock-order-inversion: the static acquisition graph built from
  syntactically nested ``with <lock>`` blocks across the whole package
  must be acyclic — an A→B nesting in one function and B→A in another
  is a deadlock waiting for the right interleave.
- LUX303 blocking-call-under-lock: unbounded waits (``.join()`` /
  ``.result()`` / ``.wait()`` with no timeout, queue ``get()`` with no
  timeout), sleeps, device syncs (``torch.cuda.synchronize``,
  ``Stream``/``Event.synchronize``), socket/HTTP I/O, and engine
  warmup/compile inside a lock-guarded region stall every other thread
  that needs the lock.
- LUX304 unjoined-thread: every spawned thread needs a drain path —
  joined directly, returned to the caller, or registered in a container
  the file drains (``SnapshotStore.drain_compactions`` is the compliant
  shape).
- LUX305 unsynchronized-publish: atomic-flip pointers (the
  ``Session._serving`` hot-swap idiom) declared with
  ``# luxlint: publish=<lock>`` must be written at most once per method,
  only under the declared lock, and read at most once per method (read
  the pointer into a local; a second raw read can observe a different
  version mid-swap).

Annotation grammar (same-line comments)::

    self._state = {}      # luxlint: publish=_swap_lock
    self._serving = snap  # luxlint: guarded-by=_swap_lock -- caller holds it

``guarded-by=<lock>`` on an ``__init__`` assignment declares the attr's
required lock class-wide; on any other access line it asserts that this
specific access runs with ``<lock>`` held by a caller (the cross-method
discipline the AST cannot see — a reviewed assertion, like a
suppression, but still checked against the declared lock name).
Findings suppress exactly like every other tier::

    ex.warmup()  # luxlint: disable=LUX303 -- first build must hold the key

Pure stdlib ``ast``; the cross-file lock graph is prebuilt by
:func:`build_lock_graph`, then every rule runs per-file through the
standard core machinery (suppressions, JSON, baselines all shared).
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from lux_tpu_torch.analysis.core import (FileContext, Finding, LintReport,
                                         Rule, iter_python_files,
                                         run_paths)
from lux_tpu_torch.analysis.rules import _dotted

_GUARDED_BY_RE = re.compile(r"#\s*luxlint:\s*guarded-by=([A-Za-z_]\w*)")
_PUBLISH_RE = re.compile(r"#\s*luxlint:\s*publish=([A-Za-z_]\w*)")

# Constructors whose instances are synchronization/metric primitives —
# safe to touch from any thread, so LUX301 never treats them as
# unguarded shared data.
_SYNC_TYPES = {
    "Event", "Lock", "RLock", "Condition", "Semaphore",
    "BoundedSemaphore", "Barrier", "Thread", "local",
    "Queue", "SimpleQueue", "LifoQueue", "PriorityQueue",
    "make_lock", "WatchedLock",
    "counter", "gauge", "histogram", "Counter", "Gauge", "Histogram",
}

# Callees that consume a method reference and run it on another thread
# (the "registered as a worker" half of thread-entry detection).
_WORKER_CALLEE_RE = re.compile(r"batcher|worker|add_context|add_sink",
                               re.IGNORECASE)

# Container mutators that count as writes for shared-state inference.
_MUTATORS = {
    "append", "appendleft", "add", "insert", "extend", "update",
    "remove", "discard", "clear", "pop", "popleft", "popitem",
    "setdefault",
}

# Dotted-name tails that block the calling thread (LUX303). Deliberately
# curated: ``.get``/``.run`` alone are too generic, so queue gets are
# matched by receiver name and engine execution by warmup/compile. The
# device syncs are the port's ``synchronize`` (torch.cuda, Stream, Event)
# beside lux_tpu's jax names, which keep the two tiers' findings equal on
# the same source.
_BLOCKING_TAILS = {
    "hard_sync", "block_until_ready", "device_get", "synchronize",
    "urlopen", "sleep", "serve_forever", "recv", "accept", "sendall",
    "warmup", "compile",
}
# Unbounded waits: flagged only when called with no timeout.
_TIMEOUT_WAITS = {"join", "result", "wait"}
_QUEUEISH_RE = re.compile(r"(^_?q$)|queue", re.IGNORECASE)


def _final_ident(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _is_lock_expr(node: ast.AST) -> bool:
    """True for with-items that acquire a lock: the final identifier of
    the (non-call) expression contains 'lock'."""
    name = _final_ident(node)
    return name is not None and "lock" in name.lower()


def _is_self_attr(node: ast.AST) -> bool:
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self")


def _has_timeout(call: ast.Call) -> bool:
    return bool(call.args) or any(
        kw.arg == "timeout" for kw in call.keywords)


def _line_annotation(ctx: FileContext, lineno: int,
                     pattern: re.Pattern) -> Optional[str]:
    if 1 <= lineno <= len(ctx.lines):
        m = pattern.search(ctx.lines[lineno - 1])
        if m:
            return m.group(1)
    return None


@dataclasses.dataclass
class _Access:
    attr: str
    node: ast.AST
    method: str
    is_write: bool
    guards: Tuple[str, ...]        # final idents of locks held (syntactic)
    annotated: Optional[str]       # per-line guarded-by assertion


class _ClassAnalysis:
    """Everything LUX301/LUX305 need about one class."""

    def __init__(self, node: ast.ClassDef, ctx: FileContext):
        self.node = node
        self.name = node.name
        self.methods: Dict[str, ast.AST] = {
            m.name: m for m in node.body
            if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        self.guarded_by: Dict[str, str] = {}
        self.publish: Dict[str, str] = {}
        self.exempt: Set[str] = set()
        self.entries: Set[str] = set()
        self.accesses: Dict[str, List[_Access]] = {}   # method -> accesses
        self._nested_targets: List[ast.AST] = []
        self._scan_declarations(ctx)
        self._scan_entries()
        for name, fn in self.methods.items():
            if name == "__init__":
                continue
            out: List[_Access] = []
            _collect_accesses(fn, name, ctx, self.methods, out)
            self.accesses[name] = out

    # -- declarations (from __init__) -------------------------------------

    def _scan_declarations(self, ctx: FileContext) -> None:
        init = self.methods.get("__init__")
        if init is None:
            return
        for stmt in ast.walk(init):
            if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
                continue
            tgt = stmt.targets[0]
            if not _is_self_attr(tgt):
                continue
            attr = tgt.attr
            lock = _line_annotation(ctx, stmt.lineno, _GUARDED_BY_RE)
            if lock:
                self.guarded_by[attr] = lock
            lock = _line_annotation(ctx, stmt.lineno, _PUBLISH_RE)
            if lock:
                self.publish[attr] = lock
            if isinstance(stmt.value, ast.Call):
                ctor = _final_ident(stmt.value.func)
                if ctor in _SYNC_TYPES:
                    self.exempt.add(attr)

    # -- thread-entry detection -------------------------------------------

    def _scan_entries(self) -> None:
        for call in ast.walk(self.node):
            if not isinstance(call, ast.Call):
                continue
            callee = _dotted(call.func) or ""
            tail = callee.rsplit(".", 1)[-1]
            if tail == "Thread":
                for kw in call.keywords:
                    if kw.arg != "target":
                        continue
                    if _is_self_attr(kw.value):
                        self.entries.add(kw.value.attr)
                    elif isinstance(kw.value, ast.Name):
                        nested = self._find_nested_def(kw.value.id)
                        if nested is not None:
                            self._nested_targets.append(nested)
            elif _WORKER_CALLEE_RE.search(tail):
                for arg in list(call.args) + [k.value for k in call.keywords]:
                    if _is_self_attr(arg) and arg.attr in self.methods:
                        self.entries.add(arg.attr)

    def _find_nested_def(self, name: str) -> Optional[ast.AST]:
        for n in ast.walk(self.node):
            if isinstance(n, ast.FunctionDef) and n.name == name \
                    and name not in self.methods:
                return n
        return None

    # -- reachability ------------------------------------------------------

    def thread_methods(self) -> Set[str]:
        """Methods reachable from any thread entry via self.m() calls."""
        seeds = set(self.entries)
        for nested in self._nested_targets:
            seeds |= _self_calls(nested) & set(self.methods)
        frontier = list(seeds & set(self.methods) | (seeds & self.entries))
        reached: Set[str] = set()
        while frontier:
            m = frontier.pop()
            if m in reached or m not in self.methods:
                continue
            reached.add(m)
            frontier.extend(_self_calls(self.methods[m]))
        return reached

    def is_concurrent(self) -> bool:
        return bool(self.entries or self._nested_targets)


def _self_calls(fn: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for n in ast.walk(fn):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and isinstance(n.func.value, ast.Name)
                and n.func.value.id == "self"):
            out.add(n.func.attr)
    return out


def _collect_accesses(fn: ast.AST, method: str, ctx: FileContext,
                      methods: Dict[str, ast.AST],
                      out: List[_Access]) -> None:
    """Record every self-attribute data access in ``fn`` with the lock
    guards syntactically active at that point. Method references
    (``self.warmup(...)``, property loads of defined methods) are code,
    not data, and are skipped. Nested defs/lambdas are walked with the
    same method attribution (closures run where the method sends them)."""
    skip: Set[int] = set()

    def record(attr_node: ast.Attribute, is_write: bool,
               guards: Tuple[str, ...]) -> None:
        if attr_node.attr in methods:
            return
        out.append(_Access(
            attr=attr_node.attr, node=attr_node, method=method,
            is_write=is_write, guards=guards,
            annotated=_line_annotation(ctx, attr_node.lineno,
                                       _GUARDED_BY_RE),
        ))

    def visit(node: ast.AST, guards: Tuple[str, ...]) -> None:
        if isinstance(node, ast.With):
            g = guards
            for item in node.items:
                if _is_lock_expr(item.context_expr):
                    g = g + (_final_ident(item.context_expr),)
                visit(item.context_expr, guards)
            for stmt in node.body:
                visit(stmt, g)
            return
        if isinstance(node, ast.Call):
            f = node.func
            if (isinstance(f, ast.Attribute) and f.attr in _MUTATORS
                    and _is_self_attr(f.value)):
                record(f.value, True, guards)
                skip.add(id(f.value))
            for child in ast.iter_child_nodes(node):
                visit(child, guards)
            return
        if isinstance(node, ast.Attribute) and _is_self_attr(node) \
                and id(node) not in skip:
            record(node, isinstance(node.ctx, (ast.Store, ast.Del)), guards)
        if isinstance(node, ast.Subscript) and _is_self_attr(node.value) \
                and isinstance(node.ctx, (ast.Store, ast.Del)):
            record(node.value, True, guards)
            skip.add(id(node.value))
        for child in ast.iter_child_nodes(node):
            visit(child, guards)

    for stmt in ast.iter_child_nodes(fn):
        visit(stmt, ())


def _guard_ok(acc: _Access, required: Optional[str]) -> bool:
    if required is not None:
        return required in acc.guards or acc.annotated == required
    return bool(acc.guards) or acc.annotated is not None


class SharedStateRule(Rule):
    id = "LUX301"
    title = "thread-shared attribute accessed without its lock"
    doc = ("attributes touched from both a thread-entry path "
           "(Thread(target=...), batcher/worker callbacks) and the "
           "caller side must be accessed under `with <lock>:` or carry "
           "a same-line `# luxlint: guarded-by=<lock>` assertion")

    def check(self, tree: ast.Module, ctx: FileContext) -> Iterable[Finding]:
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                yield from self._check_class(_ClassAnalysis(node, ctx), ctx)

    def _check_class(self, ca: _ClassAnalysis,
                     ctx: FileContext) -> Iterable[Finding]:
        if not ca.is_concurrent():
            return
        tside = ca.thread_methods()
        t_w: Set[str] = set()
        t_any: Set[str] = set()
        o_w: Set[str] = set()
        o_any: Set[str] = set()
        for m, accs in ca.accesses.items():
            for a in accs:
                (t_any if m in tside else o_any).add(a.attr)
                if a.is_write:
                    (t_w if m in tside else o_w).add(a.attr)
        shared = ((t_w & o_any) | (o_w & t_any)) - ca.exempt \
            - set(ca.publish)
        if not shared:
            return
        entries = ",".join(sorted(ca.entries)) or "<nested thread target>"
        for m, accs in ca.accesses.items():
            for a in accs:
                if a.attr not in shared:
                    continue
                required = ca.guarded_by.get(a.attr)
                if _guard_ok(a, required):
                    continue
                want = f"self.{required}" if required else "self.<lock>"
                yield self.finding(
                    ctx, a.node,
                    f"`self.{a.attr}` is shared with the thread-entry "
                    f"path ({ca.name}.{entries}) but "
                    f"{'written' if a.is_write else 'read'} in "
                    f"`{m}` without holding a lock; wrap in "
                    f"`with {want}:` or annotate the line with "
                    f"`# luxlint: guarded-by=<lock>`",
                )


class LockOrderRule(Rule):
    id = "LUX302"
    title = "lock-order inversion in the static acquisition graph"
    doc = ("nested `with <lock>` blocks define acquisition edges across "
           "the whole package; a cycle (A before B here, B before A "
           "there) deadlocks under the right interleave")

    def __init__(self, bad_edges: Optional[Dict[str, list]] = None):
        # abs path -> [(lineno, col, held, acquired, cycle), ...]
        self.bad_edges = bad_edges or {}

    def check(self, tree: ast.Module, ctx: FileContext) -> Iterable[Finding]:
        for (lineno, col, held, acquired, cycle) in self.bad_edges.get(
                os.path.abspath(ctx.path), ()):
            yield Finding(
                self.id, ctx.path, lineno, col,
                f"acquiring `{acquired}` while holding `{held}` inverts "
                f"the lock order observed elsewhere "
                f"(cycle: {' -> '.join(cycle)}); pick one global order",
            )


class BlockingUnderLockRule(Rule):
    id = "LUX303"
    title = "blocking call while holding a lock"
    doc = ("no unbounded join/result/wait, queue get without timeout, "
           "sleep, socket/HTTP I/O, device sync, or engine "
           "warmup/compile inside a `with <lock>:` region — every other "
           "thread needing the lock stalls behind it")

    def check(self, tree: ast.Module, ctx: FileContext) -> Iterable[Finding]:
        funcs = [n for n in ast.walk(tree)
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for fn in funcs:
            yield from self._check_fn(fn, ctx)

    def _check_fn(self, fn: ast.AST, ctx: FileContext) -> Iterable[Finding]:
        findings: List[Finding] = []

        def visit(node: ast.AST, locks: Tuple[str, ...]) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not fn:
                return   # deferred execution: not under this lock
            if isinstance(node, ast.With):
                g = locks
                for item in node.items:
                    if _is_lock_expr(item.context_expr):
                        g = g + (_final_ident(item.context_expr),)
                    visit(item.context_expr, locks)
                for stmt in node.body:
                    visit(stmt, g)
                return
            if isinstance(node, ast.Call) and locks:
                findings.extend(self._check_call(node, locks, ctx))
            for child in ast.iter_child_nodes(node):
                visit(child, locks)

        for stmt in ast.iter_child_nodes(fn):
            visit(stmt, ())
        return findings

    def _check_call(self, call: ast.Call, locks: Tuple[str, ...],
                    ctx: FileContext) -> Iterable[Finding]:
        held = ",".join(locks)
        dotted = _dotted(call.func) or ""
        tail = dotted.rsplit(".", 1)[-1]
        if tail in _BLOCKING_TAILS:
            yield self.finding(
                ctx, call,
                f"blocking call `{dotted}` while holding `{held}` — move "
                f"the slow work outside the guarded region",
            )
            return
        if not isinstance(call.func, ast.Attribute):
            return
        if tail in _TIMEOUT_WAITS and not _has_timeout(call):
            yield self.finding(
                ctx, call,
                f"unbounded `.{tail}()` while holding `{held}` — pass a "
                f"timeout or release the lock first",
            )
            return
        recv = _final_ident(call.func.value)
        if tail == "get" and recv and _QUEUEISH_RE.search(recv) \
                and not _has_timeout(call):
            yield self.finding(
                ctx, call,
                f"queue `.get()` with no timeout while holding `{held}` "
                f"— a quiet queue parks the lock forever",
            )


class UnjoinedThreadRule(Rule):
    id = "LUX304"
    title = "thread spawned without a join/drain path"
    doc = ("every threading.Thread must be joined in this file, returned "
           "to the caller, or stored in a container the file drains "
           "(SnapshotStore.drain_compactions is the compliant shape)")

    def check(self, tree: ast.Module, ctx: FileContext) -> Iterable[Finding]:
        parents: Dict[int, ast.AST] = {}
        joins_on: Set[str] = set()        # names X with X.join(...)
        attr_joins: Set[str] = set()      # attrs A with self.A.join(...)
        any_join = False
        returned: Set[str] = set()
        spawns: List[Tuple[ast.Call, ast.AST]] = []
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                parents[id(child)] = node
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "join":
                any_join = True
                base = node.func.value
                if isinstance(base, ast.Name):
                    joins_on.add(base.id)
                elif _is_self_attr(base):
                    attr_joins.add(base.attr)
            if isinstance(node, ast.Return) and node.value is not None:
                returned |= {n.id for n in ast.walk(node.value)
                             if isinstance(n, ast.Name)}
            if isinstance(node, ast.Call):
                dotted = _dotted(node.func) or ""
                if dotted.rsplit(".", 1)[-1] == "Thread":
                    spawns.append(node)
        for call in spawns:
            if not self._compliant(call, parents, joins_on, attr_joins,
                                   returned, any_join):
                yield self.finding(
                    ctx, call,
                    "thread spawned with no join/drain path in this file "
                    "— join it, return it to the caller, or register it "
                    "in a container a drain method joins",
                )

    @staticmethod
    def _compliant(call, parents, joins_on, attr_joins, returned,
                   any_join) -> bool:
        node: ast.AST = call
        in_container = False
        while True:
            parent = parents.get(id(node))
            if parent is None:
                return False
            if isinstance(parent, ast.Assign):
                for tgt in parent.targets:
                    if isinstance(tgt, ast.Name):
                        if in_container:
                            return any_join
                        return (tgt.id in joins_on or tgt.id in returned
                                or (tgt.id in _appended_somewhere(parents)
                                    and any_join))
                    if _is_self_attr(tgt):
                        return tgt.attr in attr_joins or any_join
                return False
            if isinstance(parent, (ast.ListComp, ast.SetComp, ast.List,
                                   ast.Tuple, ast.Dict, ast.GeneratorExp)):
                in_container = True
            elif isinstance(parent, ast.Call) and parent.func is not node:
                # Thread(...) passed straight into another call: the
                # consumer owns it (e.g. a drain list's append).
                return any_join
            elif isinstance(parent, (ast.Expr, ast.stmt)) \
                    and not isinstance(parent, ast.Assign):
                # bare `Thread(...).start()` chain or expression statement
                if isinstance(node, ast.Call) and node is not call:
                    return False
                return False
            node = parent


def _appended_somewhere(parents: Dict[int, ast.AST]) -> Set[str]:
    out: Set[str] = set()
    for node in parents.values():
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "append":
            for a in node.args:
                if isinstance(a, ast.Name):
                    out.add(a.id)
    return out


class PublishRule(Rule):
    id = "LUX305"
    title = "atomic-publish pointer written/read outside its discipline"
    doc = ("attrs declared `# luxlint: publish=<lock>` are hot-swap flip "
           "pointers: at most one write per method, only under the "
           "declared lock (or a same-line guarded-by assertion), and at "
           "most one raw read per method — read the pointer into a "
           "local so one request can never observe two versions")

    def check(self, tree: ast.Module, ctx: FileContext) -> Iterable[Finding]:
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                ca = _ClassAnalysis(node, ctx)
                if ca.publish:
                    yield from self._check_class(ca, ctx)

    def _check_class(self, ca: _ClassAnalysis,
                     ctx: FileContext) -> Iterable[Finding]:
        for m, accs in ca.accesses.items():
            writes: Dict[str, int] = {}
            raw_reads: Dict[str, int] = {}
            for a in accs:
                lock = ca.publish.get(a.attr)
                if lock is None:
                    continue
                if a.is_write:
                    writes[a.attr] = writes.get(a.attr, 0) + 1
                    if writes[a.attr] > 1:
                        yield self.finding(
                            ctx, a.node,
                            f"`self.{a.attr}` published more than once in "
                            f"`{m}` — a swap must flip the pointer "
                            f"exactly once",
                        )
                    elif not _guard_ok(a, lock):
                        yield self.finding(
                            ctx, a.node,
                            f"unsynchronized publish: `self.{a.attr}` "
                            f"written in `{m}` outside `with "
                            f"self.{lock}:` (declare the holder with "
                            f"`# luxlint: guarded-by={lock}` if a caller "
                            f"owns the lock)",
                        )
                elif not _guard_ok(a, lock):
                    raw_reads[a.attr] = raw_reads.get(a.attr, 0) + 1
                    if raw_reads[a.attr] > 1:
                        yield self.finding(
                            ctx, a.node,
                            f"torn read: `self.{a.attr}` read more than "
                            f"once in `{m}` — a swap between reads mixes "
                            f"two versions; read it once into a local",
                        )


# -- cross-file lock-order graph -------------------------------------------


def _lock_id(node: ast.AST, class_name: Optional[str],
             file_base: str) -> Optional[str]:
    d = _dotted(node)
    if d is None:
        return None
    if d.startswith("self."):
        return f"{class_name or file_base}.{d[5:]}"
    if "." in d:
        return d
    # Bare module-level name: qualify as <module>.<name> so a dotted
    # `m.lock` acquisition in another file lands on the same graph node.
    return f"{file_base}.{d}"


def _collect_edges(tree: ast.Module, path: str,
                   edges: List[tuple]) -> None:
    file_base = os.path.splitext(os.path.basename(path))[0]

    def walk_fn(fn: ast.AST, class_name: Optional[str]) -> None:
        def visit(node: ast.AST, held: Tuple[str, ...]) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not fn:
                return
            if isinstance(node, ast.With):
                h = held
                for item in node.items:
                    if _is_lock_expr(item.context_expr):
                        lock = _lock_id(item.context_expr, class_name,
                                        file_base)
                        if lock is not None:
                            for prior in h:
                                if prior != lock:
                                    edges.append((
                                        prior, lock, path,
                                        item.context_expr.lineno,
                                        item.context_expr.col_offset,
                                    ))
                            h = h + (lock,)
                for stmt in node.body:
                    visit(stmt, h)
                return
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for stmt in ast.iter_child_nodes(fn):
            visit(stmt, ())

    def scan(node: ast.AST, class_name: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                scan(child, child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                walk_fn(child, class_name)
                scan(child, class_name)
            else:
                scan(child, class_name)

    scan(tree, None)


def build_lock_graph(paths: Sequence[str]) -> Dict[str, list]:
    """Edges from syntactically nested lock acquisitions across all
    ``paths``; returns {abs path: [(line, col, held, acquired, cycle)]}
    for every edge that participates in a cycle."""
    edges: List[tuple] = []
    for path in iter_python_files(paths):
        try:
            with open(path, encoding="utf-8") as fh:
                tree = ast.parse(fh.read(), filename=path)
        except (OSError, SyntaxError):
            continue   # the per-file pass reports read/syntax errors
        _collect_edges(tree, path, edges)
    adj: Dict[str, Set[str]] = {}
    for a, b, *_ in edges:
        adj.setdefault(a, set()).add(b)
    bad: Dict[str, list] = {}
    for a, b, path, lineno, col in edges:
        cycle = _find_path(adj, b, a)
        if cycle is not None:
            bad.setdefault(os.path.abspath(path), []).append(
                (lineno, col, a, b, [a] + cycle))
    for v in bad.values():
        v.sort()
    return bad


def _find_path(adj: Dict[str, Set[str]], src: str,
               dst: str) -> Optional[List[str]]:
    seen = {src}
    frontier: List[List[str]] = [[src]]
    while frontier:
        p = frontier.pop()
        for nxt in adj.get(p[-1], ()):
            if nxt == dst:
                return p + [nxt]
            if nxt not in seen:
                seen.add(nxt)
                frontier.append(p + [nxt])
    return None


# -- tier entry points ------------------------------------------------------


def all_thread_rules(graph_paths: Optional[Sequence[str]] = None
                     ) -> List[Rule]:
    """The LUX30x rule set. ``graph_paths`` feeds the cross-file lock
    graph for LUX302 (default: no prebuilt graph — use run_threads)."""
    bad = build_lock_graph(graph_paths) if graph_paths else {}
    return [SharedStateRule(), LockOrderRule(bad),
            BlockingUnderLockRule(), UnjoinedThreadRule(), PublishRule()]


def run_threads(paths: Sequence[str],
                select: Optional[Set[str]] = None,
                graph_paths: Optional[Sequence[str]] = None) -> LintReport:
    """Run the concurrency tier over ``paths``.

    The LUX302 graph is built over ``graph_paths`` (default: the lint
    paths themselves) so `--changed` runs can lint a subset of files
    against the whole tree's acquisition order.
    """
    rules = all_thread_rules(graph_paths if graph_paths is not None
                             else paths)
    if select:
        rules = [r for r in rules if r.id in select]
    report = run_paths(paths, rules)
    report.schema = "luxlint-threads.v1"
    return report
