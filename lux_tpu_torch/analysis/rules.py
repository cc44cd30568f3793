"""The luxlint rule set, the counterpart of ``lux_tpu/analysis/rules.py``:
the same ids, titles and scopes, each read in the port's idiom.

- LUX001 host-sync-in-hot-loop: the iteration loops are fast only while
  no hidden host round-trip sits inside them. The port's forms are
  ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``float()`` /
  ``int()`` and ``np.asarray`` of a tensor, ``torch.cuda.synchronize``
  and ``Event``/``Stream.synchronize``, and the sync funnels:
  ``engine/telemetry.py::sync`` and the executors' counter reads
  ``_read``.
- LUX002 recompile-hygiene: ``torch.compile``d callables specialise on
  each distinct bare Python int or float they are fed. ``lux_tpu``'s
  other half (jitted steps must donate their buffer) has no counterpart:
  the port has no ``jax.jit`` and no donation.
- LUX003 kernel-shape-contract: the dtype half of ``lux_tpu``'s rule —
  int8 code planes and int32 row indices at the kernel wrappers'
  ``.to(...)``, ``.astype(...)`` and ``dtype=`` sites in
  ``ops/*kernel*.py``. The BlockSpec half has no counterpart (no
  Pallas).
- LUX004 env-flag-registry: every ``LUX_*`` key read anywhere must be
  declared in lux_tpu_torch/utils/flags.py.
- LUX005 direct-env-read: port code reads LUX_* knobs through the flags
  module, not os.environ (writes stay legal).
- LUX006 clock-discipline: serve/engine code stamps time through
  ``obs/spans.py``'s ``clock()`` (durations) and ``monotonic()``
  (deadlines), never raw time.*.
- LUX007 swallowed-exception: broad serve/engine handlers must do more
  than log and move on.
- LUX008 metric-name-discipline, LUX009 region-name-discipline (the
  profiler regions are ``prof.region``,
  ``torch.profiler.record_function`` and ``torch.cuda.nvtx``'s
  ``range_push``/``range``), LUX010 ledger-discipline.

All pure ``ast``; no torch, no numpy.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from lux_tpu_torch.analysis.core import FileContext, Finding, Rule

# Functions that ARE the iteration hot path. Deliberately narrow: warmup
# and phase_step sync per dispatch by design.
_HOT_FN_RE = re.compile(r"(^|_)run(_|$)|fixpoint|pipelined")

# The dtype names a `.to(...)` / `dtype=` argument may end in.
_DTYPES = frozenset((
    "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
    "uint64", "float16", "bfloat16", "float32", "float64", "bool",
    "long", "short", "half", "double",
))


def _dotted(node: ast.AST) -> Optional[str]:
    """'torch.cuda.synchronize' for Attribute chains, 'float' for
    Names."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _root_ident(node: ast.AST) -> Optional[str]:
    """Nearest meaningful identifier of an expression: the value a call
    like ``x.codes.to(...)`` is really about ('codes')."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Subscript):
        return _root_ident(node.value)
    if isinstance(node, ast.Call):
        if node.args:
            return _root_ident(node.args[0])
        return _root_ident(node.func)
    return None


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


class HostSyncInHotLoop(Rule):
    id = "LUX001"
    title = "host-sync-in-hot-loop"
    doc = ("no host transfer/sync (.item(), .tolist(), .cpu(), .numpy(), "
           "float()/int() or np.asarray of a tensor, "
           "torch.cuda/Event/Stream.synchronize, telemetry.sync, the "
           "executors' _read) inside engine run/fixpoint loops")

    # Call-name tails that block on the device: torch.cuda.synchronize,
    # Event/Stream.synchronize, and the port's sync funnels
    # (engine/telemetry.py::sync, the GAS executor's _sync, and the
    # executors' counter reads _read).
    _SYNC_TAILS = {"synchronize", "sync", "_sync", "_read"}
    # Tensor methods that copy device data to the host.
    _HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
    _ASARRAY = {"np.asarray", "numpy.asarray", "onp.asarray"}

    def applies_to(self, ctx: FileContext) -> bool:
        return "engine/" in ctx.posix_path

    def check(self, tree: ast.Module, ctx: FileContext) -> Iterable[Finding]:
        out: Dict[tuple, Finding] = {}
        classes = {c.name: c for c in ast.walk(tree)
                   if isinstance(c, ast.ClassDef)}
        owner = {id(m): c for c in classes.values() for m in c.body}
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not _HOT_FN_RE.search(fn.name):
                continue
            host_names = self._host_tainted(fn)
            for loop in ast.walk(fn):
                if not isinstance(loop, (ast.For, ast.While)):
                    continue
                for node in ast.walk(loop):
                    f = self._check_call(node, fn.name, host_names, ctx)
                    if f is not None:
                        out[(f.line, f.col)] = f
                cls = owner.get(id(fn))
                if cls is None:
                    continue
                for callee in self._per_iteration(loop, cls, classes):
                    unpacked = self._unpacked(callee)
                    for node in ast.walk(callee):
                        f = self._check_read(
                            node, f"{fn.name} via {callee.name}", ctx,
                            unpacked)
                        if f is not None:
                            out.setdefault((f.line, f.col), f)
        return out.values()

    @staticmethod
    def _resolve(cls: ast.ClassDef, name: str,
                 classes: Dict[str, ast.ClassDef]) -> Optional[ast.AST]:
        """``self.name`` on an instance of ``cls``: its own method, else
        the first base class of the file that defines it."""
        seen: Set[str] = set()
        todo = [cls]
        while todo:
            c = todo.pop(0)
            if c.name in seen:
                continue
            seen.add(c.name)
            for m in c.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and m.name == name:
                    return m
            for b in c.bases:
                base = classes.get((_dotted(b) or "").rsplit(".", 1)[-1])
                if base is not None:
                    todo.append(base)
        return None

    def _per_iteration(self, loop: ast.AST, cls: ast.ClassDef,
                       classes: Dict[str, ast.ClassDef]) -> List[ast.AST]:
        """The methods a loop of ``cls`` calls through ``self.m(...)``,
        transitively, as this file resolves them: their bodies run once
        per iteration too (the port's loops keep the step in a helper,
        ``_iterate``). The sync funnels themselves are not entered —
        their call is the finding."""
        seen: Set[str] = set()
        out: List[ast.AST] = []
        todo = [loop]
        while todo:
            body = todo.pop()
            for n in ast.walk(body):
                if not (isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and isinstance(n.func.value, ast.Name)
                        and n.func.value.id == "self"):
                    continue
                name = n.func.attr
                if name in seen or name in self._SYNC_TAILS:
                    continue
                seen.add(name)
                m = self._resolve(cls, name, classes)
                if m is not None:
                    out.append(m)
                    todo.append(m)
        return out

    _REDUCTIONS = {"sum", "max", "min", "any", "all", "count_nonzero"}

    def _check_read(self, node, where, ctx, unpacked):
        """The host reads of a per-iteration helper: the explicit ones,
        and ``int()``/``float()`` of a tensor reduction or of a name the
        helper unpacked from a call's tuple (the executors' merges return
        (values, counter) pairs). Its other arguments come from the
        caller, whose types the AST cannot see, so they are not
        judged."""
        if not isinstance(node, ast.Call):
            return None
        name = _dotted(node.func) or ""
        if name.rsplit(".", 1)[-1] in self._SYNC_TAILS or (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in self._HOST_METHODS
                and not node.args):
            return self._check_call(node, where, set(), ctx)
        if name in ("float", "int") and len(node.args) == 1:
            arg = node.args[0]
            reduced = (isinstance(arg, ast.Call)
                       and isinstance(arg.func, ast.Attribute)
                       and arg.func.attr in self._REDUCTIONS)
            if reduced or (isinstance(arg, ast.Name) and arg.id in unpacked):
                return self._check_call(node, where, set(), ctx)
        return None

    @staticmethod
    def _unpacked(fn: ast.AST) -> Set[str]:
        """Names ``fn`` binds by unpacking a call's tuple result."""
        out: Set[str] = set()
        for a in ast.walk(fn):
            if isinstance(a, ast.Assign) and isinstance(a.value, ast.Call):
                for t in a.targets:
                    if isinstance(t, (ast.Tuple, ast.List)):
                        out.update(e.id for e in t.elts
                                   if isinstance(e, ast.Name))
        return out

    def _is_sync(self, call: ast.AST) -> bool:
        """A call that reads the device on the host: a sync funnel or a
        tensor-to-host method."""
        if not isinstance(call, ast.Call):
            return False
        name = _dotted(call.func) or ""
        if name.rsplit(".", 1)[-1] in self._SYNC_TAILS:
            return True
        return (isinstance(call.func, ast.Attribute)
                and call.func.attr in self._HOST_METHODS)

    def _host_tainted(self, fn: ast.AST) -> Set[str]:
        """Names holding already-fetched host values: assigned (possibly
        transitively) from a host read. Converting those again
        (int()/np.asarray()/.tolist()) is free — don't flag it."""
        assigns = sorted(
            (n for n in ast.walk(fn)
             if isinstance(n, (ast.Assign, ast.AugAssign))),
            key=lambda n: n.lineno,
        )
        tainted: Set[str] = set()
        for a in assigns:
            rhs = a.value
            from_get = any(self._is_sync(c) for c in ast.walk(rhs))
            if not (from_get or (_names_in(rhs) & tainted)):
                continue
            targets = a.targets if isinstance(a, ast.Assign) else [a.target]
            for t in targets:
                elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
                tainted.update(
                    e.id for e in elts if isinstance(e, ast.Name)
                )
        return tainted

    def _arg_is_host(self, arg: ast.AST, host_names: Set[str]) -> bool:
        if isinstance(arg, ast.Constant):
            return True
        if _names_in(arg) & host_names:
            return True
        # np.asarray(t.cpu()): the inner read is the finding.
        return any(self._is_sync(c) for c in ast.walk(arg))

    def _check_call(self, node, fn_name, host_names, ctx):
        if not isinstance(node, ast.Call):
            return None
        name = _dotted(node.func)
        tail = (name or "").rsplit(".", 1)[-1]
        if tail in self._SYNC_TAILS:
            return self.finding(
                ctx, node,
                f"`{name}` inside hot loop of `{fn_name}` stalls the "
                "device pipeline; hoist it out of the loop or suppress "
                "with a reason",
            )
        if name in self._ASARRAY and node.args and not self._arg_is_host(
            node.args[0], host_names
        ):
            return self.finding(
                ctx, node,
                f"`{name}` on a device value inside hot loop of "
                f"`{fn_name}` forces a device->host transfer per "
                "iteration",
            )
        if name in ("float", "int") and len(node.args) == 1 and \
                not self._arg_is_host(node.args[0], host_names):
            return self.finding(
                ctx, node,
                f"`{name}()` on a device value inside hot loop of "
                f"`{fn_name}` blocks on the device per iteration",
            )
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in self._HOST_METHODS and not node.args and \
                not self._arg_is_host(node.func.value, host_names):
            return self.finding(
                ctx, node,
                f"`.{node.func.attr}()` inside hot loop of `{fn_name}` is "
                "a synchronous device->host read per iteration",
            )
        return None


class RecompileHygiene(Rule):
    id = "LUX002"
    title = "recompile-hygiene"
    doc = ("torch.compile'd callables must not be fed bare Python "
           "scalars (each distinct value specialises and recompiles); "
           "lux_tpu's donate_argnums half has no counterpart (no jax.jit)")

    _COMPILE = ("torch.compile",)

    def check(self, tree: ast.Module, ctx: FileContext) -> Iterable[Finding]:
        out: List[Finding] = []
        # binding name -> True when compiled with dynamic=True (scalars
        # are then symbolic, not specialised).
        bindings: Dict[str, bool] = {}

        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ) and _dotted(node.value.func) in self._COMPILE:
                dynamic = self._dynamic(node.value)
                for t in node.targets:
                    bind = t.id if isinstance(t, ast.Name) else (
                        t.attr if isinstance(t, ast.Attribute) else None
                    )
                    if bind is not None:
                        bindings[bind] = dynamic
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    dec_call = dec if isinstance(dec, ast.Call) else None
                    name = _dotted(dec_call.func if dec_call else dec)
                    if name in self._COMPILE:
                        bindings[node.name] = (
                            dec_call is not None and self._dynamic(dec_call))

        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            bind = None
            if isinstance(node.func, ast.Name):
                bind = node.func.id
            elif isinstance(node.func, ast.Attribute):
                bind = node.func.attr
            if bind not in bindings or bindings[bind]:
                continue
            scalars = [
                a for a in list(node.args) + [k.value for k in node.keywords]
                if isinstance(a, ast.Constant)
                and type(a.value) in (int, float)
            ]
            for a in scalars:
                out.append(self.finding(
                    ctx, a,
                    f"Python scalar {a.value!r} fed to torch.compile'd "
                    f"`{bind}` — every distinct value specialises and "
                    "recompiles; pass it as a tensor or compile with "
                    "dynamic=True",
                ))
        return out

    @staticmethod
    def _dynamic(call: ast.Call) -> bool:
        return any(k.arg == "dynamic" and isinstance(k.value, ast.Constant)
                   and k.value.value is True for k in call.keywords)


def _dtype_name(node: ast.AST) -> Optional[str]:
    """'int8' for np.int8 / torch.int8 / "int8"; None for anything that
    names no dtype (a device, a tensor)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value if node.value in _DTYPES else None
    tail = (_dotted(node) or "").rsplit(".", 1)[-1]
    return tail if tail in _DTYPES else None


class KernelShapeContract(Rule):
    id = "LUX003"
    title = "kernel-shape-contract"
    doc = ("kernel dtype contract at the wrappers of ops/*kernel*.py: "
           "int8 code planes, int32 row indices (ops/merge_tail_plan.py "
           "layout rules); lux_tpu's BlockSpec half has no counterpart "
           "(no Pallas)")

    _CODE_DTYPES = {"int8", "int32"}   # codes upcast to int32 in-kernel
    _ROW_DTYPES = {"int32"}

    def applies_to(self, ctx: FileContext) -> bool:
        return "ops/" in ctx.posix_path and \
            "kernel" in ctx.posix_path.rsplit("/", 1)[-1]

    def check(self, tree: ast.Module, ctx: FileContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            cast = self._cast(node)
            if cast is None:
                continue
            ident, dtype = cast
            ident = (ident or "").lower()
            if "code" in ident and dtype not in self._CODE_DTYPES:
                out.append(self.finding(
                    ctx, node,
                    f"code plane `{ident}` cast to {dtype} — the routing "
                    "plane contract is int8 at rest (int32 in-kernel)",
                ))
            elif "row" in ident and dtype not in self._ROW_DTYPES:
                out.append(self.finding(
                    ctx, node,
                    f"row-index `{ident}` cast to {dtype} — kernel row "
                    "offsets must be int32 on device",
                ))
        return out

    @staticmethod
    def _cast(node: ast.Call) -> Optional[Tuple[Optional[str], str]]:
        """(identifier cast, dtype) of a `.astype(dt)` / `.to(..., dt)`
        call or of any call with a `dtype=` keyword, else None."""
        for k in node.keywords:
            if k.arg == "dtype":
                dtype = _dtype_name(k.value)
                if dtype is None:
                    return None
                if isinstance(node.func, ast.Attribute) and \
                        node.func.attr == "to":
                    return _root_ident(node.func.value), dtype
                return (_root_ident(node.args[0]) if node.args
                        else None), dtype
        if not isinstance(node.func, ast.Attribute):
            return None
        if node.func.attr not in ("astype", "to"):
            return None
        for a in node.args:
            dtype = _dtype_name(a)
            if dtype is not None:
                return _root_ident(node.func.value), dtype
        return None


def _env_key(call: ast.Call) -> Optional[str]:
    """The literal LUX_* key of an os.environ access, if any."""
    if call.args and isinstance(call.args[0], ast.Constant) and \
            isinstance(call.args[0].value, str) and \
            call.args[0].value.startswith("LUX_"):
        return call.args[0].value
    return None


class EnvFlagRegistry(Rule):
    id = "LUX004"
    title = "env-flag-registry"
    doc = ("every LUX_* env key touched anywhere must be declared in "
           "lux_tpu_torch/utils/flags.py; flags.define() outside that "
           "file is registry drift")

    _ENV_CALLS = ("environ.get", "environ.setdefault", "environ.pop",
                  "getenv")
    _FLAG_CALLS = ("get", "get_int", "get_float", "get_bool", "tristate")

    @staticmethod
    def _define_aliases(tree: ast.Module) -> Set[str]:
        """Local names bound to utils.flags.define by imports."""
        out: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.endswith("utils.flags"):
                out.update(
                    a.asname or a.name for a in node.names
                    if a.name == "define"
                )
        return out

    def check(self, tree: ast.Module, ctx: FileContext) -> Iterable[Finding]:
        out: List[Finding] = []
        in_registry = ctx.posix_path.endswith("utils/flags.py")
        define_aliases = self._define_aliases(tree)
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and not in_registry:
                name = _dotted(node.func) or ""
                if name.endswith("flags.define") or name in define_aliases:
                    out.append(self.finding(
                        ctx, node,
                        "flags.define() outside lux_tpu_torch/utils/"
                        "flags.py — the registry is the single "
                        "declaration site; LUX004's allowed-key set is "
                        "generated from it",
                    ))
        for node in ast.walk(tree):
            key = None
            if isinstance(node, ast.Call):
                name = _dotted(node.func) or ""
                short = name.rsplit(".", 1)[-1]
                if any(name.endswith(c) for c in self._ENV_CALLS):
                    key = _env_key(node)
                elif short in self._FLAG_CALLS and (
                    "flags." in name or name.startswith("flags")
                ):
                    key = _env_key(node)
            elif isinstance(node, ast.Subscript):
                name = _dotted(node.value) or ""
                if name.endswith("environ") and isinstance(
                    node.slice, ast.Constant
                ) and isinstance(node.slice.value, str) and \
                        node.slice.value.startswith("LUX_"):
                    key = node.slice.value
            if key is not None and key not in ctx.declared_flags:
                out.append(self.finding(
                    ctx, node,
                    f"undeclared flag {key} — declare it in "
                    "lux_tpu_torch/utils/flags.py so the registry stays "
                    "the single source of truth",
                ))
        return out


class DirectEnvRead(Rule):
    id = "LUX005"
    title = "direct-env-read"
    doc = ("lux_tpu_torch code must read LUX_* knobs through "
           "lux_tpu_torch.utils.flags, not os.environ (writes stay legal)")

    def applies_to(self, ctx: FileContext) -> bool:
        return "lux_tpu_torch/" in ctx.posix_path and \
            not ctx.posix_path.endswith("utils/flags.py")

    def check(self, tree: ast.Module, ctx: FileContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for node in ast.walk(tree):
            key = None
            if isinstance(node, ast.Call):
                name = _dotted(node.func) or ""
                if name.endswith("environ.get") or name.endswith("getenv"):
                    key = _env_key(node)
            elif isinstance(node, ast.Subscript) and isinstance(
                node.ctx, ast.Load
            ):
                name = _dotted(node.value) or ""
                if name.endswith("environ") and isinstance(
                    node.slice, ast.Constant
                ) and isinstance(node.slice.value, str) and \
                        node.slice.value.startswith("LUX_"):
                    key = node.slice.value
            if key is not None:
                out.append(self.finding(
                    ctx, node,
                    f"direct os.environ read of {key} — use "
                    "lux_tpu_torch.utils.flags accessors (typed, "
                    "documented, registry-checked)",
                ))
        return out


class ClockDiscipline(Rule):
    id = "LUX006"
    title = "clock-discipline"
    doc = ("serve/engine code takes timestamps through the obs helpers "
           "(spans.clock for durations, spans.monotonic for deadlines), "
           "not raw time.* — mixed clock sources make latency math and "
           "trace alignment silently wrong")

    _CLOCK_CALLS = {
        "time.time", "time.perf_counter", "time.monotonic",
        "time.perf_counter_ns", "time.monotonic_ns",
    }

    def applies_to(self, ctx: FileContext) -> bool:
        if "obs/" in ctx.posix_path:      # the helpers themselves
            return False
        return "serve/" in ctx.posix_path or "engine/" in ctx.posix_path

    def check(self, tree: ast.Module, ctx: FileContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func)
            if name in self._CLOCK_CALLS:
                out.append(self.finding(
                    ctx, node,
                    f"direct {name}() in serve/engine code — use "
                    "lux_tpu_torch.obs.spans.clock() (perf_counter, "
                    "trace epoch) or spans.monotonic() (deadlines) so "
                    "every latency shares one clock source",
                ))
        return out


class SwallowedException(Rule):
    id = "LUX007"
    title = "swallowed-exception"
    doc = ("serve/engine handlers catching Exception/BaseException (or "
           "bare except) must not reduce to log-and-drop — re-raise, "
           "convert to a typed ServeError, resolve the request's future, "
           "or record state the caller observes")

    # A handler whose whole body is pass/continue/bare-return plus calls
    # that only say something matches "swallow". Matching is on the
    # dotted-name parts, so self.log.warning, logging.error, print, and
    # logger.exception all count as log-only; metrics increments, future
    # resolution, and flight dumps count as real work (observable state).
    _LOG_PARTS = frozenset((
        "log", "logger", "logging", "print", "warn", "warning", "debug",
        "info", "error", "exception",
    ))

    def applies_to(self, ctx: FileContext) -> bool:
        return "serve/" in ctx.posix_path or "engine/" in ctx.posix_path

    @classmethod
    def _broad(cls, handler: ast.ExceptHandler) -> bool:
        if handler.type is None:            # bare except
            return True
        elts = (handler.type.elts if isinstance(handler.type, ast.Tuple)
                else [handler.type])
        return any((_dotted(e) or "") in ("Exception", "BaseException")
                   for e in elts)

    @classmethod
    def _inert(cls, stmt: ast.stmt) -> bool:
        """True for statements that drop the error on the floor."""
        if isinstance(stmt, (ast.Pass, ast.Continue)):
            return True
        if isinstance(stmt, ast.Return):
            return stmt.value is None or (
                isinstance(stmt.value, ast.Constant)
                and stmt.value.value is None
            )
        if isinstance(stmt, ast.Expr):
            if isinstance(stmt.value, ast.Constant):
                return True                 # stray docstring
            if isinstance(stmt.value, ast.Call):
                name = _dotted(stmt.value.func) or ""
                return any(p.lower() in cls._LOG_PARTS
                           for p in name.split("."))
        return False

    def check(self, tree: ast.Module, ctx: FileContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not self._broad(node):
                continue
            if all(self._inert(s) for s in node.body):
                caught = ("bare except" if node.type is None
                          else _dotted(node.type) or "broad except")
                out.append(self.finding(
                    ctx, node,
                    f"{caught} swallows the error (log-and-drop body) — "
                    "re-raise, map to a typed ServeError, or make the "
                    "failure observable (resolve the future / record "
                    "state); silent drops hide real engine faults",
                ))
        return out


class MetricNameDiscipline(Rule):
    id = "LUX008"
    title = "metric-name-discipline"
    doc = ("metric names must match lux_[a-z0-9_]+(_total|_seconds|"
           "_bytes)? and handles must not be minted per call: every "
           "counter/gauge/histogram factory call round-trips the "
           "registry lock, so creation is banned inside loops, and in "
           "obs/ code a constant-shaped handle (literal name, no or "
           "constant labels) must live at module scope")

    _NAME_RE = re.compile(r"lux_[a-z0-9_]+(_total|_seconds|_bytes)?")
    _FACTORIES = frozenset(("counter", "gauge", "histogram"))

    def check(self, tree: ast.Module, ctx: FileContext) -> Iterable[Finding]:
        out: List[Finding] = []
        bare = self._bare_factory_names(tree)
        in_obs = "obs/" in ctx.posix_path
        # One pass with explicit ancestry: (in a def, in a loop) per node.
        # At most ONE finding per creation call — bad name beats
        # loop-mint beats module-scope, so each site reads as one defect.
        stack: List[Tuple[ast.AST, bool, bool]] = [(tree, False, False)]
        while stack:
            node, in_def, in_loop = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                in_def = True
            elif isinstance(node, (ast.For, ast.While)):
                in_loop = True
            elif isinstance(node, ast.Call):
                f = self._check_creation(node, ctx, bare, in_obs,
                                         in_def, in_loop)
                if f is not None:
                    out.append(f)
            for child in ast.iter_child_nodes(node):
                stack.append((child, in_def, in_loop))
        return out

    def _bare_factory_names(self, tree: ast.Module) -> Set[str]:
        """Factory names bound by ``from ...metrics import counter, ...``
        anywhere in the file (engine code imports them function-locally)."""
        names: Set[str] = set()
        for node in ast.walk(tree):
            if not isinstance(node, ast.ImportFrom):
                continue
            if not (node.module or "").endswith("metrics"):
                continue
            names.update(
                a.asname or a.name for a in node.names
                if a.name in self._FACTORIES)
        return names

    def _is_factory(self, node: ast.Call, bare: Set[str]) -> bool:
        func = node.func
        if isinstance(func, ast.Name):
            return func.id in bare
        name = _dotted(func)
        if name is None:
            return False
        parts = name.split(".")
        return parts[-1] in self._FACTORIES and "metrics" in parts[:-1]

    @staticmethod
    def _constant_labels(node: ast.Call) -> bool:
        """True when the labels argument is absent, None, or a literal
        dict of literal keys/values — i.e. the handle has a fixed shape
        and the creation could be hoisted verbatim."""
        labels: Optional[ast.expr] = None
        if len(node.args) > 1:
            labels = node.args[1]
        for kw in node.keywords:
            if kw.arg == "labels":
                labels = kw.value
        if labels is None:
            return True
        if isinstance(labels, ast.Constant):
            return labels.value is None
        if isinstance(labels, ast.Dict):
            return all(isinstance(k, ast.Constant) for k in labels.keys) \
                and all(isinstance(v, ast.Constant) for v in labels.values)
        return False

    def _check_creation(self, node: ast.Call, ctx: FileContext,
                        bare: Set[str], in_obs: bool,
                        in_def: bool, in_loop: bool) -> Optional[Finding]:
        if not self._is_factory(node, bare):
            return None
        name_arg = node.args[0] if node.args else None
        literal = (name_arg.value
                   if isinstance(name_arg, ast.Constant)
                   and isinstance(name_arg.value, str) else None)
        if literal is not None and not self._NAME_RE.fullmatch(literal):
            return self.finding(
                ctx, node,
                f"metric name {literal!r} breaks the naming contract — "
                "must match lux_[a-z0-9_]+(_total|_seconds|_bytes)? "
                "(lux_ prefix, lowercase snake_case, unit suffix for "
                "counters/durations/sizes)")
        hoistable = literal is not None and self._constant_labels(node)
        if in_loop and hoistable:
            return self.finding(
                ctx, node,
                f"metric handle {literal!r} minted inside a loop — each "
                "factory call takes the registry lock; create the handle "
                "once outside the loop and reuse it")
        if in_obs and in_def and hoistable:
            return self.finding(
                ctx, node,
                f"constant-shaped metric handle {literal!r} created per "
                "call — literal name with no/constant labels belongs at "
                "module scope; per-call creation churns the registry "
                "lock on every invocation")
        return None


class RegionNameDiscipline(Rule):
    id = "LUX009"
    title = "region-name-discipline"
    doc = ("profiler region names must match lux\\.[a-z0-9_.]+: a "
           "literal name passed to prof.region, "
           "torch.profiler.record_function or torch.cuda.nvtx.range_push "
           "/ range (or a named_scope / TraceAnnotation) that breaks the "
           "pattern never joins the profile.v1 phase accounting (the "
           "parser only classifies lux.* tags), so the time it brackets "
           "silently vanishes from exchange/compute attribution")

    _NAME_RE = re.compile(r"lux\.[a-z0-9_.]+")
    # Dotted-call tails that take a region name as their first argument,
    # however the module is spelled locally. `region` alone is also
    # tracked when imported bare from obs.prof (mirrors LUX008's
    # bare-factory tracking); nvtx's `range` only under an nvtx module.
    _TAILS = frozenset(("record_function", "range_push", "named_scope",
                        "TraceAnnotation"))

    def _bare_region_names(self, tree: ast.Module) -> Set[str]:
        """Names bound by ``from ...prof import region`` (or an asname
        of it) anywhere in the file."""
        names: Set[str] = set()
        for node in ast.walk(tree):
            if not isinstance(node, ast.ImportFrom):
                continue
            if not (node.module or "").endswith("prof"):
                continue
            names.update(a.asname or a.name for a in node.names
                         if a.name == "region")
        return names

    def _is_region_call(self, node: ast.Call, bare: Set[str]) -> bool:
        func = node.func
        if isinstance(func, ast.Name):
            return func.id in bare
        name = _dotted(func)
        if name is None:
            return False
        parts = name.split(".")
        tail = parts[-1]
        if tail == "region":
            return "prof" in parts[:-1]
        if tail == "range":
            return "nvtx" in parts[:-1]
        return tail in self._TAILS

    def check(self, tree: ast.Module, ctx: FileContext) -> Iterable[Finding]:
        out: List[Finding] = []
        bare = self._bare_region_names(tree)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            if not self._is_region_call(node, bare):
                continue
            name_arg = node.args[0] if node.args else None
            literal = (name_arg.value
                       if isinstance(name_arg, ast.Constant)
                       and isinstance(name_arg.value, str) else None)
            if literal is None:
                continue    # dynamic names validate at runtime
            if not self._NAME_RE.fullmatch(literal):
                out.append(self.finding(
                    ctx, node,
                    f"region name {literal!r} breaks the naming contract "
                    "— must fullmatch lux.[a-z0-9_.]+ (lux. prefix, "
                    "lowercase dotted segments) or the profile.v1 parser "
                    "drops it from phase attribution"))
        return out


class LedgerDiscipline(Rule):
    id = "LUX010"
    title = "ledger-discipline"
    doc = ("run metrics (summaries, telemetry) leave the process through "
           "the run ledger (lux_tpu_torch/obs/ledger.py record_run), not "
           "ad-hoc json.dump — an unframed dump is invisible to the "
           "ledger's readers and the auto-tuner corpus, and carries no "
           "config_hash to reproduce it under")

    # Dumping an expression rooted at one of these identifiers is the
    # run-metrics shape this rule polices; artifact writes (plans,
    # reports, flight docs) keep their own formats.
    _METRIC_IDENTS = ("summary", "telemetry", "runrec", "run_record",
                      "metrics")

    def applies_to(self, ctx: FileContext) -> bool:
        p = ctx.posix_path
        if p.endswith("obs/ledger.py") or p.endswith("obs/report.py"):
            # The ledger's own framing, and the documented legacy
            # LUX_METRICS JSON-lines dump report.finalize still feeds.
            return False
        return ("engine/" in p or "serve/" in p or "obs/" in p
                or p.endswith("bench.py"))

    def check(self, tree: ast.Module, ctx: FileContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func) or ""
            if name not in ("json.dump", "json.dumps"):
                continue
            arg = node.args[0] if node.args else None
            root = (_root_ident(arg) or "").lower() if arg is not None \
                else ""
            if any(tok in root for tok in self._METRIC_IDENTS):
                out.append(self.finding(
                    ctx, node,
                    f"ad-hoc json dump of run metrics ({root!r}) — append "
                    "a runrec.v1 record via lux_tpu_torch.obs.ledger."
                    "record_run so the observation is durable, "
                    "crc-framed, and keyed by (graph, program, engine, "
                    "mesh, config_hash)",
                ))
        return out


def all_rules() -> List[Rule]:
    return [
        HostSyncInHotLoop(),
        RecompileHygiene(),
        KernelShapeContract(),
        EnvFlagRegistry(),
        DirectEnvRead(),
        ClockDiscipline(),
        SwallowedException(),
        MetricNameDiscipline(),
        RegionNameDiscipline(),
        LedgerDiscipline(),
    ]
