"""Torch traces of a step: the counterpart of ``jax.make_jaxpr`` and
``iter_eqns`` of ``lux_tpu/analysis/ir.py`` for the trace tiers.

``lux_tpu`` traces a jitted step abstractly into a jaxpr. A torch step
is eager, so :func:`trace_call` runs it once, on real tensors of its
device, under a ``TorchDispatchMode`` and records an ordered list of
:class:`Node` s:

- every aten op the step dispatches (``kind="aten"``), its op name as
  ``aten.<op>.<overload>``;
- every public kernel wrapper (``kind="kernel"``, ``lux.<kernel>``):
  the wrappers are decorated with
  :func:`~lux_tpu_torch.utils.tracehooks.kernel`, *above* their
  CPU/CUDA branch, so a kernel is one node on the card (where the
  ctypes launch is invisible to the dispatcher) and on the CPU (where
  the plain twin's ops are folded into it);
- every collective of a mesh (``kind="collective"``, ``all_gather``,
  ``all_to_all``, ``reduce_scatter``;
  :func:`~lux_tpu_torch.utils.tracehooks.collective`), with the
  bytes ``lux_tpu`` prices for it (``nbytes``), also where it is a view
  on one card;
- every host read (``kind="host"``): ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()``, ``np.asarray`` of a tensor, a scalar read
  (``int``/``float``/``bool`` of a tensor), a copy of a CUDA tensor to
  the CPU, and ``torch.cuda.synchronize``.

Tensors are tracked by storage, as :class:`Buffer` s with a version per
write, so in-place ops (``index_copy_``, ``scatter_``, ``out +=``) and
views (``buf.view(...)[:, :-1]``) keep the dataflow exact: a node reads
``(buffer, version)`` pairs and an in-place node writes a new version.
A collective's output is a buffer of its own even when it is a view of
its input. Buffers that exist before the trace (the example args, the
executor's device graph, a kernel's cached scratch) are *pinned*; each
buffer records its defining and last-use node, what a liveness walk
reads. Every tensor the trace sees is kept alive until it ends, so a
storage is never reused under another buffer's name.

Nodes may sit inside
:func:`~lux_tpu_torch.utils.tracehooks.alternatives`: the branches a host
decision picks among (``lux_tpu``'s ``lax.cond``). A traced step runs
every branch and returns the one the host would take; each node keeps
the branches it sits in (:attr:`Node.alt`).

The marks live in :mod:`lux_tpu_torch.utils.tracehooks`, below the
layers that carry them; this module attaches a recorder there. With no
trace live, a decorated wrapper costs one global check per call. A
trace covers the thread that starts it; other threads' ops are not
recorded. ``TorchDispatchMode`` costs a one-time set-up the first
time a process enters one, so the tier pays it once per process.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from lux_tpu_torch.utils import tracehooks as hooks

__all__ = ["Buffer", "Node", "Ref", "Trace", "bare_call", "clone_args",
           "kernel_sequence", "leaves", "trace_call"]

_PATCH_LOCK = threading.Lock()   # serialises attach, detach and patching
_PATCHED: list = []              # (owner, attr, original) while live

# Creation ops whose every element is one constant: op -> the constant.
_FILLS: Dict[str, Callable[[tuple, dict], Any]] = {
    "aten.zeros.default": lambda a, k: 0,
    "aten.new_zeros.default": lambda a, k: 0,
    "aten.zeros_like.default": lambda a, k: 0,
    "aten.ones.default": lambda a, k: 1,
    "aten.new_ones.default": lambda a, k: 1,
    "aten.ones_like.default": lambda a, k: 1,
    "aten.full.default": lambda a, k: a[1],
    "aten.new_full.default": lambda a, k: a[2],
    "aten.full_like.default": lambda a, k: a[1],
    "aten.scalar_tensor.default": lambda a, k: a[0],
}
# Ops that copy a constant buffer's value unchanged into a new one.
_KEEPS_FILL = ("aten._to_copy.default", "aten.clone.default",
               "aten.expand_copy.default", "aten.repeat.default",
               "aten.contiguous.default")
# Data operand of each in-place write op (its other tensors are indices).
_WRITE_DATA = {"index_copy_": 3, "index_put_": 2, "scatter_": 3,
               "scatter_add_": 3, "scatter_reduce_": 3, "copy_": 1,
               "masked_scatter_": 2, "add_": 1, "put_": 2}


@dataclasses.dataclass
class Buffer:
    """One storage the trace saw."""

    lid: int
    nbytes: int                   # the storage's bytes
    dtype: torch.dtype
    shape: tuple                  # of the tensor it was first seen as
    pinned: bool                  # existed before the trace
    arg: Optional[int] = None     # argnum of the example arg holding it
    defined_by: int = 0           # node that created it (0: pinned)
    last_use: int = 0             # last node reading or writing it
    fill: Any = None              # the constant it was filled with
    fill_version: int = 0         # its version right after that fill
    version: int = 0              # writes since creation
    input_derived: bool = False   # computed from the example args
    tainted: bool = False         # computed from a data collective


@dataclasses.dataclass(frozen=True)
class Ref:
    """A tensor as a node saw it: its buffer at a version."""

    lid: int
    version: int
    shape: tuple
    dtype: torch.dtype
    nbytes: int                   # numel x itemsize of this view

    def sig(self) -> tuple:
        return (self.shape, str(self.dtype).replace("torch.", ""))


@dataclasses.dataclass
class Node:
    """One recorded op, kernel, collective or host read."""

    index: int                    # 1-based, in execution order
    op: str
    kind: str                     # aten | kernel | collective | host
    inputs: List[Ref]
    outputs: List[Ref]
    writes: List[Ref]             # inputs written in place (new version)
    fresh: List[bool]             # per output: a buffer this node made
    scalars: tuple = ()           # number/bool arguments
    nbytes: int = 0               # a collective's priced bytes
    alt: tuple = ()               # ((group, branch), ...) it sits in
    args: List[Ref] = dataclasses.field(default_factory=list)
    data: Optional[Ref] = None    # an in-place write's data operand
    taint: bool = False           # an input it does not write came
    #                               from a data collective
    data_taint: bool = False      # the write's data operand did
    data_input: bool = False      # the write's data came from the args


@dataclasses.dataclass
class Trace:
    """What :func:`trace_call` recorded."""

    nodes: List[Node]
    buffers: Dict[int, Buffer]
    in_leaves: list               # Ref or the Python value, per arg leaf
    out_leaves: list              # Ref or the Python value, per output leaf
    arg_lids: List[set]           # buffers of each example arg
    seconds: float = 0.0
    device: str = ""
    groups: Dict[int, int] = dataclasses.field(default_factory=dict)

    def input_bytes(self) -> int:
        """Bytes of every pinned buffer the step read (the example args,
        the device graph, scratch): ``lux_tpu``'s in_avals plus consts."""
        return sum(b.nbytes for b in self.buffers.values() if b.pinned)

    def largest_intermediate(self) -> int:
        return max((r.nbytes for n in self.nodes
                    for r, f in zip(n.outputs, n.fresh) if f), default=0)


def _skey(t: torch.Tensor):
    st = t.untyped_storage()
    ptr = st.data_ptr()
    if ptr == 0 or st.nbytes() == 0:
        return None          # empty: no storage to share
    return (t.device.type, t.device.index, ptr)


def _flat(obj, out: list, depth: int = 0) -> list:
    """Tensors and scalars of ``obj`` in order, through tuples, lists,
    dicts, named tuples and dataclasses (``depth`` levels)."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (bool, int, float, str)) or obj is None:
        out.append(obj)
    elif depth < 4 and isinstance(obj, (tuple, list)):
        for x in obj:
            _flat(x, out, depth + 1)
    elif depth < 4 and isinstance(obj, dict):
        for x in obj.values():
            _flat(x, out, depth + 1)
    elif depth < 4 and dataclasses.is_dataclass(obj) \
            and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _flat(getattr(obj, f.name), out, depth + 1)
    return out


def leaves(obj) -> list:
    """The leaves of a step's args or outputs, as ``lux_tpu`` flattens a
    pytree: tensors and Python values through tuples, lists, dicts,
    named tuples and dataclasses."""
    return _flat(obj, [])


class _Recorder:
    """The state of one live trace."""

    def __init__(self):
        self.nodes: List[Node] = []
        self.buffers: Dict[int, Buffer] = {}
        self.by_key: Dict[tuple, int] = {}
        self.by_obj: Dict[int, int] = {}
        self.keep: list = []
        self.fold = 0
        self.alt: List[Tuple[int, int, str]] = []
        self.groups: Dict[int, int] = {}     # group -> its branches
        self.thread = threading.get_ident()

    # -- buffers ---------------------------------------------------------

    def _new(self, t: torch.Tensor, pinned: bool, node: int) -> int:
        lid = len(self.buffers) + 1
        st = t.untyped_storage()
        self.buffers[lid] = Buffer(
            lid, int(st.nbytes()), t.dtype, tuple(t.shape), pinned,
            defined_by=node, last_use=node)
        key = _skey(t)
        if key is not None and key not in self.by_key:
            self.by_key[key] = lid
        self.by_obj[id(t)] = lid
        self.keep.append(t)
        return lid

    def lid(self, t: torch.Tensor) -> int:
        lid = self.by_obj.get(id(t))
        if lid is not None:
            return lid
        key = _skey(t)
        lid = self.by_key.get(key) if key is not None else None
        if lid is None:
            return self._new(t, True, 0)
        self.by_obj[id(t)] = lid
        self.keep.append(t)
        return lid

    def ref(self, t: torch.Tensor) -> Ref:
        lid = self.lid(t)
        return Ref(lid, self.buffers[lid].version, tuple(t.shape), t.dtype,
                   t.numel() * t.element_size())

    # -- nodes -----------------------------------------------------------

    def record(self, op: str, kind: str, in_objs: list, out_objs: list,
               written: list, nbytes: int = 0, data=None,
               fill=None, direct=None) -> Node:
        """One node: ``in_objs`` the tensors and scalars it reads,
        ``out_objs`` what it returns, ``written`` the inputs it writes
        in place (``data`` the write's data operand), ``fill`` the
        constant a creation op fills its output with, ``direct`` the
        tensors passed as arguments themselves (default: every input
        tensor)."""
        index = len(self.nodes) + 1
        ins = [self.ref(t) for t in in_objs if isinstance(t, torch.Tensor)]
        args = (ins if direct is None else
                [self.ref(t) for t in direct if isinstance(t, torch.Tensor)])
        scalars = tuple(x for x in in_objs
                        if isinstance(x, (bool, int, float)))
        src_taint = any(self.buffers[r.lid].tainted for r in ins)
        src_input = any(self.buffers[r.lid].input_derived for r in ins)
        dest = {self.lid(t) for t in written}
        node_taint = any(self.buffers[r.lid].tainted for r in ins
                         if r.lid not in dest)
        data_ref = None
        data_taint = data_input = False
        if isinstance(data, torch.Tensor):
            data_ref = self.ref(data)
            db = self.buffers[data_ref.lid]
            data_taint, data_input = db.tainted, db.input_derived
        if fill is not None:
            src_taint = src_input = False   # a constant, whatever its like
        in_keys = {}
        for t in in_objs:
            if isinstance(t, torch.Tensor):
                k = _skey(t)
                if k is not None:
                    in_keys.setdefault(k, self.lid(t))
        outs, fresh = [], []
        for o in out_objs:
            if not isinstance(o, torch.Tensor):
                continue
            k = _skey(o)
            alias = in_keys.get(k) if k is not None else None
            if alias is not None and kind != "collective":
                self.by_obj[id(o)] = alias
                self.keep.append(o)
                fresh.append(False)
            else:
                lid = self._new(o, False, index)
                b = self.buffers[lid]
                b.tainted = src_taint or kind == "collective" and \
                    op in DATA_COLLECTIVES
                b.input_derived = src_input
                b.fill = fill
                fresh.append(True)
            outs.append(self.ref(o))
        writes = []
        for t in written:
            lid = self.lid(t)
            b = self.buffers[lid]
            b.version += 1
            b.tainted = b.tainted or src_taint
            b.input_derived = b.input_derived or src_input
            writes.append(self.ref(t))
        for r in ins + outs:
            self.buffers[r.lid].last_use = index
        node = Node(index, op, kind, ins, outs, writes, fresh, scalars,
                    int(nbytes), tuple(self.alt), args, data_ref,
                    node_taint, data_taint, data_input)
        self.nodes.append(node)
        return node

    def call(self, op: str, kind: str, fn, args, kwargs, nbytes=0,
             extra=None):
        """Run a marked kernel or collective as one node, its inner ops
        folded into it (``utils/tracehooks.py``)."""
        ins = leaves((args, kwargs))
        direct = [a for a in tuple(args) + tuple(kwargs.values())
                  if isinstance(a, torch.Tensor)]
        self.fold += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self.fold -= 1
        if extra is not None:
            ins = ins + list(extra(*args, **kwargs))
        outs = leaves(out)
        # A kernel writes the tensors it returns in place (``out=``); an
        # input it returns is written, the rest are read.
        keys = {_skey(o) for o in outs if isinstance(o, torch.Tensor)}
        keys.discard(None)
        written = [t for t in ins if isinstance(t, torch.Tensor)
                   and kind == "kernel" and _skey(t) in keys]
        self.record(op, kind, ins, [o for o in outs if not any(
            o is w for w in written)], written, nbytes=nbytes, direct=direct)
        return out

    def finish(self, args, out, seconds: float, device: str) -> Trace:
        arg_lids = []
        for a in args:
            arg_lids.append({self.lid(t) for t in leaves(a)
                             if isinstance(t, torch.Tensor)})
        in_leaves = [self.ref(x) if isinstance(x, torch.Tensor) else x
                     for x in leaves(args)]
        out_leaves = [self.ref(x) if isinstance(x, torch.Tensor) else x
                      for x in leaves(out)]
        return Trace(self.nodes, self.buffers, in_leaves, out_leaves,
                     arg_lids, seconds, device, dict(self.groups))


DATA_COLLECTIVES = ("all_gather", "all_to_all")


def _host_read(what: str, t=None) -> None:
    rec = hooks.current()
    if rec is None or rec.fold:
        return
    rec.record(f"host.{what}", "host",
               [t] if isinstance(t, torch.Tensor) else [], [], [])


def _reads_host(func, args, kwargs, aten) -> Optional[str]:
    """The device->host read an aten op makes, else None: every scalar
    read, and copies of a CUDA tensor to the CPU."""
    if func is aten._local_scalar_dense.default:
        return "item"
    if func is aten._to_copy.default and getattr(args[0], "is_cuda", False):
        dev = kwargs.get("device")
        if dev is not None and torch.device(dev).type == "cpu":
            return "cpu"
    if func is aten.copy_.default and len(args) > 1 and \
            getattr(args[1], "is_cuda", False) and \
            not getattr(args[0], "is_cuda", False):
        return "cpu"
    return None


def _schema_writes(func, args, kwargs) -> Tuple[list, Any]:
    """(tensors ``func`` writes in place, the data operand of the
    write)."""
    schema = func._schema
    written, data = [], None
    for i, a in enumerate(schema.arguments):
        info = a.alias_info
        if info is None or not info.is_write:
            continue
        v = args[i] if i < len(args) else kwargs.get(a.name)
        if isinstance(v, torch.Tensor):
            written.append(v)
    if written and not schema.name.endswith("_out"):
        pos = _WRITE_DATA.get(schema.name.split("::")[-1])
        if pos is not None and pos < len(args):
            data = args[pos]
    return written, data


def _fill_of(rec: _Recorder, name: str, args, kwargs):
    f = _FILLS.get(name)
    if f is not None:
        try:
            v = f(args, kwargs)
        except (IndexError, KeyError):
            return None
        return v if isinstance(v, (bool, int, float)) else None
    if name in _KEEPS_FILL and args and isinstance(args[0], torch.Tensor):
        b = rec.buffers.get(rec.by_obj.get(id(args[0]), -1))
        if b is not None and b.version == b.fill_version:
            return b.fill
    return None


def _make_mode():
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten

    class _Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            rec = hooks.current()
            if rec is None or rec.fold:
                return func(*args, **kwargs)
            host = _reads_host(func, args, kwargs, aten)
            if host is not None:
                out = func(*args, **kwargs)
                rec.record(f"host.{host}", "host",
                           [a for a in args if isinstance(a, torch.Tensor)],
                           [], [])
                return out
            name = str(func)
            written, data = _schema_writes(func, args, kwargs)
            fill = _fill_of(rec, name, args, kwargs)
            ins = leaves((args, kwargs))
            out = func(*args, **kwargs)
            node = rec.record(name, "aten", ins, leaves(out), written,
                              data=data, fill=fill)
            if name == "aten.fill_.Scalar" and written:
                b = rec.buffers[node.writes[0].lid]
                if b.version == 1 and b.defined_by:
                    b.fill, b.fill_version = args[1], 1
                    b.tainted = b.input_derived = False
            return out

    return _Mode()


def _patch() -> None:
    """Install the host-read hooks (the tensor methods that read a
    tensor on the host, and ``torch.cuda.synchronize``); refcounted by
    the live traces."""
    def hook(owner, attr, what):
        real = getattr(owner, attr)

        @functools.wraps(real)
        def call(*a, **k):
            rec = hooks.current()
            if rec is None or rec.fold:
                return real(*a, **k)
            _host_read(what, a[0] if a else None)
            rec.fold += 1
            try:
                return real(*a, **k)
            finally:
                rec.fold -= 1

        _PATCHED.append((owner, attr, real))
        setattr(owner, attr, call)

    for attr in ("item", "tolist", "cpu", "numpy", "__array__"):
        hook(torch.Tensor, attr, attr.strip("_"))
    hook(torch.cuda, "synchronize", "synchronize")


def _unpatch() -> None:
    while _PATCHED:
        owner, attr, real = _PATCHED.pop()
        setattr(owner, attr, real)


@contextlib.contextmanager
def _live(rec: _Recorder):
    with _PATCH_LOCK:
        if hooks.attach(rec) == 1:
            _patch()
    try:
        yield
    finally:
        with _PATCH_LOCK:
            if hooks.detach() == 0:
                _unpatch()


_MODE = None


def trace_call(fn: Callable, args: tuple = (), device=None) -> Trace:
    """Run ``fn(*args)`` once and record its :class:`Trace`. ``args``
    are used as given: pass copies where the step must not touch the
    caller's. ``device`` only labels the trace."""
    global _MODE
    rec = _Recorder()
    for i, a in enumerate(args):
        for t in leaves(a):
            if isinstance(t, torch.Tensor):
                b = rec.buffers[rec.lid(t)]
                b.arg = i if b.arg is None else b.arg
                b.input_derived = True
    if _MODE is None:
        _MODE = _make_mode()
    t0 = time.perf_counter()
    with _live(rec), _MODE:
        out = fn(*args)
    seconds = time.perf_counter() - t0
    if device is None:
        devs = [t.device for t in leaves(args) if isinstance(t, torch.Tensor)]
        device = devs[0] if devs else ""
    return rec.finish(args, out, seconds, str(device))


def bare_call(fn: Callable, args: tuple = ()) -> Trace:
    """Run ``fn(*args)`` once with no recorder: a :class:`Trace` with no
    nodes, whose args and outputs are bound by storage (enough for
    LUX104's donation audit, at the cost of one plain call)."""
    rec = _Recorder()
    t0 = time.perf_counter()
    out = fn(*args)
    return rec.finish(args, out, time.perf_counter() - t0, "")


def kernel_sequence(tr: Trace) -> List[tuple]:
    """The trace's kernel and collective nodes as (op, direct tensor
    args' shapes and dtypes, outputs' shapes and dtypes): what a CPU
    trace and a card trace of one step must share."""
    return [(n.op, tuple(r.sig() for r in n.args),
             tuple(r.sig() for r in n.outputs))
            for n in tr.nodes if n.kind in ("kernel", "collective")]


def clone_args(args: tuple) -> tuple:
    """Copies of the tensors in ``args`` (tuples, lists, named tuples and
    dicts rebuilt; other values kept), so a traced step never writes the
    caller's."""
    def cp(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(cp(v) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(cp(v) for v in x)
        if isinstance(x, dict):
            return {k: cp(v) for k, v in x.items()}
        return x
    return tuple(cp(a) for a in args)

