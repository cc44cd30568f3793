"""Device-timeline profiling: capture windows, region tags, and the
``profile.v1`` report; the counterpart of ``lux_tpu/obs/prof.py`` on
``torch.profiler``.

The engobs phase fencing (iterlog.set_overlap) reports an overlap
*budget*. This module measures the *realized* overlap from an actual
device timeline:

- ``region(name)`` tags a code block as a named engine region. While a
  capture window is live it enters ``torch.profiler.record_function``,
  which records a host span (``user_annotation``) and, with CUDA
  activity on, the matching device range (``gpu_user_annotation``).
  Otherwise entering it costs one check of a module flag. Names must
  match ``lux.[a-z0-9_.]+``, the grammar the parser classifies on
  (``.exchange`` / ``.compute``); other names raise ``ValueError``.
  Engines build their regions once, at import.
- ``trace(dirname)`` / ``profile_window(run)`` / SIGUSR2 (see
  ``install_signal_handler``) open capture windows with CPU and (on a
  card) CUDA activities; each writes one gzip Chrome trace,
  ``<dirname>/<host>_<pid>.<n>.pt.trace.json.gz``.
- ``parse_dir`` / ``parse`` read the artifact (stdlib ``gzip`` + ``json``
  only) into a ``profile.v1`` report: per-device interval-union wall
  time of exchange- and compute-tagged kernels, their intersection →
  ``realized_hidden_frac`` (comparable to the engobs budget), device
  idle fraction, a top-K kernel table, and a steps-per-second
  cross-check against an iterlog summary.

Reading torch's trace format: device work is every complete event of
category ``kernel``, ``gpu_memcpy`` or ``gpu_memset``, one device per
pid. A kernel's region tag comes first from the innermost
``gpu_user_annotation`` range of a ``lux.*`` region covering its start
on the same device and stream (pid and tid): kineto writes that range
on the stream's own timeline, so the join needs no host clock. Where a
capture has no such range (a kernel launched outside any device range,
or a profiler build without them), the tag comes from the kernel's
``correlation`` id: the CUDA runtime launch with the same id, and the
innermost ``lux.*`` ``user_annotation`` on that host thread whose span
covers the launch.
Host ``lux.*`` spans count in ``host_regions`` and never join the device
unions (a host span covering an asynchronous launch is not device
time).

``lux_tpu``'s ``op_map_from_hlo`` and ``op_map_for`` have no
counterpart: they read XLA's compiled HLO, and torch's trace names the
kernels themselves. ``op_maps`` is accepted by the parsers for the same
signatures and ignored.

Malformed artifacts (truncated gzip, broken JSON, non-numeric
timestamps, non-object events) raise ``ProfileParseError`` loudly — a
profile that cannot be trusted must never quietly report a wrong
overlap number.
"""

from __future__ import annotations

import bisect
import contextlib
import glob
import gzip
import itertools
import json
import os
import re
import signal
import socket
import threading

from lux_tpu_torch.utils import flags
from lux_tpu_torch.utils.locks import make_lock
from lux_tpu_torch.utils.logging import get_logger

_LOG = get_logger("prof")

# The region-name grammar. The parser classifies tags by their
# ``.exchange`` / ``.compute`` components.
NAME_RE = re.compile(r"lux\.[a-z0-9_.]+")

_EPS_US = 1e-3          # float-microsecond tolerance for invariants

# torch's Chrome-trace categories of device work, of device-side region
# ranges, of host region spans, and of CUDA runtime calls.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
GPU_RANGE_CAT = "gpu_user_annotation"
HOST_RANGE_CAT = "user_annotation"
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


class ProfileParseError(RuntimeError):
    """A captured artifact could not be parsed into a trustworthy
    report (truncated gzip, malformed JSON, non-numeric event fields,
    inconsistent interval math)."""


class CaptureBusyError(RuntimeError):
    """A profile capture window is already in flight in this process
    (torch.profiler supports one live session)."""


# -- region tagging --------------------------------------------------------

# Live while a capture window is open; regions read it on entry.
_live = [False]


class _Region:
    """A named engine region: ``record_function`` while a capture is
    live, else nothing. Reusable and reentrant across threads (each
    entry keeps its own profiler handle on a per-thread stack)."""

    __slots__ = ("name", "_local")

    def __init__(self, name: str):
        self.name = name
        self._local = threading.local()

    def __enter__(self):
        if _live[0]:
            from torch.profiler import record_function

            cm = record_function(self.name)
            cm.__enter__()
            stack = getattr(self._local, "stack", None)
            if stack is None:
                stack = self._local.stack = []
            stack.append(cm)
        return self

    def __exit__(self, *exc):
        stack = getattr(self._local, "stack", None)
        if stack:
            stack.pop().__exit__(*exc)
        return False


def region(name: str) -> _Region:
    """Tag a code block as a named engine region (e.g.
    ``lux.pull_sharded.exchange``). The name must match
    ``lux.[a-z0-9_.]+``."""
    if not NAME_RE.fullmatch(name):
        raise ValueError(
            f"region name {name!r} breaks the lux.[a-z0-9_.]+ grammar "
            "the profile parser classifies on")
    return _Region(name)


# -- capture windows -------------------------------------------------------

_CAP_IDS = itertools.count(1)
_capture_lock = threading.Lock()
_latest_lock = make_lock("obs.prof")
_latest_report = None
_sig_state = {"dir": None, "prof": None}


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _artifact_path(dirname: str) -> str:
    return os.path.join(
        dirname, f"{socket.gethostname()}_{os.getpid()}."
        f"{next(_CAP_IDS)}.pt.trace.json.gz")


def _export(profiler, dirname: str) -> str:
    """Write the capture as one gzip Chrome trace under ``dirname``."""
    path = _artifact_path(dirname)
    plain = path[:-len(".gz")]
    profiler.export_chrome_trace(plain)
    with open(plain, "rb") as src, gzip.open(path, "wb") as dst:
        dst.write(src.read())
    os.remove(plain)
    return path


def _start(dirname: str):
    import torch

    os.makedirs(dirname, exist_ok=True)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    p = torch.profiler.profile(activities=_activities())
    p.__enter__()
    _live[0] = True
    return p


def _stop(p, dirname: str) -> str:
    import torch

    try:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    finally:
        _live[0] = False
        p.__exit__(None, None, None)
    return _export(p, dirname)


@contextlib.contextmanager
def _capture(dirname: str):
    p = _start(dirname)
    try:
        yield p
    finally:
        _stop(p, dirname)


def trace(dirname):
    """Capture-window context manager writing one Chrome trace under
    ``dirname``, or an inert ``nullcontext`` when ``dirname`` is falsy
    (the models/cli.py ``-profile`` contract)."""
    if not dirname:
        return contextlib.nullcontext()
    return _capture(str(dirname))


def profile_window(run, dirname=None, steps=None, op_maps=None,
                   iterlog_summary=None, top_k=10):
    """Run ``run()`` inside a fresh capture window under ``dirname``
    (default ``LUX_PROF_DIR``), parse the artifact, publish it as
    ``latest()``, and return ``(run_result, report)``.
    ``iterlog_summary`` may be a callable, called after ``run()``, for a
    summary the run itself produced.

    One window at a time per process: a second concurrent call raises
    ``CaptureBusyError`` instead of corrupting the live session."""
    d = dirname or flags.get("LUX_PROF_DIR")
    if not d:
        raise ValueError(
            "profiling is not armed: set LUX_PROF_DIR or pass dirname")
    if not _capture_lock.acquire(blocking=False):
        raise CaptureBusyError(
            "a profile capture window is already in flight")
    try:
        sub = os.path.join(d, f"cap_{os.getpid()}_{next(_CAP_IDS)}")
        with trace(sub):
            out = run()
        if callable(iterlog_summary):
            iterlog_summary = iterlog_summary()
        rep = parse_dir(sub, op_maps=op_maps, steps=steps,
                        iterlog_summary=iterlog_summary, top_k=top_k)
        rep["capture_dir"] = sub
        _set_latest(rep)
        return out, rep
    finally:
        _capture_lock.release()


def latest():
    """The most recent ``profile.v1`` report captured in this process
    (``profile_window`` or the SIGUSR2 toggle), or None."""
    with _latest_lock:
        return _latest_report


def latest_realized():
    """``realized_hidden_frac`` of the latest captured profile, or None
    — surfaced next to the engobs budget so the two are never
    conflated."""
    rep = latest()
    if rep is None:
        return None
    return rep.get("realized_hidden_frac")


def _set_latest(rep):
    global _latest_report
    with _latest_lock:
        _latest_report = rep


def install_signal_handler(signum=None) -> bool:
    """Arm the capture toggle on ``signum`` (default SIGUSR2, next to
    the flight recorder's SIGUSR1): the first signal starts a capture
    into ``LUX_PROF_DIR``, the second stops it, parses the artifact,
    writes ``profile_v1.json`` next to it, and publishes ``latest()``.
    Returns False (no-op) off the main thread."""
    signum = signal.SIGUSR2 if signum is None else signum
    try:
        signal.signal(signum, _on_signal)
        return True
    except ValueError:
        return False


def _on_signal(signum, frame):
    # Signal context: never raise.
    try:
        _toggle_capture()
    except Exception as e:
        _LOG.warning("profile capture toggle failed: %r", e)


def _toggle_capture():
    d = flags.get("LUX_PROF_DIR")
    if not d:
        _LOG.warning("SIGUSR2 ignored: LUX_PROF_DIR is not set")
        return
    if _sig_state["dir"] is None:
        if not _capture_lock.acquire(blocking=False):
            _LOG.warning("SIGUSR2 ignored: a capture is already live")
            return
        sub = os.path.join(d, f"sig_{os.getpid()}_{next(_CAP_IDS)}")
        try:
            _sig_state["prof"] = _start(sub)
        except Exception:
            _capture_lock.release()
            raise
        _sig_state["dir"] = sub
        _LOG.info("profile capture started -> %s (SIGUSR2 again to "
                  "stop)", sub)
        return
    sub, _sig_state["dir"] = _sig_state["dir"], None
    p, _sig_state["prof"] = _sig_state["prof"], None
    try:
        _stop(p, sub)
        rep = parse_dir(sub)
        rep["capture_dir"] = sub
        out = os.path.join(sub, "profile_v1.json")
        with open(out, "w") as f:
            json.dump(rep, f, indent=1)
        _set_latest(rep)
        _LOG.info("profile capture stopped: %s (realized_hidden_frac="
                  "%s)", out, rep.get("realized_hidden_frac"))
    finally:
        _capture_lock.release()


# -- artifact discovery + loading ------------------------------------------


def find_trace_artifact(dirname: str) -> str:
    """Newest ``*.trace.json.gz`` (or a plain ``*.pt.trace.json``) under
    ``dirname``."""
    pats = ("*.trace.json.gz", "*.pt.trace.json")
    cands = sorted({p for pat in pats for p in
                    glob.glob(os.path.join(dirname, "**", pat),
                              recursive=True)})
    if not cands:
        raise ProfileParseError(
            f"no *.trace.json.gz artifact under {dirname!r} — did the "
            "capture window actually run?")
    return max(cands, key=os.path.getmtime)


def load_chrome_trace(path: str) -> dict:
    """gzip+json load of a Chrome-trace artifact. Truncated or
    corrupt data raises ``ProfileParseError`` — never a wrong report."""
    try:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, EOFError, ValueError, UnicodeDecodeError) as e:
        raise ProfileParseError(
            f"cannot read Chrome trace {path!r}: {e!r}") from e
    if isinstance(doc, list):
        doc = {"traceEvents": doc}
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        raise ProfileParseError(
            f"{path!r} is not a Chrome trace (no traceEvents list)")
    return doc


# -- interval math ---------------------------------------------------------


def merge_intervals(intervals):
    """Sorted, coalesced (start, end) list; tolerates out-of-order
    input and zero-length intervals."""
    ivs = sorted((s, e) for s, e in intervals if e > s)
    out = []
    for s, e in ivs:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def union_total(merged) -> float:
    return sum(e - s for s, e in merged)


def intersect_merged(a, b):
    """Intersection of two merged interval lists (two-pointer walk)."""
    out = []
    i = j = 0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if e > s:
            out.append((s, e))
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return out


# -- parsing ---------------------------------------------------------------


def _num(ev, key, default=None):
    v = ev.get(key, default)
    if v is None:
        return default
    try:
        return float(v)
    except (TypeError, ValueError):
        raise ProfileParseError(
            f"event {ev.get('name')!r} has non-numeric {key}={v!r}")


def parse(path: str, op_maps=None, steps=None, iterlog_summary=None,
          top_k: int = 10) -> dict:
    """Parse one Chrome-trace artifact into a ``profile.v1`` report."""
    return parse_events(load_chrome_trace(path), op_maps=op_maps,
                        steps=steps, iterlog_summary=iterlog_summary,
                        top_k=top_k)


def parse_dir(dirname: str, op_maps=None, steps=None,
              iterlog_summary=None, top_k: int = 10) -> dict:
    """``parse`` over the newest artifact under a capture directory."""
    return parse(find_trace_artifact(dirname), op_maps=op_maps,
                 steps=steps, iterlog_summary=iterlog_summary,
                 top_k=top_k)


def _phase_of(tag):
    if tag is None:
        return None
    if ".exchange" in tag:
        return "exchange"
    if ".compute" in tag:
        return "compute"
    return None


class _Ranges:
    """``lux.*`` ranges of one timeline; ``innermost(t)`` is the
    shortest range whose [start, end] covers ``t``, or None."""

    def __init__(self):
        self._items = []       # (start, end, name)
        self._starts = None

    def add(self, s, e, name):
        self._items.append((s, e, name))

    def innermost(self, t):
        if self._starts is None:
            self._items.sort()
            self._starts = [s for s, _, _ in self._items]
        best = None
        for s, e, name in self._items[:bisect.bisect_right(self._starts,
                                                           t)]:
            # Shortest wins; of equal ones, the one that starts last.
            if e >= t and (best is None or (e - s, -s) < best[0]):
                best = ((e - s, -s), name)
        return None if best is None else best[1]


def _corr(args):
    c = args.get("correlation")
    return None if c is None else int(c)


def parse_events(doc: dict, op_maps=None, steps=None,
                 iterlog_summary=None, top_k: int = 10) -> dict:
    """The ``profile.v1`` builder over an in-memory torch Chrome-trace
    doc (see the module docstring for the join). ``op_maps`` is
    ignored."""
    procs = {}
    kernels = []             # (pid, tid, ts, dur, name, correlation)
    gpu_ranges = {}          # (pid, tid) -> _Ranges
    host_ranges = {}         # (pid, tid) -> _Ranges
    launches = {}            # correlation -> (pid, tid, ts)
    host_regions = {}
    for ev in doc["traceEvents"]:
        if not isinstance(ev, dict):
            raise ProfileParseError(f"non-object trace event: {ev!r}")
        ph = ev.get("ph")
        if ph == "M":
            a = ev.get("args") or {}
            if ev.get("name") == "process_name":
                procs[ev.get("pid")] = a.get("name")
            continue
        if ph != "X":
            continue
        name = ev.get("name")
        ts = _num(ev, "ts")
        if ts is None:
            raise ProfileParseError(f"X event {name!r} has no ts")
        dur = _num(ev, "dur", 0.0) or 0.0
        cat = ev.get("cat")
        args = ev.get("args") or {}
        if not isinstance(args, dict):
            raise ProfileParseError(f"event {name!r} has non-object args")
        lux = isinstance(name, str) and bool(NAME_RE.fullmatch(name))
        if cat in DEVICE_CATS:
            kernels.append((ev.get("pid"), ev.get("tid"), ts, dur, name,
                            _corr(args)))
        elif cat == GPU_RANGE_CAT:
            if lux:
                gpu_ranges.setdefault((ev.get("pid"), ev.get("tid")),
                                      _Ranges()).add(ts, ts + dur, name)
        elif cat in RUNTIME_CATS:
            c = _corr(args)
            if c is not None:
                launches[c] = (ev.get("pid"), ev.get("tid"), ts)
        elif lux:
            rec = host_regions.setdefault(
                name, {"count": 0, "total_us": 0.0})
            rec["count"] += 1
            rec["total_us"] += dur
            if cat == HOST_RANGE_CAT:
                host_ranges.setdefault(
                    (ev.get("pid"), ev.get("tid")), _Ranges()).add(
                    ts, ts + dur, name)

    dev = {}                 # pid -> phase -> [(s, e)]
    top = {}
    for pid, tid, ts, dur, name, corr in kernels:
        tag = None
        ranges = gpu_ranges.get((pid, tid))
        if ranges is not None:
            tag = ranges.innermost(ts)
        if tag is None and corr is not None and corr in launches:
            lpid, ltid, lts = launches[corr]
            ranges = host_ranges.get((lpid, ltid))
            if ranges is not None:
                tag = ranges.innermost(lts)
        d = dev.setdefault(pid, {
            "exchange": [], "compute": [], "busy": []})
        d["busy"].append((ts, ts + dur))
        phase = _phase_of(tag)
        if phase:
            d[phase].append((ts, ts + dur))
        t = top.setdefault(name, {"op": name, "total_us": 0.0,
                                  "count": 0, "tag": tag})
        t["total_us"] += dur
        t["count"] += 1
        if t["tag"] is None:
            t["tag"] = tag

    devices = {}
    tot_ex = tot_ov = 0.0
    span_lo, span_hi = None, None
    for pid, d in dev.items():
        ex = merge_intervals(d["exchange"])
        co = merge_intervals(d["compute"])
        busy = merge_intervals(d["busy"])
        both = merge_intervals(d["exchange"] + d["compute"])
        ex_us, co_us = union_total(ex), union_total(co)
        ov_us = union_total(intersect_merged(ex, co))
        un_us = union_total(both)
        busy_us = union_total(busy)
        lo = min(s for s, _ in busy) if busy else 0.0
        hi = max(e for _, e in busy) if busy else 0.0
        span_us = hi - lo
        if busy:
            span_lo = lo if span_lo is None else min(span_lo, lo)
            span_hi = hi if span_hi is None else max(span_hi, hi)
        frac = min(max(ov_us / ex_us, 0.0), 1.0) if ex_us > 0 else None
        devices[str(pid)] = {
            "device": procs.get(pid) or f"pid:{pid}",
            "exchange_us": ex_us,
            "compute_us": co_us,
            "overlap_us": ov_us,
            "union_us": un_us,
            "busy_us": busy_us,
            "span_us": span_us,
            "idle_frac": (min(max(1.0 - busy_us / span_us, 0.0), 1.0)
                          if span_us > 0 else None),
            "realized_hidden_frac": frac,
        }
        tot_ex += ex_us
        tot_ov += ov_us

    report = {
        "schema": "profile.v1",
        "devices": devices,
        "host_regions": host_regions,
        "tags": sorted(
            {t["tag"] for t in top.values() if t["tag"]}
            | set(host_regions)),
        "top_ops": sorted(top.values(), key=lambda t: -t["total_us"])
        [:max(int(top_k), 0)],
        "realized_hidden_frac": (
            min(max(tot_ov / tot_ex, 0.0), 1.0) if tot_ex > 0 else None),
    }
    span_s = ((span_hi - span_lo) / 1e6
              if span_lo is not None and span_hi > span_lo else None)
    steps_block = {"device_span_s": span_s}
    if steps is not None:
        steps_block["captured"] = int(steps)
        if span_s:
            steps_block["steps_per_s"] = int(steps) / span_s
    if iterlog_summary:
        n = iterlog_summary.get("num_iters") or 0
        ex_s = iterlog_summary.get("execute_s") or 0.0
        steps_block["iterlog"] = {
            "num_iters": n, "execute_s": ex_s,
            "steps_per_s": (n / ex_s) if ex_s > 0 else None,
        }
    report["steps"] = steps_block
    return validate(report)


def validate(report: dict) -> dict:
    """Check a ``profile.v1`` report's schema and interval invariants;
    raises ``ProfileParseError`` on any violation, returns the report
    unchanged otherwise."""
    if not isinstance(report, dict) or report.get("schema") != "profile.v1":
        raise ProfileParseError(
            f"not a profile.v1 report: schema={report.get('schema')!r}"
            if isinstance(report, dict) else
            f"not a profile.v1 report: {type(report).__name__}")
    devices = report.get("devices")
    if not isinstance(devices, dict):
        raise ProfileParseError("profile.v1 report has no devices map")
    for pid, d in devices.items():
        ex, co = d.get("exchange_us"), d.get("compute_us")
        ov, un = d.get("overlap_us"), d.get("union_us")
        for key, v in (("exchange_us", ex), ("compute_us", co),
                       ("overlap_us", ov), ("union_us", un)):
            if not isinstance(v, (int, float)) or v < 0:
                raise ProfileParseError(
                    f"device {pid}: bad {key}={v!r}")
        if un + _EPS_US < max(ex, co):
            raise ProfileParseError(
                f"device {pid}: union {un} < max phase {max(ex, co)}")
        if un > ex + co + _EPS_US:
            raise ProfileParseError(
                f"device {pid}: union {un} > exchange+compute {ex + co}")
        if ov > min(ex, co) + _EPS_US:
            raise ProfileParseError(
                f"device {pid}: overlap {ov} > min phase {min(ex, co)}")
        for key in ("realized_hidden_frac", "idle_frac"):
            v = d.get(key)
            if v is not None and not 0.0 <= v <= 1.0:
                raise ProfileParseError(
                    f"device {pid}: {key}={v!r} outside [0, 1]")
    frac = report.get("realized_hidden_frac")
    if frac is not None and not 0.0 <= frac <= 1.0:
        raise ProfileParseError(
            f"realized_hidden_frac={frac!r} outside [0, 1]")
    return report


# -- rendering -------------------------------------------------------------


def format_report(report: dict) -> str:
    """Compact human rendering of a ``profile.v1`` report (the
    ``lux_tpu_torch.tools.prof_summary`` table)."""
    lines = ["profile.v1 device timeline:"]
    frac = report.get("realized_hidden_frac")
    lines.append(
        "  realized_hidden_frac={} (device-measured; compare to the "
        "engobs budget, an upper bound)".format(
            "n/a" if frac is None else f"{frac:.3f}"))
    lines.append("  {:<26} {:>12} {:>12} {:>11} {:>10} {:>9}".format(
        "device", "exchange_us", "compute_us", "overlap_us",
        "realized", "idle"))
    for pid in sorted(report.get("devices") or {}):
        d = report["devices"][pid]
        lines.append(
            "  {:<26} {:>12.0f} {:>12.0f} {:>11.0f} {:>10} {:>9}".format(
                str(d.get("device"))[:26], d["exchange_us"],
                d["compute_us"], d["overlap_us"],
                "-" if d.get("realized_hidden_frac") is None
                else f"{d['realized_hidden_frac']:.3f}",
                "-" if d.get("idle_frac") is None
                else f"{d['idle_frac']:.3f}"))
    if report.get("host_regions"):
        lines.append("  host regions:")
        for name in sorted(report["host_regions"]):
            rec = report["host_regions"][name]
            lines.append(
                f"    {name:<32} x{rec['count']:<5} "
                f"{rec['total_us']:.0f} us")
    if report.get("top_ops"):
        lines.append("  top ops:")
        for t in report["top_ops"]:
            lines.append(
                "    {:<38} {:>10.0f} us x{:<5} {}".format(
                    str(t["op"])[:38], t["total_us"], t["count"],
                    t.get("tag") or "-"))
    st = report.get("steps") or {}
    if st.get("captured") is not None:
        rate = st.get("steps_per_s")
        lines.append(
            "  steps: {} captured over {} of device span ({})".format(
                st["captured"],
                "n/a" if st.get("device_span_s") is None
                else f"{st['device_span_s']:.4f}s",
                "n/a" if rate is None else f"{rate:.1f} steps/s"))
        il = st.get("iterlog")
        if il:
            lines.append(
                "  iterlog cross-check: {num_iters} iters / "
                "{execute_s:.4f}s execute ({rate})".format(
                    rate=("n/a" if il.get("steps_per_s") is None
                          else f"{il['steps_per_s']:.1f} steps/s"),
                    **{k: il[k] for k in ("num_iters", "execute_s")}))
    return "\n".join(lines)
