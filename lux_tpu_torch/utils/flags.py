"""The ``LUX_*`` environment flags this package reads.

A minimal copy of ``lux_tpu/utils/flags.py``: the same names, defaults
and accessor semantics (:func:`get`, :func:`get_int`, :func:`get_float`,
:func:`get_bool`, :func:`tristate`) for the flags the port's executors read. Accessors
re-read ``os.environ`` on every call, so flags stay runtime knobs.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class Flag:
    name: str          # LUX_* env var name
    default: object    # value returned when the env var is unset
    doc: str           # one line: what the flag does / legal values
    kind: str = "str"  # str | int | float | bool | tristate


_REGISTRY: Dict[str, Flag] = {}


def define(name: str, default, doc: str, kind: str = "str") -> Flag:
    if not name.startswith("LUX_"):
        raise ValueError(f"flag name must start with LUX_: {name!r}")
    f = Flag(name, default, doc, kind)
    old = _REGISTRY.get(name)
    if old is not None and old != f:
        raise ValueError(f"flag {name} already defined as {old}")
    _REGISTRY[name] = f
    return f


def _flag(name: str) -> Flag:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"undeclared flag {name!r}: declare it in "
            "lux_tpu_torch/utils/flags.py"
        ) from None


def get(name: str) -> Optional[str]:
    """Raw string value: the env var if set, else the declared default
    (coerced to str unless None)."""
    f = _flag(name)
    v = os.environ.get(name)
    if v is not None:
        return v
    return f.default if f.default is None else str(f.default)


def get_int(name: str) -> int:
    return int(get(name))


def get_float(name: str) -> float:
    return float(get(name))


def get_bool(name: str) -> bool:
    """Unset → declared default; '' / '0' / 'false' / 'no' / 'off'
    (case-insensitive) → False; anything else → True."""
    f = _flag(name)
    v = os.environ.get(name)
    if v is None:
        return bool(f.default)
    return v.strip().lower() not in ("", "0", "false", "no", "off")


def tristate(name: str, strict: bool = True) -> Optional[bool]:
    """Three-way override knob: unset/'' → None (auto), '0' → False
    (force off), '1' → True (force on). Other values raise when
    ``strict``, else behave as unset."""
    _flag(name)
    v = os.environ.get(name, "")
    if v == "":
        return None
    if v == "0":
        return False
    if v == "1":
        return True
    if strict:
        raise ValueError(
            f"{name}={v!r}: use '1' (force on), '0' (force off), or unset "
            "(auto)"
        )
    return None


# Observability (obs/trace.py, obs/spans.py)
define("LUX_TRACE", None,
       "stream Chrome trace_event JSON-lines to this path", kind="path")
define("LUX_SPANS", True,
       "request-scoped serve spans (obs/spans.py): trace-id propagation, "
       "per-phase histograms, async Chrome events (0 disables)",
       kind="bool")

# Backend (utils/platform.py)
define("LUX_PLATFORM", None,
       "the device the CLIs run on: 'cpu' runs the kernels' plain PyTorch "
       "versions on the CPU; unset (or 'cuda') runs on the card and fails "
       "without one")

define("LUX_PLAN_BANDED", None,
       "tiled planner level-0 banded passes: 1 force, 0 direct, unset "
       "auto by edge count", kind="tristate")
define("LUX_PACK_STRIPS", False,
       "opt-in nibble packing of even-r strip levels (needs plan count "
       "cap <= 15)", kind="bool")
define("LUX_GROUPED_TAIL", False,
       "opt-in grouped (merge-network) tail phase in the tiled executors",
       kind="bool")
define("LUX_EDGE_CHUNK_BYTES", 2 << 30,
       "flat-contribution byte threshold above which the pull engine "
       "runs edge-chunked", kind="int")

# GAS adaptive executor (engine/gas.py)
define("LUX_GAS", "adaptive",
       "GAS executor direction policy: 'adaptive' picks push vs pull per "
       "iteration from frontier density; 'pull'/'push' pin one direction "
       "(results are bitwise-identical across all three)")
define("LUX_GAS_DENSITY_HI", 0.0625,
       "adaptive GAS hysteresis: frontier density at or above this forces "
       "the pull (dense) direction (the reference's nv/16 crossover, "
       "sssp_gpu.cu:414)", kind="float")
define("LUX_GAS_DENSITY_LO", 0.005,
       "adaptive GAS hysteresis: frontier density at or below this forces "
       "the push (sparse-queue) direction; between the two thresholds the "
       "previous direction sticks", kind="float")

# Sharded-engine exchange path (parallel/shard.py, engine/pull_sharded.py)
define("LUX_EXCHANGE", "full",
       "sharded-executor value exchange: 'full' all-gathers whole shard "
       "tables every iteration; 'compact' sends only the rows some "
       "receiving part actually reads (fixed-capacity all_to_all of "
       "packed rows + receiver scatter, bitwise-equal results, "
       "local-first overlap); 'frontier' (sharded GAS) sends only the "
       "compact rows whose source vertex is active this iteration, "
       "packed to a static frontier capacity, self-downgrading to the "
       "static compact send on dense iterations — frontier-less "
       "executors run 'compact'. Captured at executor build; P=1 and "
       "unprofitable plans fall back to full")
define("LUX_EXCHANGE_FRONTIER_FRAC", 0.25,
       "frontier-exchange row budget as a fraction of the static "
       "compact capacity (ExchangePlan.frontier_capacity): smaller = "
       "bigger byte win on sparse iterations but earlier self-downgrade "
       "to the static compact send", kind="float")

# Concurrency discipline (utils/locks.py)
define("LUX_LOCKWATCH", False,
       "wrap every utils/locks.make_lock in the LockWatch sentinel: "
       "per-thread acquisition stacks, online lock-order inversion "
       "detection, lux_lock_{wait,hold}_seconds histograms (set before "
       "import; locks are wrapped at construction)", kind="bool")
define("LUX_LOCK_HOLD_WARN_MS", 250.0,
       "LockWatch: warn + count lux_lock_hold_warnings_total when a "
       "watched lock is held longer than this many ms (0 disables)",
       kind="float")

# Dynamic graphs (graph/snapshot.py, engine/incremental.py)
define("LUX_DELTA_COMPACT_RATIO", 0.05,
       "background-compact a snapshot's delta once pending edits exceed "
       "this fraction of the base edge count", kind="float")

# Robustness: fault injection (utils/faults.py), edit WAL (graph/wal.py)
define("LUX_FAULTS", None,
       "fault-injection spec `point:kind:prob[:arg]`, comma-separated "
       "(kinds: raise|delay_ms|corrupt|crash; see utils/faults.py); "
       "unset/empty = disarmed, the points cost one bool check")
define("LUX_FAULTS_SEED", 0,
       "seed for the per-rule fault-injection RNGs (utils/faults.py)",
       kind="int")
define("LUX_WAL_DIR", None,
       "directory for the edit write-ahead log; when set, a SnapshotStore "
       "made without a wal_dir CRC-frames + fsyncs every edit batch to "
       "<dir>/lux.wal before any version is minted, and "
       "SnapshotStore.recover without a wal_dir replays it (unset = no "
       "durability, the pre-WAL behavior)", kind="path")
