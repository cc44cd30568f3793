"""The ``LUX_*`` environment flags this package reads.

The counterpart of ``lux_tpu/utils/flags.py``: the same names, defaults
and accessor semantics (:func:`get`, :func:`get_int`, :func:`get_float`,
:func:`get_bool`, :func:`tristate`) for the flags the port reads, and the
same table functions (:func:`declared`, :func:`names`, :func:`default`,
:func:`overrides`, :func:`snapshot`, :func:`config_hash`, :func:`table`).
Accessors re-read ``os.environ`` on every call, so flags stay runtime
knobs (CLI flags set env vars after first import).

:func:`overrides` layers a scoped, context-local overlay on top of the
environment: inside the ``with`` block every accessor (and therefore
:func:`snapshot` and :func:`config_hash`) sees the overlaid values
without touching ``os.environ``; a run-ledger record written under an
overlay carries it.

``python -m lux_tpu_torch.utils.flags`` prints the flag table.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import hashlib
import os
from typing import Dict, Mapping, Optional

__all__ = [
    "Flag", "define", "declared", "names", "default", "get", "get_int",
    "get_float", "get_bool", "tristate", "table", "snapshot",
    "config_hash", "overrides",
]


@dataclasses.dataclass(frozen=True)
class Flag:
    name: str          # LUX_* env var name
    default: object    # value returned when the env var is unset
    doc: str           # one line: what the flag does / legal values
    kind: str = "str"  # str | path | int | float | bool | tristate


_REGISTRY: Dict[str, Flag] = {}


def define(name: str, default, doc: str, kind: str = "str") -> Flag:
    """Declare a flag. Redefining with a different spec raises."""
    if not name.startswith("LUX_"):
        raise ValueError(f"flag name must start with LUX_: {name!r}")
    f = Flag(name, default, doc, kind)
    old = _REGISTRY.get(name)
    if old is not None and old != f:
        raise ValueError(f"flag {name} already defined as {old}")
    _REGISTRY[name] = f
    return f


def declared(name: str) -> bool:
    return name in _REGISTRY


def names() -> tuple:
    return tuple(sorted(_REGISTRY))


def _flag(name: str) -> Flag:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"undeclared flag {name!r}: declare it in "
            "lux_tpu_torch/utils/flags.py"
        ) from None


def default(name: str):
    """The declared default."""
    return _flag(name).default


# Context-local overlay stack. Each layer maps flag name -> str value
# (or None, which masks any env var and forces the declared default).
_OVERRIDES: contextvars.ContextVar = contextvars.ContextVar(
    "lux_torch_flag_overrides", default=())


def _overlaid(name: str):
    """(hit, value) against the innermost overlay layer naming ``name``."""
    for layer in reversed(_OVERRIDES.get()):
        if name in layer:
            return True, layer[name]
    return False, None


@contextlib.contextmanager
def overrides(mapping: Mapping[str, object]):
    """Scoped flag overlay: inside the block every accessor resolves the
    given flags to the mapped values (stringified; ``None`` masks the env
    var, restoring the declared default). Layers nest, inner wins.
    Undeclared names raise up front."""
    frozen = {}
    for name, value in mapping.items():
        _flag(name)
        frozen[name] = None if value is None else str(value)
    token = _OVERRIDES.set(_OVERRIDES.get() + (frozen,))
    try:
        yield
    finally:
        _OVERRIDES.reset(token)


def _raw(name: str) -> Optional[str]:
    """The overlay's value if a layer names ``name``, else the env var."""
    hit, ov = _overlaid(name)
    return ov if hit else os.environ.get(name)


def get(name: str) -> Optional[str]:
    """Raw string value: the innermost :func:`overrides` layer if one
    names this flag, else the env var if set, else the declared default
    (coerced to str unless None)."""
    f = _flag(name)
    v = _raw(name)
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
    v = _raw(name)
    if v is None:
        return bool(f.default)
    return v.strip().lower() not in ("", "0", "false", "no", "off")


def tristate(name: str, strict: bool = True) -> Optional[bool]:
    """Three-way override knob: unset/'' → None (auto), '0' → False
    (force off), '1' → True (force on). Other values raise when
    ``strict``, else behave as unset."""
    _flag(name)
    v = _raw(name) or ""
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


def snapshot() -> Dict[str, Optional[str]]:
    """Effective value of every declared flag, in sorted-name order: the
    config side of a run-ledger record (obs/ledger.py). Only declared
    ``LUX_*`` flags are captured, never the whole environment."""
    return {name: get(name) for name in names()}


def config_hash() -> str:
    """Stable 12-hex digest of the behavioural flag config. Path-kind
    flags are left out: they name sinks (metrics files, the ledger dir
    itself) that differ per run without changing behaviour."""
    items = [
        (name, get(name))
        for name in names()
        if _REGISTRY[name].kind != "path"
    ]
    blob = "\x00".join(f"{k}={'' if v is None else v}" for k, v in items)
    return hashlib.sha1(blob.encode("utf-8")).hexdigest()[:12]


def table() -> str:
    """Human-readable flag table (name, kind, default, doc)."""
    rows = [("flag", "kind", "default", "doc")]
    for name in names():
        f = _REGISTRY[name]
        rows.append((f.name, f.kind, repr(f.default), f.doc))
    w0 = max(len(r[0]) for r in rows)
    w1 = max(len(r[1]) for r in rows)
    w2 = max(len(r[2]) for r in rows)
    return "\n".join(
        f"{r[0]:<{w0}}  {r[1]:<{w1}}  {r[2]:<{w2}}  {r[3]}" for r in rows
    )


# -- the flags -------------------------------------------------------------
# Observability (obs/, utils/logging.py)
define("LUX_LOG", "INFO",
       "log level for the lux_tpu_torch.* logger categories "
       "(DEBUG..CRITICAL)")
define("LUX_METRICS", None,
       "append one JSON run-report line (summary + metrics snapshot) per "
       "run to this path", kind="path")
define("LUX_TRACE", None,
       "stream Chrome trace_event JSON-lines to this path", kind="path")
define("LUX_SPANS", True,
       "request-scoped serve spans (obs/spans.py): trace-id propagation, "
       "per-phase histograms, async Chrome events (0 disables)",
       kind="bool")
define("LUX_FLIGHT_DIR", None,
       "arm the flight recorder (obs/flight.py): postmortem flight.v1 "
       "JSON dumps land in this directory", kind="path")
define("LUX_FLIGHT_CAPACITY", 256,
       "flight-recorder ring size: last N completed traces and last N "
       "engine iteration records kept for postmortems", kind="int")
define("LUX_STATUSZ_WINDOWS", "60,300",
       "rolling SLO window lengths in seconds, comma-separated "
       "(obs/slo.py)")
define("LUX_ENGOBS", False,
       "engine performance observatory (obs/engobs.py): run sharded "
       "executors through phase-fenced steps splitting exchange vs "
       "compute time per iteration; off keeps the plain loop of steps",
       kind="bool")
define("LUX_PROF_DIR", None,
       "arm the device-timeline profiler (obs/prof.py): capture windows "
       "(profile_window, SIGUSR2 toggle) write torch.profiler Chrome "
       "traces + profile.v1 reports under this directory", kind="path")
define("LUX_LEDGER_DIR", None,
       "arm the run ledger (obs/ledger.py): every engine run appends one "
       "crc-framed runrec.v1 JSON line under this directory", kind="path")
define("LUX_LEDGER_ROTATE_BYTES", 8 << 20,
       "run-ledger segment rotation threshold in bytes: a segment at or "
       "past this size is sealed and a new runrec-NNNNNN.jsonl opens",
       kind="int")
define("LUX_HBM_PEAK_GBPS", None,
       "override the roofline HBM peak (GB/s) of the device-profile "
       "registry (obs/report.py)")
define("LUX_ICI_PEAK_GBPS", None,
       "price the roofline per-device interconnect peak (GB/s); no row "
       "has one, since the parts of a LocalMesh share one card")
define("LUX_HBM_CAPACITY_BYTES", None,
       "override the device memory capacity in bytes (the card's row "
       "reads torch.cuda.get_device_properties)", kind="int")

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

# Static analysis: the grouped-tail plan tier (analysis/planck.py).
define("LUX_PLANCK_INFLATION", 8.0,
       "luxlint --plans LUX205: max per-level grouped-tail stream "
       "inflation (rows per level / ceil(reals/128)) a saved plan may "
       "carry", kind="float")

# The trace tiers (analysis/ir.py over analysis/trace.py).
define("LUX_IR_BLOWUP", 16.0,
       "luxlint-IR LUX103: flag any traced intermediate larger than this "
       "multiple of the step's total input bytes", kind="float")

# The serve pool's build-time audits and admission (serve/pool.py). Of
# lux_tpu's analysis tiers the IR audit (LUX104: the engine's trace_step
# declaration, and where it donates one unrecorded step; the doc keeps
# lux_tpu's wording), gasck and exchck run; memck is not ported (ROADMAP
# A16), and while its flag asks for it the pool's stats() and /statusz
# say so.
define("LUX_IR_POOL_AUDIT", True,
       "run the LUX104 donation audit on every engine the serve pool "
       "builds (one abstract lowering per build; 0 disables)", kind="bool")
define("LUX_EXCH_POOL_AUDIT", True,
       "run the LUX401-403 exchange-plan audit on every plan-carrying "
       "engine the serve pool builds (pure numpy over the live "
       "ExchangePlan tables; 0 disables)", kind="bool")
define("LUX_GASCAP_DIR", None,
       "directory holding the gascap.v1 program-capability artifact "
       "(analysis/gasck.py) the registry/serving layers consult; unset = "
       "the committed lux_tpu_torch/analysis/gascap.json", kind="path")
define("LUX_GAS_POOL_AUDIT", True,
       "run the LUX601/602/605 program-algebra audit on every "
       "GAS-program-carrying engine the serve pool builds (cached "
       "per program class; 0 disables)", kind="bool")
define("LUX_GASCK_SEED", 7,
       "luxlint --programs: RNG seed for the probe graphs and the "
       "LUX602 associativity/commutativity probe triples", kind="int")
define("LUX_GASCK_TRIPLES", 64,
       "luxlint --programs: number of seeded probe triples per program "
       "for the LUX602 combiner-algebra proof", kind="int")
define("LUX_GASCK_NV", 24,
       "luxlint --programs: vertex count of the seeded probe graphs the "
       "LUX603 push/pull duality traces run on", kind="int")
define("LUX_MEM_POOL_ADMIT", True,
       "gate new serve-pool engine builds on the memcap.v1 predicted "
       "footprint fitting the HBM budget (0 = admit freely; admission "
       "is also skipped when no budget can be derived)", kind="bool")
define("LUX_RESULT_CACHE_BYTES", 64 << 20,
       "serve ResultCache byte budget: LRU entries evict once their "
       "summed value nbytes exceed this (the entry-count capacity still "
       "bounds the dict)", kind="int")

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

# Dynamic graphs (graph/snapshot.py, engine/incremental.py,
# serve/session.py)
define("LUX_DELTA_COMPACT_RATIO", 0.05,
       "background-compact a snapshot's delta once pending edits exceed "
       "this fraction of the base edge count", kind="float")
define("LUX_SNAPSHOT_WARM_TIMEOUT", 120.0,
       "seconds to wait for the next snapshot's engines to warm before "
       "aborting the hot-swap (the old version keeps serving)",
       kind="float")
define("LUX_INCREMENTAL", True,
       "warm-start components/cached-SSSP fixpoints from the previous "
       "snapshot's values during a hot-swap instead of recomputing on "
       "demand (0 = evict only)", kind="bool")

# Robustness: fault injection (utils/faults.py), edit WAL (graph/wal.py),
# graceful degradation (serve/session.py, serve/breaker.py)
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
define("LUX_EDIT_QUEUE_MAX", 8,
       "Session.enqueue_edits auto-flushes the WAL-backed edit queue "
       "into one hot-swap once this many batches are pending (ROADMAP "
       "item 3: swaps amortize over many small edits)", kind="int")
define("LUX_RETRY_MAX", 2,
       "max engine re-executions after a transient (non-ServeError) "
       "failure per batch, clamped by the request deadline (0 = fail "
       "fast)", kind="int")
define("LUX_RETRY_BACKOFF_MS", 25.0,
       "initial retry backoff in ms, doubling per attempt", kind="float")
define("LUX_BREAKER_THRESHOLD", 5,
       "consecutive engine failures on one (app, fingerprint) before the "
       "circuit breaker opens and sheds that program with 503 + "
       "Retry-After", kind="int")
define("LUX_BREAKER_COOLDOWN_MS", 2000.0,
       "ms an open breaker waits before going half-open and probing the "
       "rebuilt engine in the background", kind="float")

# Multi-part serving (serve/mesh.py, serve/session.py)
define("LUX_SERVE_MESH", 1,
       "serving mesh spec: a part count ('4') or a PxQ shape ('2x2', "
       "folded onto the 1-D parts axis); 1 = single-part serving. The "
       "parts are those of a LocalMesh on the one device", kind="str")
define("LUX_SHARD_PLAN_CACHE", 8,
       "max (fingerprint, parts) partition plans the serving shard-plan "
       "cache keeps; hot-swaps evict the outgoing fingerprint's plans "
       "regardless", kind="int")

# Profile-guided auto-tuner (lux_tpu_torch/tune/)
define("LUX_TUNE_DIR", None,
       "arm the auto-tuner cache (lux_tpu_torch/tune/): tuneconf.v1 "
       "artifacts are persisted under this directory and serving warmup "
       "consults them; unset = tuner disarmed, every lookup is a counted "
       "fallback to defaults", kind="path")
define("LUX_TUNE_PROBE_ITERS", 6,
       "fixed iteration count of a rung-0 tuner probe; later "
       "successive-halving rungs double it", kind="int")
define("LUX_TUNE_RUNGS", 2,
       "successive-halving rung count for the tuner search (1 = a single "
       "flat sweep, no halving)", kind="int")
define("LUX_TUNE_ETA", 2,
       "successive-halving keep fraction: the top ceil(n/eta) candidates "
       "by score survive each rung", kind="int")
define("LUX_TUNE_SEED", 0,
       "seed for the tuner's candidate subsample + deterministic "
       "tie-breaks (same seed + graph -> identical winner and score "
       "table)", kind="int")
define("LUX_TUNE_MAX_CANDIDATES", 16,
       "cap on rung-0 candidates; larger declared knob spaces are "
       "seeded-subsampled down to this before probing", kind="int")
define("LUX_TUNE_MAX_AGE_S", 604800.0,
       "luxlint --tune staleness bound: a tuneconf.v1 artifact older "
       "than this many seconds is flagged LUX504 (0 disables the bound)",
       kind="float")
define("LUX_TUNE_PENALTY", 0.05,
       "tuner score penalty weight per direction switch / exchange "
       "downgrade, as a fraction of phase time per event per iteration "
       "(instability is a cost even when the phase medians look good)",
       kind="float")
define("LUX_TUNE_CACHE", 8,
       "max tuneconf.v1 entries the in-memory TuneCache keeps "
       "(LRU; hot-swaps evict the outgoing fingerprint's entries "
       "regardless, like LUX_SHARD_PLAN_CACHE)", kind="int")

# Native host library (native/build.py)
define("LUX_NATIVE_CACHE", None,
       "native-library build directory (default build/lux_tpu_torch/ at "
       "the root of the checkout)", kind="path")

if __name__ == "__main__":
    print(table())
