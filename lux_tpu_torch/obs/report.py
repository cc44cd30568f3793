"""End-of-run reporting: the ``perf`` log table + ``LUX_METRICS`` dump;
the counterpart of ``lux_tpu/obs/report.py``.

``finalize(summary)`` is called by ``IterationRecorder.finish()`` with
the ``lux.run_telemetry.v1`` summary dict. It renders a compact table to
the ``lux_tpu_torch.perf`` logger, feeds the run ledger, and, when
``LUX_METRICS=<path>`` is set, appends one JSON line (the summary plus a
metrics-registry snapshot) to that path. JSON-lines append means
repeated runs in one process coexist; readers take the last line for
the headline run.
"""

from __future__ import annotations

import json

from lux_tpu_torch.obs import ledger, metrics
from lux_tpu_torch.utils import flags
from lux_tpu_torch.utils.logging import get_logger

# Cap the per-iteration rows logged to the perf logger; the JSON dump
# always carries every record.
_LOG_ROWS_HEAD = 24
_LOG_ROWS_TAIL = 8

# Roofline peak-rate registry, keyed on ``torch.cuda.get_device_name()``:
# (hbm_peak_gbps, ici_peak_gbps). The H100 SXM's row is its published
# 3.35 TB/s, the rate PERF.md's kernel bounds use; its capacity is read
# from the card (``torch.cuda.get_device_properties``), not tabled. No
# row has an interconnect peak: the parts of a LocalMesh share one card,
# so nothing crosses an interconnect; over a DistMesh of cards
# ``LUX_ICI_PEAK_GBPS`` prices it. A CPU has neither, so its row prices
# nothing, and an unknown kind reports None plus a one-time warning
# instead of pricing against the wrong device.
_DEVICE_PROFILES = {
    "NVIDIA H100 80GB HBM3": (3350.0, None),
    "cpu": (None, None),
}

_kind_cache = []
_capacity_cache = {}
_warned_kinds = set()


def _device_kind() -> str:
    """The live card's ``torch.cuda.get_device_name()``, cached; 'cpu'
    without a card."""
    if not _kind_cache:
        import torch

        _kind_cache.append(torch.cuda.get_device_name()
                           if torch.cuda.is_available() else "cpu")
    return _kind_cache[0]


def _card_capacity(kind: str):
    """Total memory of the live card when ``kind`` names it, else None
    (cached per kind: every finished run reads it)."""
    if kind not in _capacity_cache:
        import torch

        cap = None
        if (kind != "cpu" and torch.cuda.is_available()
                and torch.cuda.get_device_name() == kind):
            cap = int(torch.cuda.get_device_properties(
                torch.cuda.current_device()).total_memory)
        _capacity_cache[kind] = cap
    return _capacity_cache[kind]


def device_profile(kind: str = None) -> dict:
    """The roofline peak-rate row for ``kind`` (default: the live card's
    name, or 'cpu'): ``{device_kind, hbm_peak_gbps, ici_peak_gbps,
    hbm_capacity_bytes, known}``. ``LUX_HBM_PEAK_GBPS`` /
    ``LUX_ICI_PEAK_GBPS`` override either rate and
    ``LUX_HBM_CAPACITY_BYTES`` the capacity. An unknown kind without
    overrides yields None peaks — roofline fractions then stay None
    rather than pricing against the wrong device — and warns once per
    kind."""
    if kind is None:
        kind = _device_kind()
    row = _DEVICE_PROFILES.get(kind)
    hbm, ici = row if row else (None, None)
    cap = _card_capacity(kind)
    hbm_env = flags.get("LUX_HBM_PEAK_GBPS")
    ici_env = flags.get("LUX_ICI_PEAK_GBPS")
    cap_env = flags.get("LUX_HBM_CAPACITY_BYTES")
    if hbm_env:
        hbm = float(hbm_env)
    if ici_env:
        ici = float(ici_env)
    if cap_env:
        cap = int(cap_env)
    if row is None and not (hbm_env or ici_env) \
            and kind not in _warned_kinds:
        _warned_kinds.add(kind)
        get_logger("perf").warning(
            "no device profile for device_kind=%r: roofline fractions "
            "will be None (set LUX_HBM_PEAK_GBPS/LUX_ICI_PEAK_GBPS to "
            "price this device)", kind)
    return {"device_kind": kind, "hbm_peak_gbps": hbm,
            "ici_peak_gbps": ici, "hbm_capacity_bytes": cap,
            "known": row is not None}


def roofline(summary: dict) -> dict:
    """Achieved-vs-peak HBM and ICI fractions for one run summary.

    HBM: the engine's first-order bytes-per-iteration model
    (``hbm_bytes_per_iter``, from engobs.hbm_bytes_per_iter) over execute
    time. Interconnect: exchange bytes over exchange time —
    phase-measured exchange seconds when the run was phase-fenced
    (LUX_ENGOBS), else total execute time (a lower bound on the
    fraction) — divided across the mesh's parts. Without an
    interconnect peak (parts on one card) ``ici_frac`` stays None and
    ``ici_note`` says "one card".
    """
    out = {}
    prof_row = device_profile()
    out["device_kind"] = prof_row["device_kind"]
    if prof_row["hbm_capacity_bytes"]:
        out["hbm_capacity_bytes"] = prof_row["hbm_capacity_bytes"]
    iters = summary.get("num_iters") or 0
    exec_s = summary.get("execute_s") or 0.0
    hbm = summary.get("hbm_bytes_per_iter")
    if hbm and iters and exec_s > 0:
        gbps = hbm * iters / exec_s / 1e9
        out["hbm_gbps"] = gbps
        peak = prof_row["hbm_peak_gbps"]
        out["hbm_frac"] = gbps / peak if peak else None
    exch = summary.get("exchange_bytes_per_iter")
    if exch and iters:
        phases = summary.get("phases") or {}
        exch_s = phases.get("exchange_s") or exec_s
        parts = summary.get("parts") or 1
        if exch_s > 0:
            gbps = exch * iters / exch_s / 1e9 / max(parts, 1)
            out["ici_gbps_per_chip"] = gbps
            peak = prof_row["ici_peak_gbps"]
            out["ici_frac"] = gbps / peak if peak else None
            if not peak:
                out["ici_note"] = "one card"
            out["ici_measured"] = bool(phases)
    return out


def _format_table(summary: dict) -> str:
    lines = [
        "run report: engine={engine} program={program} nv={nv} ne={ne}".format(
            **summary),
        "  iters={num_iters} compile={compile_s:.4f}s "
        "execute={execute_s:.4f}s gteps={gteps:.4f}".format(**summary),
    ]
    if summary.get("exchange_bytes_per_iter"):
        line = ("  exchange: {exchange_bytes_per_iter} B/iter, "
                "{exchange_bytes_total} B total".format(**summary))
        if summary.get("useful_bytes_per_iter") is not None:
            line += " (useful {useful_bytes_per_iter} B/iter, " \
                "ratio {useful_ratio:.3f})".format(**summary)
        lines.append(line)
    if summary.get("phases"):
        lines.append(
            "  phases: exchange={exchange_s:.4f}s compute={compute_s:.4f}s "
            "exchange_frac={exchange_frac:.3f}".format(**summary["phases"]))
    roof = summary.get("roofline")
    if roof:
        bits = []
        if "hbm_gbps" in roof:
            frac = roof.get("hbm_frac")
            bits.append("HBM {:.1f} GB/s ({} of peak)".format(
                roof["hbm_gbps"],
                "n/a" if frac is None else f"{frac:.3f}"))
        if "ici_gbps_per_chip" in roof:
            frac = roof.get("ici_frac")
            bits.append("ICI {:.1f} GB/s/chip ({}{})".format(
                roof["ici_gbps_per_chip"],
                roof.get("ici_note", "n/a") if frac is None
                else f"{frac:.3f} of peak",
                "" if roof.get("ici_measured") else ", bound"))
        if bits:
            lines.append("  roofline: " + "; ".join(bits))
    rows = summary.get("iterations") or []
    if rows:
        lines.append(
            "  {:>6} {:>12} {:>12} {:>10} {:>9}".format(
                "iter", "t_iter_s", "t_cum_s", "frontier", "gteps"))
        shown = rows
        elided = 0
        if len(rows) > _LOG_ROWS_HEAD + _LOG_ROWS_TAIL:
            shown = rows[:_LOG_ROWS_HEAD]
            elided = len(rows) - _LOG_ROWS_HEAD - _LOG_ROWS_TAIL
        for r in shown:
            lines.append(_format_row(r))
        if elided:
            lines.append(f"  ... {elided} rows elided ...")
            for r in rows[-_LOG_ROWS_TAIL:]:
                lines.append(_format_row(r))
    return "\n".join(lines)


def _format_row(r: dict) -> str:
    frontier = r.get("frontier")
    return "  {:>6} {:>12.6f} {:>12.6f} {:>10} {:>9.4f}".format(
        r["iter"], r["t_iter_s"], r["t_cum_s"],
        "-" if frontier is None else frontier, r["gteps"])


def finalize(summary: dict):
    roof = roofline(summary)
    if roof:
        summary["roofline"] = roof
    log = get_logger("perf")
    log.info("%s", _format_table(summary))
    # Every finished run becomes one durable runrec.v1 observation when
    # the ledger is armed — this is THE engine-run feed-in point: every
    # executor that runs through IterationRecorder.finish() lands here.
    # Per-iteration rows stay in the LUX_METRICS dump; the ledger keeps
    # the (config -> aggregate metrics) observation compact.
    obs = {k: v for k, v in summary.items() if k != "iterations"}
    ledger.record_run(
        "engine_run", obs,
        program=str(summary.get("program", "?")),
        engine_kind=str(summary.get("engine", "?")),
        mesh_shape=str(summary.get("parts", 1)),
    )
    path = flags.get("LUX_METRICS")
    if not path:
        return
    record = dict(summary)
    record["metrics"] = metrics.snapshot()
    with open(path, "a") as f:
        f.write(json.dumps(record, separators=(",", ":")) + "\n")


def read_last(path: str) -> dict:
    """Read the most recent run record from a ``LUX_METRICS`` dump."""
    last = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                last = line
    if last is None:
        raise ValueError(f"no run records in {path}")
    return json.loads(last)
