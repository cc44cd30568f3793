"""Rolling SLO windows: p50/p95/p99 per app over the last 1/5 minutes;
the counterpart of ``lux_tpu/obs/slo.py``.

The registry histogram (``lux_serve_request_seconds``) is cumulative
since process start — useless for "is the server slow *right now*".
``SloWindows`` keeps the raw (timestamp, latency) observations of the
last ``max(windows)`` seconds per app (bounded deque) and computes exact
quantiles per window on demand, which is what ``/statusz`` serves.

Window lengths come from ``LUX_STATUSZ_WINDOWS`` (default "60,300");
``now`` is injectable so tests can replay a seeded latency stream and
check the window math deterministically. Thread-safe; stdlib only.
"""

from __future__ import annotations

import bisect
from collections import deque
from typing import Callable, Dict, Optional, Sequence

from lux_tpu_torch.obs import spans
from lux_tpu_torch.utils import flags
from lux_tpu_torch.utils.locks import make_lock

# Per-app retention cap: at 10k qps and a 300 s window this truncates,
# but /statusz quantiles over the *newest* 64k observations are still
# the right operational signal — and memory stays bounded.
MAX_OBSERVATIONS = 65536


def windows_from_flags() -> tuple:
    """Parse LUX_STATUSZ_WINDOWS ("60,300") into sorted unique seconds."""
    raw = flags.get("LUX_STATUSZ_WINDOWS") or ""
    out = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            w = float(part)
        except ValueError:
            continue     # malformed entry: fall through to the default
        if w > 0:
            out.append(w)
    return tuple(sorted(set(out))) or (60.0, 300.0)


def _quantile(sorted_xs: Sequence[float], q: float) -> float:
    """Exact linear-interpolation quantile of a sorted sample."""
    n = len(sorted_xs)
    if n == 0:
        return 0.0
    if n == 1:
        return sorted_xs[0]
    pos = q * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return sorted_xs[lo] * (1 - frac) + sorted_xs[hi] * frac


class SloWindows:
    """Timestamped latency ring per app; quantiles per rolling window."""

    def __init__(
        self,
        windows: Optional[Sequence[float]] = None,
        now: Optional[Callable[[], float]] = None,
        quantiles: Sequence[float] = (0.5, 0.95, 0.99),
    ):
        self.windows = tuple(sorted(windows)) if windows \
            else windows_from_flags()
        self.quantiles = tuple(quantiles)
        self._now = now if now is not None else spans.monotonic
        self._obs: Dict[str, deque] = {}
        self._lock = make_lock("obs.slo")

    def observe(self, app: str, seconds: float):
        t = self._now()
        with self._lock:
            d = self._obs.get(app)
            if d is None:
                d = self._obs[app] = deque(maxlen=MAX_OBSERVATIONS)
            d.append((t, float(seconds)))
            self._prune(d, t)

    def _prune(self, d: deque, now: float):
        horizon = now - self.windows[-1]
        while d and d[0][0] < horizon:
            d.popleft()

    def snapshot(self) -> dict:
        """``{"60s": {app: {count, p50, p95, p99}, ...}, "300s": ...}`` —
        the /statusz windows block."""
        now = self._now()
        with self._lock:
            per_app = {
                app: [(t, v) for (t, v) in d if t >= now - self.windows[-1]]
                for app, d in self._obs.items()
            }
        out = {}
        for w in self.windows:
            label = f"{w:g}s"
            block = {}
            horizon = now - w
            for app, obs in per_app.items():
                # obs is time-ordered; bisect to the window start.
                times = [t for (t, _) in obs]
                i = bisect.bisect_left(times, horizon)
                xs = sorted(v for (_, v) in obs[i:])
                if not xs:
                    continue
                entry = {"count": len(xs)}
                for q in self.quantiles:
                    entry[f"p{int(q * 100)}"] = _quantile(xs, q)
                block[app] = entry
            out[label] = block
        return out
