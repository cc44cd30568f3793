"""Stdlib JSON/HTTP front end over a serving Session.

Endpoints:

- ``POST /query`` — body ``{"app": "sssp", "start": 3}`` (apps from the
  program registry: rooted apps take ``"start"``, pagerank ``"ni"``,
  kcore ``"k"``); optional
  ``"deadline_s"`` (per-request deadline), ``"targets": [v, ...]``
  (return only those vertices' values) or ``"full": true`` (the whole
  value array — gated by a size cap so a misdirected client cannot pull
  multi-GB arrays through JSON), or ``"digest": true`` (the SHA-256 of
  the value array's bytes, and of each per-vertex extra's, so a client
  can check a whole answer without fetching it). Default response
  carries summary stats only.
- ``GET /healthz`` — liveness: graph identity (nv, ne, fingerprint),
  pool warmth, the torch device the engines run on.
- ``GET /stats`` — pool/cache/batcher counters + latency quantiles.
- ``GET /metrics`` — Prometheus text exposition of the `obs` registry
  (``lux_xla_compiles_total``: here the kernel library's build and
  load, see analysis/sentinel.py; ``lux_ir_findings_total``, span
  histograms, ...); ``GET /metrics.json`` keeps the JSON snapshot.
- ``GET /statusz`` — rolling 1-min/5-min SLO windows (p50/p95/p99 per
  app), queue depth, cache hit rate, batch-width histogram, shed and
  recompile counters, the pool's audits and its HBM admission (the
  ``memory`` block) (JSON; windows set by ``LUX_STATUSZ_WINDOWS``).
- ``GET /costz`` — per-tenant cost accounting (serve/cost.py):
  cumulative totals (requests, engine seconds, exchange bytes,
  iterations, hit/miss) plus rolling engine-seconds quantiles per
  ``LUX_STATUSZ_WINDOWS`` window. Tenancy comes from the
  ``X-Lux-Tenant`` request header on ``POST /query`` (default tenant
  otherwise); each query's own spend comes back in ``X-Lux-Cost``.
- ``GET /snapshot`` — the serving snapshot version, fingerprint, delta
  ratio, and the store's version history.
- ``POST /snapshot`` — admin edit endpoint: body
  ``{"insert": [[u, v], ...], "delete": [[u, v], ...]}`` (weighted
  graphs take ``[u, v, w]`` inserts) applies the batch and hot-swaps
  serving onto version N+1 (serve/session.py ``apply_edits``); the old
  version drains and keeps answering throughout. 503 when warmup of the
  new version times out (the old version keeps serving). Add
  ``"queue": true`` to durably enqueue behind the WAL without swapping,
  or send ``{"flush": true}`` alone to fold the queue / retry an
  aborted swap (serve/session.py ``enqueue_edits``/``flush_edits``).
- ``POST /profilez`` — body ``{"steps": N}``: run a programmatic
  device-timeline capture window (obs/prof.py) over N engine steps and
  return the parsed ``profile.v1`` report. 403 unless ``LUX_PROF_DIR``
  is set; 429 while another capture is in flight.

Every JSON response carries ``X-Lux-Snapshot: <serving version>`` so
clients can observe a hot-swap from response headers alone, and is
counted into ``lux_requests_total{code=...}``. Degraded serving (a
failed N+1 warm; version N still answering) adds ``X-Lux-Degraded``
with the version that failed; shed responses (429/503/504) carry
``Retry-After`` seconds from the error taxonomy (serve/errors.py) or
the circuit breaker's cooldown remainder (serve/breaker.py). A query
answered by engines built under a tuned config (serve/session.py,
``LUX_TUNE_DIR``) carries ``X-Lux-Tuned`` with the ``tuneconf.v1``
artifact's id.

Every ``POST /query`` runs under a root request span (obs/spans.py):
the response carries the trace-id in ``X-Lux-Trace``, and the same id
keys the request's async lane in the Chrome trace. ``SIGUSR1`` (CLI
mode) dumps a flight.v1 postmortem to ``LUX_FLIGHT_DIR``; ``SIGUSR2``
toggles a profiler capture window under ``LUX_PROF_DIR``.

Error mapping: ``BadQueryError`` → 400, ``QueueFullError`` → 429,
``DeadlineExceededError`` → 504 (serve/errors.py owns the taxonomy).

``ThreadingHTTPServer`` gives one thread per in-flight request, which is
exactly what the micro-batcher wants: concurrent requests are all parked
inside the batching window and come out as one multi-source sweep.

The counterpart of ``lux_tpu/serve/http.py``:
``python -m lux_tpu_torch.serve.http -file g.lux`` serves on the card,
and without one exits unless ``LUX_PLATFORM=cpu`` asks for the CPU (the
kernels' plain versions), as the app CLIs do.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from lux_tpu_torch.obs import flight, metrics, prof, spans
from lux_tpu_torch.serve.errors import ServeError, BadQueryError
from lux_tpu_torch.serve.session import ServeConfig, Session
from lux_tpu_torch.utils import flags
from lux_tpu_torch.utils.logging import get_logger
from lux_tpu_torch.utils.platform import platform_device

# Above this many vertices, "full": true is refused; use "targets".
FULL_VALUES_CAP = 1 << 20


def _jsonable(v):
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return v


def digest(a) -> str:
    """The SHA-256 of an array's dtype and bytes (the ``"digest"`` of a
    query's answer)."""
    a = np.ascontiguousarray(a)
    return hashlib.sha256(a.dtype.str.encode() + a.tobytes()).hexdigest()


def render_result(result: dict, body: dict, nv: int) -> dict:
    """Shape one engine result for the wire: targets / full / summary.

    Per-vertex extras beyond ``values`` (GAS host finalizations: BFS
    ``parent``, labelprop ``labels``, kcore ``alive``) follow the same
    mode as ``values`` — sliced under ``targets``, whole under ``full``,
    dropped in summary mode — so the size cap governs them too. Scalar
    extras (iters, direction split, num_communities, ...) always pass."""
    vals = result["values"]
    extras = {k: v for k, v in result.items()
              if k != "values" and isinstance(v, np.ndarray)
              and v.shape == (nv,)}
    out = {k: _jsonable(v) for k, v in result.items()
           if k != "values" and k not in extras}
    targets = body.get("targets")
    if targets is not None:
        targets = [int(t) for t in targets]
        bad = [t for t in targets if not 0 <= t < nv]
        if bad:
            raise BadQueryError(f"targets out of range [0, {nv}): {bad}")
        out["targets"] = targets
        out["values"] = [_jsonable(vals[t]) for t in targets]
        for k, v in extras.items():
            out[k] = [_jsonable(v[t]) for t in targets]
    elif body.get("digest"):
        out["sha256"] = digest(vals)
        for k, v in extras.items():
            out[k + "_sha256"] = digest(v)
    elif body.get("full"):
        if nv > FULL_VALUES_CAP:
            raise BadQueryError(
                f"full values refused for nv={nv} > {FULL_VALUES_CAP}; "
                "use 'targets'"
            )
        out["values"] = vals.tolist()
        for k, v in extras.items():
            out[k] = v.tolist()
    else:
        out["summary"] = {
            "min": _jsonable(vals.min()),
            "max": _jsonable(vals.max()),
            "mean": float(np.asarray(vals, dtype=np.float64).mean()),
        }
    return out


class _Handler(BaseHTTPRequestHandler):
    # Set by make_server():
    session: Session = None
    log = None

    protocol_version = "HTTP/1.1"

    def _reply(self, status: int, payload: dict,
               trace_id: str = None, retry_after: float = None,
               cost: str = None, tuned: dict = None):
        body = json.dumps(payload).encode()
        # Counted HERE and only here, so every terminal status — success,
        # shed, breaker-open, handler bug — lands in one per-code series
        # (the chaos harness sums these against requests issued).
        metrics.counter("lux_requests_total", {"code": str(status)}).inc()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if trace_id:
            self.send_header("X-Lux-Trace", trace_id)
        if cost:
            # What this query spent (serve/cost.py): tenant, cache
            # outcome, iterations, engine seconds, exchange bytes.
            self.send_header("X-Lux-Cost", cost)
        if retry_after is not None:
            # Shed responses (429/503/504) tell clients when to come
            # back instead of letting them hammer a known-bad window.
            self.send_header("Retry-After", f"{max(0.0, retry_after):.3f}")
        if tuned:
            # Tune provenance: which tuneconf.v1 artifact the answering
            # engines were built under (absent on default-config apps),
            # so a client-side A/B can attribute latency to the tuner.
            self.send_header("X-Lux-Tuned", tuned["id"])
        if self.session is not None:
            self.send_header("X-Lux-Snapshot", str(self.session.version))
            degraded = self.session.degraded
            if degraded is not None:
                # Stale-while-revalidate marker: the served version is
                # live but a newer one failed to warm (serve/session.py).
                self.send_header("X-Lux-Degraded",
                                 str(degraded.get("failed_version")))
        self.end_headers()
        self.wfile.write(body)

    def _reply_text(self, status: int, body: str,
                    content_type: str = "text/plain; version=0.0.4"):
        data = body.encode()
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, fmt, *args):   # route through lux logging
        if self.log is not None:
            self.log.debug("%s " + fmt, self.address_string(), *args)

    def do_GET(self):
        s = self.session
        if self.path == "/healthz":
            pool_warm = len(s.pool) > 0
            device = str(s.device)
            if s.device.type == "cuda":
                import torch

                device += f" ({torch.cuda.get_device_name(s.device)})"
            self._reply(200 if pool_warm else 503, {
                "ok": bool(pool_warm), "nv": s.graph.nv, "ne": s.graph.ne,
                "fingerprint": s.fingerprint,
                "pool_warm": pool_warm, "engines": len(s.pool),
                "device": device,
            })
        elif self.path == "/stats":
            self._reply(200, s.stats())
        elif self.path == "/statusz":
            self._reply(200, s.statusz())
        elif self.path == "/costz":
            self._reply(200, s.costz())
        elif self.path == "/metrics":
            self._reply_text(200, metrics.render_prometheus())
        elif self.path == "/metrics.json":
            self._reply(200, {"metrics": metrics.snapshot()})
        elif self.path == "/snapshot":
            self._reply(200, s.snapshot_info())
        else:
            self._reply(404, {"error": f"no such endpoint {self.path}"})

    def do_POST(self):
        if self.path == "/snapshot":
            self._post_snapshot()
            return
        if self.path == "/profilez":
            self._post_profilez()
            return
        if self.path != "/query":
            self._reply(404, {"error": f"no such endpoint {self.path}"})
            return
        # The ROOT span of the request trace: handler-thread work plus
        # (via the Future the session blocks on) the batcher/engine
        # spans that adopt this trace-id on other threads.
        with spans.span("http.request", path=self.path) as tid:
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(body, dict):
                    raise BadQueryError("body must be a JSON object")
                app = body.get("app")
                params = {
                    k: v for k, v in body.items()
                    if k in ("start", "ni", "k")
                }
                fut = self.session.submit(
                    app, deadline_s=body.get("deadline_s"),
                    tenant=self.headers.get("X-Lux-Tenant"), **params
                )
                result = fut.result()
                qc = getattr(fut, "_lux_cost", None)
                self._reply(
                    200, render_result(result, body, self.session.graph.nv),
                    trace_id=tid,
                    cost=qc.header() if qc is not None else None,
                    tuned=self.session.tuned_for(app),
                )
            except ServeError as e:
                self._reply(e.http_status, {
                    "error": str(e), "kind": type(e).__name__,
                }, trace_id=tid, retry_after=e.retry_after_s)
            except json.JSONDecodeError as e:
                self._reply(400, {"error": f"bad JSON: {e}",
                                  "kind": "BadQueryError"}, trace_id=tid)
            except Exception as e:   # engine bug: surface, keep serving
                self._reply(500, {"error": str(e),
                                  "kind": type(e).__name__}, trace_id=tid)

    def _post_snapshot(self):
        from lux_tpu_torch.graph.delta import EdgeEdits

        # Its own root span: one trace-id covers the whole swap —
        # snapshot.apply, the background warm (it adopts this id), the
        # incremental refresh, and the drain barrier.
        with spans.span("http.request", path=self.path) as tid:
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(body, dict):
                    raise BadQueryError("body must be a JSON object")
                if body.get("flush") and not (body.get("insert")
                                              or body.get("delete")):
                    # Revalidate / coalesce: fold whatever is queued (or
                    # retry an aborted swap) without new edits.
                    summary = self.session.flush_edits()
                    self._reply(200, summary, trace_id=tid)
                    return
                try:
                    edits = EdgeEdits.from_lists(
                        insert=body.get("insert", ()),
                        delete=body.get("delete", ()),
                    )
                except (TypeError, ValueError, IndexError) as e:
                    raise BadQueryError(f"bad edit batch: {e}")
                if body.get("queue"):
                    # WAL-backed write-behind: durable immediately,
                    # swapped on the next flush (ROADMAP item 3).
                    summary = self.session.enqueue_edits(edits)
                else:
                    summary = self.session.apply_edits(edits)
                self._reply(200, summary, trace_id=tid)
            except ServeError as e:
                self._reply(e.http_status, {
                    "error": str(e), "kind": type(e).__name__,
                }, trace_id=tid, retry_after=e.retry_after_s)
            except json.JSONDecodeError as e:
                self._reply(400, {"error": f"bad JSON: {e}",
                                  "kind": "BadQueryError"}, trace_id=tid)
            except Exception as e:   # swap bug: surface, keep serving
                self._reply(500, {"error": str(e),
                                  "kind": type(e).__name__}, trace_id=tid)

    def _post_profilez(self):
        """``POST /profilez {"steps": N}`` — programmatic capture
        window: N engine steps under ``torch.profiler``, parsed into
        the ``profile.v1`` report returned as the response body. Guarded:
        403 when ``LUX_PROF_DIR`` is unset (profiling unarmed — captures
        must be an explicit operator decision, not a default-on endpoint
        anyone can hit), 429 when a capture is already in flight (one
        window at a time; concurrent queries keep serving either way)."""
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(body, dict):
                raise BadQueryError("body must be a JSON object")
            if not flags.get("LUX_PROF_DIR"):
                self._reply(403, {
                    "error": "profiling unarmed: set LUX_PROF_DIR",
                    "kind": "ProfilingDisabled"})
                return
            try:
                steps = int(body.get("steps", 8))
            except (TypeError, ValueError):
                raise BadQueryError("'steps' must be an integer")
            rep = self.session.profile_capture(steps)
            self._reply(200, rep)
        except prof.CaptureBusyError as e:
            self._reply(429, {"error": str(e), "kind": "CaptureBusyError"},
                        retry_after=1.0)
        except BadQueryError as e:
            self._reply(400, {"error": str(e), "kind": "BadQueryError"})
        except json.JSONDecodeError as e:
            self._reply(400, {"error": f"bad JSON: {e}",
                              "kind": "BadQueryError"})
        except Exception as e:   # capture bug: surface, keep serving
            self._reply(500, {"error": str(e),
                              "kind": type(e).__name__})

    # query() futures raise ServeError subclasses; unwrap happens via
    # Future.result() re-raising them directly, so do_POST's except
    # clauses see the original types.


class _Server(ThreadingHTTPServer):
    # The socket's listen backlog: ``socketserver``'s default of 5 resets
    # connections when a burst of clients (a batching window's worth of
    # concurrent queries) connects at once.
    request_queue_size = 256


def make_server(
    session: Session, host: str = "127.0.0.1", port: int = 8399
) -> ThreadingHTTPServer:
    """An HTTP server bound to ``host:port`` serving ``session``; the
    caller owns ``serve_forever`` (run it in a thread for embedding)."""
    handler = type("LuxServeHandler", (_Handler,), {
        "session": session, "log": get_logger("serve.http"),
    })
    return _Server((host, port), handler)


def serve_in_thread(session: Session, host="127.0.0.1", port=0):
    """Start a server on a background thread; returns (server, thread).
    ``port=0`` binds an ephemeral port — read ``server.server_address``."""
    server = make_server(session, host, port)
    t = threading.Thread(
        target=server.serve_forever, name="lux-serve-http", daemon=True
    )
    t.start()
    return server, t


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(
        prog="lux_tpu_torch.serve.http",
        description="warm-engine graph query server"
    )
    p.add_argument("-file", required=True, help="input .lux graph")
    p.add_argument("-host", default="127.0.0.1")
    p.add_argument("-port", type=int, default=8399)
    p.add_argument("-max-batch", type=int, default=8, dest="max_batch",
                   help="multi-source lanes per SSSP sweep")
    p.add_argument("-window-ms", type=float, default=3.0, dest="window_ms",
                   help="micro-batching window")
    p.add_argument("-max-queue", type=int, default=64, dest="max_queue",
                   help="admission queue bound (backpressure beyond)")
    p.add_argument("-deadline-s", type=float, default=None,
                   dest="deadline_s", help="default per-request deadline")
    p.add_argument("-pagerank-iters", type=int, default=20,
                   dest="pagerank_iters")
    p.add_argument("-mesh", default=None,
                   help="serving mesh spec ('4' or 'PxQ'); default "
                   "LUX_SERVE_MESH. The parts share the one device")
    args = p.parse_args(argv)

    log = get_logger("serve")
    dev = platform_device()
    if dev.type == "cuda":
        import torch

        log.info("torch device: %s (%s)", dev,
                 torch.cuda.get_device_name(dev))
    else:
        log.info("torch device: %s", dev)
    cfg = ServeConfig(
        max_batch=args.max_batch,
        window_s=args.window_ms / 1e3,
        max_queue=args.max_queue,
        default_deadline_s=args.deadline_s,
        pagerank_iters=args.pagerank_iters,
        mesh=args.mesh,
    )
    session = Session(args.file, cfg, device=dev)
    server = make_server(session, args.host, args.port)
    if flight.install_signal_handler():
        log.info("SIGUSR1 -> flight.v1 postmortem (LUX_FLIGHT_DIR=%s)",
                 flags.get("LUX_FLIGHT_DIR"))
    if prof.install_signal_handler():
        log.info("SIGUSR2 -> profiler capture toggle (LUX_PROF_DIR=%s)",
                 flags.get("LUX_PROF_DIR"))
    log.info(
        "serving %s (nv=%d ne=%d) on http://%s:%d  "
        "[max_batch=%d window=%.1fms queue=%d mesh=%s]",
        args.file, session.graph.nv, session.graph.ne,
        args.host, server.server_address[1],
        cfg.max_batch, cfg.window_s * 1e3, cfg.max_queue,
        session.meshspec.spec,
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        session.close()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main(sys.argv[1:]))
