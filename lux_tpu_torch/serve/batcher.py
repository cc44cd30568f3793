"""Admission queue + multi-source micro-batcher.

One worker thread drains a bounded queue. On each wakeup it takes the
oldest request, then keeps collecting until either the batching window
closes or the batch is full — the classic inference-serving tradeoff
(window of latency traded for batched throughput), applied to graph
traversal: K root queries that share a (program, graph) key become ONE
dense multi-source sweep (engine/push.py MultiSourcePushExecutor).

Admission control:
- ``submit`` never blocks: a full queue raises ``QueueFullError``
  immediately (backpressure to the client, HTTP 429) instead of
  deadlocking producers behind a slow engine.
- every request may carry a deadline; requests whose deadline passed
  while queued are shed at dequeue with ``DeadlineExceededError`` and an
  `obs` counter increment — they never occupy engine time.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Hashable, List, Optional

from lux_tpu_torch.obs import flight, metrics, spans
from lux_tpu_torch.serve.errors import DeadlineExceededError, QueueFullError
from lux_tpu_torch.utils import faults

# Batch sizes are small integers; the seconds-oriented default bucket
# bounds would collapse them into two buckets.
BATCH_SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, float("inf"))


@dataclass
class Request:
    """One admitted query. ``batch_key`` groups batchable requests (same
    program + graph + engine config); ``batch_key=None`` means the
    request must execute alone. ``payload`` is interpreted by the
    executor callback (for SSSP batches: the root vertex)."""

    app: str
    payload: Any
    batch_key: Optional[Hashable]
    future: Future = field(default_factory=Future)
    deadline: Optional[float] = None      # spans.monotonic() stamp
    enqueued_at: float = field(default_factory=spans.monotonic)
    # Captured at construction on the admitting thread, so the batcher
    # worker can continue the request's trace (spans.adopt).
    trace_id: Optional[str] = field(default_factory=spans.current_trace_id)
    # Per-query cost record (serve/cost.py), filled by the executor
    # callback before the future resolves; None for internal requests
    # (hot-swap barriers) and cost-unaware callers.
    cost: Any = None

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline is None:
            return False
        return (now if now is not None else spans.monotonic()) > self.deadline


class MicroBatcher:
    """Bounded admission queue + window-based batch former.

    ``execute(requests)`` is called on the worker thread with a list of
    requests sharing one ``batch_key`` (or a singleton list for
    unbatchable requests); it must resolve every request's future.
    """

    def __init__(
        self,
        execute: Callable[[List[Request]], None],
        max_batch: int = 8,
        window_s: float = 0.003,
        max_queue: int = 64,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1 (got {max_batch})")
        self._execute = execute
        self.max_batch = int(max_batch)
        self.window_s = float(window_s)
        self._q: "queue.Queue[Request]" = queue.Queue(maxsize=max_queue)
        self._rejected = metrics.counter("lux_serve_rejected_total")
        self._expired = metrics.counter("lux_serve_deadline_expired_total")
        self._depth = metrics.gauge("lux_serve_queue_depth")
        self._batch_hist = metrics.histogram(
            "lux_serve_batch_size", buckets=BATCH_SIZE_BUCKETS
        )
        # Event, not a bare bool: set by close() on the caller thread,
        # polled by submit() and the worker.
        self._closed = threading.Event()
        self._carry: Optional[Request] = None   # worker-thread-only state
        self._thread = threading.Thread(
            target=self._loop, name="lux-serve-batcher", daemon=True
        )
        self._thread.start()

    # -- producer side ---------------------------------------------------

    def submit(self, req: Request) -> Future:
        """Admit ``req`` or raise ``QueueFullError`` without blocking."""
        if self._closed.is_set():
            raise QueueFullError("server is shutting down")
        with spans.span("serve.admit", app=req.app):
            try:
                self._q.put_nowait(req)
            except queue.Full:
                self._rejected.inc()
                flight.dump(
                    "queue_reject",
                    detail=f"app={req.app} queue full "
                           f"({self._q.maxsize} pending)",
                )
                raise QueueFullError(
                    f"admission queue full ({self._q.maxsize} pending); "
                    "retry"
                ) from None
            self._depth.set(self._q.qsize())
        return req.future

    # -- worker side -----------------------------------------------------

    def _collect(self, first: Request) -> List[Request]:
        """``first`` plus whatever arrives before the window closes, up
        to max_batch. Only requests matching ``first.batch_key`` extend
        the batch; a non-matching arrival ends collection and leads the
        next batch (FIFO across batches, no starvation)."""
        batch = [first]
        if first.batch_key is None or self.max_batch == 1:
            return batch
        t_close = spans.monotonic() + self.window_s
        while len(batch) < self.max_batch:
            remaining = t_close - spans.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt.batch_key == first.batch_key:
                batch.append(nxt)
            else:
                self._carry = nxt
                break
        return batch

    def _loop(self):
        while True:
            if self._carry is not None:
                first, self._carry = self._carry, None
            else:
                try:
                    first = self._q.get(timeout=0.1)
                except queue.Empty:
                    if self._closed.is_set():
                        return
                    continue
            t_asm = spans.clock()
            batch = self._collect(first)
            spans.complete(
                "serve.batch_assemble", spans.clock() - t_asm,
                trace_id=first.trace_id, app=first.app, size=len(batch),
            )
            self._depth.set(self._q.qsize())
            now = spans.monotonic()
            live = []
            for r in batch:
                wait = max(0.0, now - r.enqueued_at)
                if r.expired(now):
                    self._expired.inc()
                    spans.complete("serve.queue_wait", wait,
                                   trace_id=r.trace_id, app=r.app,
                                   shed=True)
                    flight.dump(
                        "deadline_shed",
                        detail=f"app={r.app} waited {wait:.3f}s in queue",
                    )
                    r.future.set_exception(DeadlineExceededError(
                        f"deadline expired after {wait:.3f}s in queue"
                    ))
                else:
                    spans.complete("serve.queue_wait", wait,
                                   trace_id=r.trace_id, app=r.app)
                    live.append(r)
            if not live:
                continue
            self._batch_hist.observe(len(live))
            # The lead request's trace owns the engine-side spans: one
            # trace in the batch shows the full admission->batch->engine
            # ->cache chain (the serve_smoke acceptance assertion).
            with spans.adopt(live[0].trace_id):
                with spans.span("serve.batch", app=live[0].app,
                                size=len(live)):
                    try:
                        # Inside the fail-the-batch guard: an injected
                        # raise here resolves every future (terminal
                        # status), never kills the worker thread.
                        faults.point("batcher.assemble")
                        self._execute(live)
                    # An engine bug fails the batch; the worker keeps
                    # serving.
                    except Exception as e:
                        flight.dump("engine_exception", detail=repr(e))
                        for r in live:
                            if not r.future.done():
                                r.future.set_exception(e)

    def close(self, timeout: float = 5.0):
        """Stop admitting, drain the worker, fail leftover requests."""
        self._closed.set()
        self._thread.join(timeout)
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                break
            r.future.set_exception(QueueFullError("server shut down"))

    def batch_histogram(self) -> dict:
        """Snapshot of the achieved batch-width histogram (/statusz)."""
        return self._batch_hist.snapshot()

    def stats(self) -> dict:
        return {
            "queue_depth": self._q.qsize(),
            "queue_capacity": self._q.maxsize,
            "rejected": int(self._rejected.value),
            "deadline_expired": int(self._expired.value),
            "batches": int(self._batch_hist.count),
            "max_batch": self.max_batch,
            "window_s": self.window_s,
        }
