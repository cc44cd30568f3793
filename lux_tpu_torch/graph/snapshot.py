"""Versioned graph snapshots over
:class:`~lux_tpu_torch.graph.delta.DeltaGraph`; the counterpart of
``lux_tpu/graph/snapshot.py``.

A :class:`SnapshotStore` holds the linear version history of one logical
graph. ``apply(edits)`` stacks an edit batch onto the current snapshot's
delta and mints version N+1; each snapshot is identified by the hardened
checkpoint fingerprint of its *materialized* graph, which is what keys
every serving engine and cache entry downstream. When a snapshot's
pending-edit ratio crosses ``LUX_DELTA_COMPACT_RATIO`` the store kicks a
background compaction thread that re-anchors the delta on the merged CSC
— the merged arrays are reused as-is, so compaction never changes the
fingerprint (tested: compaction round-trips are bitwise no-ops for
readers). The next ``apply`` compacts such a snapshot itself if the
thread has not yet, so which anchor a version stacks on (and with it the
order of a row's inserted edges) follows from the ratios alone, the rule
that WAL replay rebuilds it by.

Durability: pass ``wal_dir`` (or set ``LUX_WAL_DIR``) and the store
writes every edit batch through :mod:`lux_tpu_torch.graph.wal` *before* any version is minted —
``enqueue`` logs + stages a batch without swapping (a write-ahead queue;
many small batches coalesce into one ``apply``), ``apply`` folds all
staged batches, mints
version N+1, and seals it with a fingerprinted commit record.
:meth:`SnapshotStore.recover` replays the log on startup onto the base
graph, yielding a bitwise-identical current snapshot with any
uncommitted batches re-staged.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

from lux_tpu_torch.graph.delta import DeltaGraph, EdgeEdits
from lux_tpu_torch.graph.graph import Graph
from lux_tpu_torch.obs import metrics, spans
from lux_tpu_torch.utils import checkpoint, flags
from lux_tpu_torch.utils.locks import make_lock


class Snapshot:
    """One immutable version: a DeltaGraph plus lazy graph/fingerprint."""

    def __init__(self, version: int, delta: DeltaGraph):
        self.version = version
        self._delta = delta
        self._lock = make_lock("snapshot")
        self._fingerprint: Optional[str] = None
        self.compacted = delta.delta_edges == 0
        # Past LUX_DELTA_COMPACT_RATIO when minted: compacted before the
        # next version stacks on it.
        self.compact_due = False

    @property
    def delta(self) -> DeltaGraph:
        return self._delta

    @property
    def graph(self) -> Graph:
        return self._delta.merged()

    @property
    def fingerprint(self) -> str:
        if self._fingerprint is None:
            with self._lock:
                if self._fingerprint is None:
                    self._fingerprint = checkpoint.fingerprint_hex(self.graph)
        return self._fingerprint

    @property
    def ratio(self) -> float:
        return self._delta.ratio

    def compact(self) -> None:
        """Re-anchor the delta on its merged CSC (idempotent).

        ``merged()`` of the fresh delta returns the same Graph object the
        old delta materialized, so fingerprints and any reader holding
        ``.graph`` are unaffected — compaction only drops the edit runs
        and frees the old base for GC.
        """
        with self._lock:
            if not self.compacted:
                self._delta = DeltaGraph.fresh(self._delta.merged())
                self.compacted = True


class SnapshotStore:
    """Linear version history with threshold-triggered background compaction."""

    def __init__(self, base: Graph, wal_dir: Optional[str] = None):
        """``wal_dir`` None takes ``LUX_WAL_DIR``; "" or both unset = no
        WAL."""
        if wal_dir is None:
            wal_dir = flags.get("LUX_WAL_DIR")
        self._lock = make_lock("snapshot.store")
        self._snaps: List[Snapshot] = [Snapshot(0, DeltaGraph.fresh(base))]
        self._compaction_threads: List[threading.Thread] = []
        self._pending: List[EdgeEdits] = []
        self._wal = None
        if wal_dir:
            from lux_tpu_torch.graph.wal import Wal
            self._wal = Wal(wal_dir)

    @classmethod
    def recover(cls, base: Graph, wal_dir: Optional[str] = None
                ) -> "SnapshotStore":
        """Rebuild a store from ``base`` plus the WAL in ``wal_dir``
        (None takes ``LUX_WAL_DIR``).

        The recovered current snapshot is bitwise-identical to the last
        *committed* (minted) version before the crash — a torn tail
        record is truncated, never fatal — and edit batches logged but
        not yet committed are re-staged as pending, so the next
        ``apply()`` mints them exactly as the dead process would have.
        Raises :class:`~lux_tpu_torch.graph.wal.WalCorruptError` on
        interior damage rather than serving a silently wrong graph."""
        from lux_tpu_torch.graph import wal as walmod
        if wal_dir is None:
            wal_dir = flags.get("LUX_WAL_DIR")
        if not wal_dir:
            raise ValueError("recover needs a wal_dir or LUX_WAL_DIR")
        result = walmod.replay(base, wal_dir)
        store = cls(result.graph, wal_dir=wal_dir)
        # Version numbering resumes where the dead process left off: the
        # log's commit records carry versions, and downstream state
        # (metrics, serving summaries) must not watch versions run
        # backwards across a restart. The head keeps the delta replay
        # rebuilt, so the next version stacks on the writer's anchor.
        head = Snapshot(result.version, result.delta)
        head._fingerprint = result.fingerprint
        head.compact_due = result.delta.ratio > flags.get_float(
            "LUX_DELTA_COMPACT_RATIO")
        store._snaps[-1] = head
        store._pending.extend(result.pending)
        return store

    # -- reads -----------------------------------------------------------

    def current(self) -> Snapshot:
        with self._lock:
            return self._snaps[-1]

    def get(self, version: int) -> Snapshot:
        with self._lock:
            # After recover() the history starts at the replayed version,
            # not 0 — index relative to the first retained snapshot.
            idx = version - self._snaps[0].version
            if not 0 <= idx < len(self._snaps):
                raise KeyError(f"unknown snapshot version {version}")
            return self._snaps[idx]

    def history(self) -> List[dict]:
        with self._lock:
            snaps = list(self._snaps)
        return [
            {
                "version": s.version,
                "delta_edges": s.delta.delta_edges,
                "ratio": round(s.ratio, 6),
                "compacted": s.compacted,
            }
            for s in snaps
        ]

    def pending_edits(self) -> int:
        """Batches enqueued behind the WAL but not yet minted."""
        with self._lock:
            return len(self._pending)

    def pending_batches(self) -> tuple:
        """Snapshot of the enqueued batches (read-only; apply() drains)."""
        with self._lock:
            return tuple(self._pending)

    def wal_stats(self) -> Optional[dict]:
        return self._wal.stats() if self._wal is not None else None

    # -- writes ----------------------------------------------------------

    def enqueue(self, edits: EdgeEdits) -> int:
        """Durably stage one batch without minting a version.

        The batch is validated, appended (CRC-framed, fsync'd) to the WAL
        chained on the current snapshot's fingerprint, and staged; the
        next :meth:`apply` folds every staged batch into ONE new version,
        so swaps amortize over many small edits. With no
        ``wal_dir`` the queue still works — it just isn't durable.
        Returns the pending-batch count."""
        with self._lock:
            head = self._snaps[-1]
        edits.validate(head.delta.base.nv)
        with spans.span("snapshot.enqueue"):
            # The WAL append and the stage are one critical section under
            # the store lock: an apply() draining the queue concurrently
            # must not commit between our append and our stage, or the
            # log would chain a batch onto a fingerprint it never saw.
            with self._lock:
                if self._wal is not None:
                    self._wal.append_edits(edits, self._snaps[-1].fingerprint)
                self._pending.append(edits)
                return len(self._pending)

    def apply(self, edits: Optional[EdgeEdits] = None,
              on_compact: Optional[Callable[[Snapshot], None]] = None
              ) -> Snapshot:
        """Fold ``edits`` plus every enqueued batch into version N+1.

        WAL-before-mint: ``edits`` goes through :meth:`enqueue` first, so
        by the time a version exists its batches are already durable; the
        mint is then sealed with a fingerprinted ``commit`` record.
        ``apply(None)`` flushes the queue alone (no-op if empty).

        Compaction past LUX_DELTA_COMPACT_RATIO runs on a background
        thread (adopting the caller's trace id so the swap's trace covers
        it); ``on_compact`` fires after it finishes. A snapshot minted
        past the ratio is compacted before the next version stacks on it,
        here if the thread has not finished, so the anchor never depends
        on which comes first.
        """
        if edits is not None:
            self.enqueue(edits)
        with spans.span("snapshot.apply") as tid:
            with self._lock:
                head = self._snaps[-1]
                if not self._pending:
                    return head
                batches, self._pending = self._pending, []
                if head.compact_due:
                    head.compact()      # a no-op once the thread has run
                delta = head.delta
                for e in batches:
                    delta = delta.stack(e)
                snap = Snapshot(head.version + 1, delta)
                snap.compact_due = snap.ratio > flags.get_float(
                    "LUX_DELTA_COMPACT_RATIO")
                self._snaps.append(snap)
                if self._wal is not None:
                    # Fingerprint forces materialization; the store lock
                    # is held so the commit serializes against enqueue's
                    # chain read (see enqueue). Swaps already pay the
                    # merge here — the warm path needs the graph anyway.
                    self._wal.append_commit(snap.version, snap.fingerprint)
            if snap.compact_due:
                t = threading.Thread(
                    target=self._compact_one, args=(snap, tid, on_compact),
                    name=f"lux-compact-v{snap.version}", daemon=True,
                )
                with self._lock:
                    self._compaction_threads.append(t)
                t.start()
        return snap

    def _compact_one(self, snap: Snapshot, trace_id, on_compact) -> None:
        with spans.adopt(trace_id):
            with spans.span("snapshot.compact", version=snap.version,
                            delta_edges=snap.delta.delta_edges):
                snap.compact()
                # Looked up at each use: a registry reset (tests) must
                # not orphan the counter the store increments.
                metrics.counter("lux_snapshot_compactions_total").inc()
        if on_compact is not None:
            on_compact(snap)

    def drain_compactions(self, timeout: float = 30.0) -> None:
        """Join outstanding compaction threads (tests / Session.close)."""
        with self._lock:
            threads = list(self._compaction_threads)
        for t in threads:
            t.join(timeout)
        with self._lock:
            self._compaction_threads = [
                t for t in self._compaction_threads if t.is_alive()
            ]
