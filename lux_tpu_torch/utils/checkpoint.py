"""Checkpoint / resume of vertex state, a copy of
``lux_tpu/utils/checkpoint.py``: the same file, so a checkpoint written
by either package loads in the other.

The reference has none (SURVEY.md §5: state lives in device regions and is
never written back). Here vertex values are plain arrays, so checkpointing
is one compressed npz per snapshot: values + iteration counter + graph
fingerprint (to refuse resuming onto a different graph).

Two graphs must not collide just because their edge *sources* agree, so
the fingerprint samples all three structural arrays (sources,
destinations, offsets).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from lux_tpu_torch.graph.graph import Graph


class CheckpointError(ValueError):
    """A checkpoint file is missing, unreadable, or structurally wrong."""


def _sample_sum(a: np.ndarray, want: int = 1024) -> int:
    """Order-sensitive digest of up to ``want`` evenly-strided elements:
    each sample is weighted by its rank so permutations of the same
    multiset hash differently."""
    s = a[:: max(1, len(a) // want)][:want].astype(np.int64)
    return int(((np.arange(len(s), dtype=np.int64) + 1) * s).sum())


def fingerprint(graph: Graph) -> np.ndarray:
    """Cheap structural hash: counts plus rank-weighted samples of the
    edge sources, edge destinations, and CSC offsets. Sampling col_src
    alone would collide for graphs with identical sources but different
    destinations — e.g. the same out-edge multiset wired to different
    targets."""
    return np.array(
        [
            graph.nv,
            graph.ne,
            _sample_sum(graph.col_src),
            _sample_sum(graph.col_dst),
            _sample_sum(graph.row_ptr),
        ],
        dtype=np.int64,
    )


def fingerprint_hex(graph: Graph) -> str:
    """Compact string form of :func:`fingerprint` for dict/cache keys and
    JSON payloads."""
    return "-".join(format(int(v) & 0xFFFFFFFFFFFFFFFF, "x")
                    for v in fingerprint(graph))


def save(path: str, graph: Graph, values: np.ndarray, iteration: int,
         frontier: Optional[np.ndarray] = None) -> None:
    payload = {
        "values": values,
        "iteration": np.int64(iteration),
        "fingerprint": fingerprint(graph),
    }
    if frontier is not None:
        payload["frontier"] = frontier
    # Through a file object so the exact path is honored (np.savez would
    # silently append ".npz", breaking save->resume with the same path).
    with open(path, "wb") as f:
        np.savez_compressed(f, **payload)


def load(
    path: str, graph: Graph
) -> Tuple[np.ndarray, int, Optional[np.ndarray]]:
    """Load a checkpoint for ``graph``.

    Raises :class:`CheckpointError` (a ``ValueError``) with a clear
    message on a missing file, a non-npz/corrupt file, or an npz missing
    the checkpoint fields, not a raw ``KeyError``."""
    if not os.path.exists(path):
        raise CheckpointError(f"{path}: checkpoint file does not exist")
    try:
        z = np.load(path)
    except Exception as e:
        raise CheckpointError(
            f"{path}: not a readable checkpoint npz ({e})"
        ) from e
    with z:
        missing = {"values", "iteration", "fingerprint"} - set(z.files)
        if missing:
            raise CheckpointError(
                f"{path}: checkpoint is missing field(s) "
                f"{sorted(missing)} (corrupt or not a lux checkpoint)"
            )
        if not np.array_equal(z["fingerprint"], fingerprint(graph)):
            raise CheckpointError(
                f"{path}: checkpoint belongs to a different graph"
            )
        try:
            values = z["values"]
            iteration = int(z["iteration"])
            frontier = z["frontier"] if "frontier" in z.files else None
        except Exception as e:
            raise CheckpointError(
                f"{path}: checkpoint payload unreadable ({e})"
            ) from e
        return values, iteration, frontier
