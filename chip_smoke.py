#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lux_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--scale 22]

Drives the port's main paths through the entry points a user calls, on
an R-MAT graph of the given scale (edge factor 16, seed 42: the JAX
package's headline graph at the default scale 22). First tiled pull
PageRank in both tail configurations (lane-select, and the grouped
merge-network tail of ``LUX_GROUPED_TAIL=1``):

1. environment: the card, and its name and power limit from nvidia-smi;
2. build: compile the CUDA kernels from ``lux_tpu_torch/csrc`` and the
   native host library (``lux_tpu_torch/native/lux_native.cc``, with
   ``g++``; a failed build fails the run);
2p. the program-contract tier (``analysis/gasck.py``) with the program
   hooks on the card: ``python -m lux_tpu_torch.tools.luxlint --programs
   --gascap-out`` (rc 0, 0 findings over the 8 registry programs, the
   artifact's id the committed ``lux_tpu_torch/analysis/gascap.json``'s),
   each fixture of ``tests/torch_gas_fixtures/`` firing exactly its
   rule, and the incremental gate admitting an SSSP that does not
   declare ``incremental_ok`` and refusing ``DriftingMin`` and
   ``Claimant`` (LUX604, gather not inflationary), with the tier's
   seconds (the CLI runs beside the graph's generation of phase 3);
2q. the static tiers (``analysis/rules.py``, ``threads.py``,
   ``planck.py``, ``exchck.py``) on the card's host, and
   ``HostTransferGuard`` on the card: ``python -m
   lux_tpu_torch.tools.luxlint`` (the AST tier) and ``--threads``
   beside the graph's generation, each rc 0 with 0 findings and
   its suppressions counted per rule; phase 3's grouped-tail plan (the
   one the grouped executor runs, kept from its build, not planned
   again) saved with ``save_grouped_plan``, loaded back by mmap,
   uploaded, its grouped tail (K3 per level, K4) bitwise the executor's,
   and ``luxlint --plans`` over it (0 findings) and over a copy with one
   code flipped (LUX203 only), beside the phases that follow, with its
   bytes and seconds; the compact exchange plans of phases 3e, 3g and 3h
   saved with ``save_exchange_artifact`` and ``luxlint --exchange`` over
   them (0 findings) and over a copy with one ``recv_pos`` misrouted
   (LUX402 only); ten ``step`` calls of phase 5's tiled executor (K1,
   K2) under the guard, then ``torch.cuda.synchronize()`` inside
   ``allow()``; ``.item()``, ``.cpu()``, ``.tolist()`` and ``float()``
   of a CUDA tensor each raising ``HostTransferError`` inside it, and the
   push executor's SSSP ``step`` raising at its counter read (ROADMAP
   A20); in 6m's session, the pool's exchange audit reading every compact
   build (a compact sharded tiled engine joins it) with 0 findings;
2r. the trace tiers (``analysis/trace.py``, ``analysis/ir.py``) on the
   card: ``luxlint --ir`` (the 59 registry targets' steps traced on the
   card, LUX101-105) and ``--exchange`` (the sharded registry's 40 traced
   steps, LUX404-406, and its 23 compact plans, LUX401-403/407) beside
   the graph's generation, each rc 0 with 0 findings; after group 3-6,
   each torch fixture of ``tests/torch_ir_fixtures/`` through luxlint's
   ``main`` on the card (rc 1, exactly its rule), and every registry
   target traced here on the card and on the CPU (0 findings on the
   card; kernel and collective nodes equal in sequence and shape, glue
   ops compared and logged); at scale, the steps of phase 5's two tiled
   executors (K1, K2; K1, K3 per level, K4) and of phase 3h's compact
   BFS executor (push and pull as alternatives) traced with 0 findings,
   each with its seconds, nodes, largest intermediate over its input
   bytes and launches; in 6m's session, the pool's LUX104 audit on
   every build (its declaration read; a step run where one donates)
   with 0 findings, and each served engine's declaration held against
   one run of its step;
3. graph and plans: generate the graph, plan it, build both executors
   (each strip level becomes a cell stream on the card; the build's
   seconds are logged per level);
4. each kernel against its plain PyTorch version at the main path's
   shapes (K3 bitwise; K1, K2, K4 bitwise on small integers and within
   rtol=5e-5, atol=1e-9 on random floats), with its time, the plain
   version's, a one-call PyTorch yardstick where there is one, and the
   least time the card needs to move the bytes; K1 also bitwise on small
   integers against the strip-form product of the host plan's strips,
   a chunk at a time, and beside its bound on the cells the bound the
   strip layout had; K2 as the main path calls it, from the (nv,)
   values and adding into a vector, bitwise on small integers with and
   without the add, beside cuSPARSE; K4 as the main path calls it too,
   adding into a vector, bitwise on small integers;
5. end to end: ``run(10)`` in both configurations against the f64 oracle
   at rtol=5e-5, atol=1e-9, with every kernel's launch count checked;
6. timing: ms per iteration and GTEPS for both configurations, the
   per-phase split from ``phase_step``, and the phases' peak device
   memory.

Right after phase 6, on phase 3's plan (planning is not repeated), the
sharded tiled engine (``ShardedTiledExecutor``): PageRank over 4 parts
of a ``LocalMesh`` on the card, in the full and compact exchange modes:

3g. the partition (blocks, cells and bands of rows per part and level,
    tail edges per part, ``max_nvb``) and which mode
    ``LUX_EXCHANGE=compact`` resolves to;
4g. K1 and K2 at one part's shapes against their plain versions
    (bitwise on small integers, within rtol=5e-5, atol=1e-9 on random
    floats), with the same timings; K2 also on the last part;
5g. end to end: ``run(10)`` in both modes against phase 5's f64 oracle
    at rtol=5e-5, atol=1e-9, compact equal to full bitwise, K1 once per
    part and level and K2 once per part per iteration;
6g. timing: median of 3 runs after ``warmup``, ms per iteration, GTEPS,
    the ``phase_step`` split (exchange, strips, tail, apply), the device
    busy share, the exchange and the strip merge (``stack_map`` and
    ``reduce_scatter``) alone against their bytes bounds, and the
    phases' peak device memory.

Then the gather probes P2-P7 (``lux_tpu_torch.probes``), phase 4g too:
each probe's entry point as a user runs it, with its launches counted
(P2's axis-0 lines of 512 rows and more through the strip kernel), then
``block_take`` in its four forms (P3-P5), each of P2's axis-0 lines,
``merge4`` and P7's K3 launch bitwise against their plain versions at
the probes' full shapes, each with its time (P3-P5 and P2's largest
line beside PR 15's), the plain version's, one ``torch.gather`` call's
where one computes the same function, and its bytes bound; ``merge4``
also twice bitwise, by medians of 100 calls beside ``torch.gather``'s,
and beside its time before its redesign and its bytes floors (distinct
elements, touched 32-byte sectors, all candidates streamed).

Then the push engine (``PushExecutor``): SSSP from vertex 0 on the same
graph and Connected Components on its undirected closure:

3b. push graphs: the closure and both executors;
4b. K5-K7 against their plain versions at the main path's shapes, all
    bitwise, with the same timings; K5 in both input forms (the packed
    table, and values with the frontier's bits), two calls bitwise
    equal, beside its time before its redesign and its L2 sector bytes
    as an achieved rate; K6 also on a dense frontier (half
    the vertices) and at nv = 2^28 on a row pointer made on the card
    (the last vertex alone, and a seeded sparse frontier) beside
    ``torch.nonzero``; K6 and K7 at the sparse branch's cap (nv // 16 +
    128 vertices) and K7 on SSSP's first frontier, medians of 100
    calls, beside ``torch.nonzero`` and one ``scatter_reduce``;
5b. end to end: both applications to fixpoint, bitwise against the
    vectorised oracles, zero invariant violations, launch counts checked
    against the branch each iteration took;
6b. timing: median of 3 runs to fixpoint, ms per iteration, GTEPS, the
    median phase split per branch, and the cost of the per-iteration
    host read.

Then the flat pull engine (``PullExecutor``): flat PageRank on the same
graph, and Collaborative Filtering on ``bench.py``'s NetFlix-shaped
ratings graph (at scale 22: 480,000 users, 17,777 items, 50,331,648
ratings in both directions, seed 11), which it runs edge-chunked:

3c. pull executors: the ratings graph, both executors, their
    ``edge_chunk`` (0 and ``1 << 20`` at scale 22);
4c. K8 and K9 against their plain versions at the main path's shapes
    (bitwise on small integers; K8 within rtol=5e-5, atol=1e-9 and K9
    within CF's rtol=1e-4, atol=1e-7 on random floats), two calls bitwise
    equal, with the same timings, each time also beside the kernel's time
    before its redesign, and the L2 sector bytes of its random gathers
    as an achieved rate;
5c. end to end: flat PageRank ``run(10)`` against phase 5's f64 oracle,
    CF ``run(5)`` against its f64 oracle (computed on the card) at
    rtol=1e-4, atol=1e-7 with the RMSE before and after, launch counts
    checked;
6c. timing: median of 3 runs after ``warmup``, ms per iteration, GTEPS
    (``bench.py``'s definition) and the device busy share.

Then the direction-adaptive GAS engine (``AdaptiveExecutor``,
``MultiSourceGasExecutor``) on ``bench.py``'s GAS rows: BFS from vertex 0
and label propagation on the graph, DeltaSSSP from vertex 0 on its
weighted twin (the same edges; the graph above is this twin without its
weights, generated once), k-core (k = 4) on the undirected closure:

3d. GAS executors (adaptive), and the multi-source BFS executor (k = 8);
4d. K10 and K11 against their plain versions, bitwise, on states taken
    mid-run for every (combiner, type, gather op) of the four programs,
    and K10 with 8 columns, with the same timings;
5d. end to end: each program to its fixpoint in the adaptive, pinned
    pull and pinned push modes, bitwise against its oracle (BFS depths
    and parents, DeltaSSSP distances with zero invariant violations,
    labels and their community count, k-core's frozen degrees and core
    size) and against each other; the multi-source lanes against the
    single-source runs; PageRank through ``PullGasAdapter`` ``run(10)``
    against phase 5's f64 oracle; launch counts checked against the
    direction each iteration took;
6d. timing by ``bench.py``'s ``bench_gas`` discipline (``warmup``, then
    ``run`` with its ``max_iters``, median of 3): ms per iteration,
    GTEPS, push and pull iterations and switches, the device busy share
    and the median phase split per direction.

Then the sharded pull engine (``ShardedPullExecutor``) over 4 parts of
a ``LocalMesh`` on the card: PageRank on the graph in the full and
compact exchange modes, and CF on the ratings graph (whose compact plan
is unprofitable, so compact resolves to full, logged):

3e. shard layouts and executors: part sizes, capacities, resolved modes
    and exchange bytes per iteration;
4e. K8 and K9 on the last part's slice of its table (its destinations
    at ``row_base``; compact's receiver table for PageRank) against their
    plain versions (bitwise on small integers, within the tolerances on
    floats), two calls bitwise equal, each with its time and bound;
5e. end to end: PageRank ``run(10)`` in both modes against phase 5's
    f64 oracle, compact equal to full bitwise, CF ``run(5)`` against
    phase 5c's f64 oracle, K8 and K9 launched once per part and
    iteration; whether each equals the single-device ``PullExecutor``
    bitwise;
6e. timing: median of 3 runs after ``warmup``, ms per iteration, GTEPS,
    the ``phase_step`` split (exchange, comp, update), the device busy
    share, the exchange alone against its bytes bound, the phases' peak
    device memory; then ``dryrun_multichip(4)`` on the card, which also
    runs the sharded push steps.

Then the multi-source and sharded push engines (``MultiSourcePushExecutor``,
``ShardedPushExecutor``, ``ShardedMultiSourcePushExecutor``), over the
same 4 parts: SSSP from vertex 0 on the graph in the full (packed K5
input, ``blocked_dense``) and compact modes, CC on the closure in the
default (full) mode, and 8-lane multi-source SSSP (root 0 and seven
roots drawn with numpy seed 0 among the vertices with out-edges) on one
device and over the parts in both modes:

3f. host set-up: both shard layouts and push CSRs, the executors, their
    modes, ``blocked_dense``, tiers and exchange bytes per iteration in
    both modes;
4f. the kernels at the sharded path's shapes against their plain
    versions, bitwise: K5 for one part's ``row_ptr`` over the packed
    ``(P * max_nv,)`` table (full) and over its receiver's compact table
    of values and frontier, two calls bitwise equal, beside its time
    before its redesign; K6 on one part's frontier; K7 in one launch
    over the four parts, reading the flat pre-step stack and combining
    into each part's row of a copy through its ``push_dst_local``, two
    calls bitwise equal, beside the plain version's four scatters and
    one ``scatter_reduce`` over the flat table; and K10 with 8 columns
    over the ``(P * max_nv, 8)`` table for one part's ``row_ptr``; with
    the same timings;
5f. end to end, bitwise: sharded SSSP (both modes) and CC against phase
    5b's oracles with zero violations and phase 5b's iteration counts,
    compact equal to full; every multi-source lane against its
    single-source ``PushExecutor`` run; the sharded multi-source runs
    against the single-device one; K5 once per part and dense
    iteration, K6 and K7 once per part with a queue or queued edges, K10
    once (single device) or once per part per iteration;
6f. timing as in phase 6b: ``warmup``, then the median of 3 runs to
    fixpoint on the host clock, ``init_state`` alone, the run from a
    state on the card, the device busy share, the phase split per
    branch, the exchange alone against its bytes bound; the single-device
    numbers of phase 6b beside them; and the phases' peak device memory.

Then the sharded GAS engines (``ShardedAdaptiveExecutor``,
``ShardedMultiSourceGasExecutor``) over the same 4 parts, on phase 3f's
layouts of the graph and the closure and a layout of the weighted twin:
adaptive BFS from vertex 0 in the full, compact and frontier exchange
modes, DeltaSSSP from 0 on the weighted twin (full, frontier), label
propagation on the graph and k-core (k = 4) on the closure (frontier,
where the dense start downgrades to the compact send), 8-lane BFS
(compact; root 0 and seven roots drawn with numpy seed 0) and PageRank
through ``PullGasAdapter``:

3h. the weighted twin's layout, the executors, their resolved modes,
    budgets, ``frontier_cap``, ``frontier_evidence`` and exchange bytes
    per iteration;
4h. K11 in one launch over the 4 receiving parts, bitwise against its
    plain version (two calls equal) on BFS's first frontier and at the
    per-part queue cap on BFS's and DeltaSSSP's states after 2
    iterations, with its time, the plain version's, one
    ``scatter_reduce`` over the flat accumulator and its bound;
5h. end to end: every run to its fixpoint bitwise equal to phase 5d's
    single-device result with equal iterations (BFS parents too,
    DeltaSSSP with zero violations), label propagation and k-core with
    at least one downgrade, the direction ledgers logged, K10, K6 and
    K11 launch counts checked against them; every lane of the 8-lane
    run equal to a single-root run; PageRank ``run(10)`` against phase
    5's f64 oracle with K8 once per part and iteration;
6h. timing by ``bench_gas``'s discipline (``warmup``, then the median of
    3 host-clock runs): ms to fixpoint and GTEPS, the run from a state
    on the card, the ``phase_step`` split per branch (CUDA events), the
    compact and frontier exchanges alone against their bytes bound, and
    the 8-lane run with its K-lane compact exchange alone.

Then the sharded executors over a ``torch.distributed`` mesh
(``parallel/multihost.py``, ``parallel/mesh.py::DistMesh``), each held
bitwise against its ``LocalMesh`` run with equal iterations and
ledgers:

3k. one NCCL rank in this process (``initialize(backend="nccl",
    world_size=1, rank=0)``, then ``make_global_mesh(4)``): tiled
    PageRank on phase 3's plan right after 3g, then on the layouts of
    phases 3e-3h pull PageRank (full, compact), SSSP (full, compact),
    CC, BFS in frontier mode and the 8-lane SSSP and BFS, each against
    its run of 5e-5h with its launches checked, timed (median of 3
    after ``warmup``) beside the LocalMesh time;
4k-6k. two ranks of this script on the one card over gloo (``--mesh-rank``,
    started with ``torchrun``'s environment, so a bare ``initialize()``
    picks gloo), P = 4, two parts a rank: each rank reads phase 3i's
    ``g.lux`` and plan, builds its parts' layout (host seconds logged),
    and runs pull PageRank (compact), tiled PageRank, SSSP (its sparse
    branch crosses ranks) and BFS in frontier mode, its launches checked
    against its ledgers; both ranks bitwise equal to 3k's values,
    iterations and ledgers, their times beside 3k's and the LocalMesh's,
    and the bytes staged through pinned host buffers beside
    ``exchange_bytes_per_iter``. A rank that fails or outlasts its time
    fails the script.

Then dynamic graphs and incremental recompute (``graph/delta.py``,
``graph/wal.py``, ``graph/snapshot.py``, ``engine/incremental.py``) on
the graph and its closure, with ``lux_tpu``'s "~1% edit batch"
(``tools/snapshot_smoke.py:114-125``: ``ne // 100`` edits, half inserts
uniform over nv, half deletes of existing edges, ``default_rng(17)``;
symmetrised on the closure):

3j. a ``SnapshotStore`` with its WAL under ``build/lux_tpu_torch/wal``
    mints version 1 from the batch; ``SnapshotStore.recover`` must give
    version 1 with its fingerprint, ``row_ptr`` and ``col_src``; a second
    batch (seed 18) stacks version 2 on version 0's anchor, below
    ``LUX_DELTA_COMPACT_RATIO``, and recover must give version 2 the same
    way; version 1's graph (merged once) and the closure's edited twin,
    with their CSRs, serve every run below;
5j. on the card, each against a from-scratch run on the new graph and
    its oracle, bitwise: warm SSSP from vertex 0 (old values: phase 5b's
    fixpoint) with zero violations, warm CC on the edited closure, the
    8-lane warm SSSP from phase 5f's lanes (K10 with 8 columns; lane 0
    against the SSSP oracle), and incremental PageRank (K8) from a flat
    ``run(20)`` on the old graph, its warm vector bitwise the old true
    ranks over the new out-degrees and its true ranks within rtol=1e-3,
    atol=1e-3/nv of a from-scratch ``run(20)``; launch counts checked
    against each run's branch log or iterations; the three
    ``IncrementalExecutor`` builds go through the LUX604 proof gate,
    which proves SSSP and CC once each;
6j. the seconds of each host step (edits, WAL append with fsync, merge,
    ``removed_edges``, recover, CSR, invalidation, state upload), the
    ``info`` dicts, the iterations, and the ms of the warm and the
    from-scratch runs (median of 3 after ``warmup``, host clock), the
    warm runs split into invalidation, upload and the rest.

Last, the app CLIs (``python -m lux_tpu_torch.models.<app>``), each a
subprocess on the card:

3i. while the graphs and phase 3's plan are at hand, each graph written
    as a ``.lux`` file under ``build/lux_tpu_torch/cli/`` and the plan
    saved at the tiled CLI's cache key, so the CLI loads it; ``g.lux``
    read natively and with numpy, and ``g``'s CSR built natively and
    with numpy, each pair bitwise equal, their seconds logged (the CLIs'
    reads and every ``Graph.csr()`` go through the native paths);
4i-6i. tiled PageRank (``-check``), flat and over 4 parts, CF, SSSP (one
    device and 4 parts), CC, BFS and DeltaSSSP (``-check``), and SSSP
    saved after 2 iterations and resumed: each run must say it ran on
    the card, and its ``-save`` checkpoint must equal the in-process
    run of its path (phases 5, 5c, 5g within the PageRank and CF
    tolerances; 5b and 5d bitwise with their iteration counts); its
    wall seconds, ``ELAPSED TIME`` and ``GTEPS`` lines are logged beside
    the in-process times of phases 6-6h. They run three at a time (the
    resumed SSSP after its first part), so their start-ups overlap. The
    files are removed at the end.

Telemetry (``lux_tpu_torch/obs``), group 3l-6l, each part right after
the group whose executors it takes, so it builds none of its own:

3l. after phase 6, on its lane-select executor: ``run(10)`` with
    ``LUX_METRICS`` and ``LUX_TRACE`` off and on, bitwise equal with
    equal launches, 2 flush windows in the record and the trace; ms per
    iteration of both by CUDA events; the report's byte-model rate
    against the card's roofline row; a ``profile.v1`` capture of 3
    iterations (K1 and K2 among its top kernels, the device idle share,
    steps per second within 3x of the recorder's);
4l. after phase 6e, on its compact executor: ``run(3)`` under
    ``LUX_ENGOBS=1`` inside a capture, bitwise equal to the plain run,
    with exchange- and compute-tagged device time (its realized hidden
    share is 0 on one stream);
5l. after phase 6d: SSSP (phase 3b's executor) and BFS (3d's) with a
    recorder, values, iterations, branches and frontiers equal to their
    ledgers;
6l. after 4i-6i: BFS's CLI with ``-metrics -trace`` (its record splits
    the timed run into the warm-up's compile seconds and the execute
    seconds of the iterations; ``tools/trace_summary.py`` reads the
    trace) and tiled PageRank's with ``-profile`` (read by ``python -m
    lux_tpu_torch.tools.prof_summary``), each checkpoint bitwise equal
    to 4i-6i's.

Serving (``lux_tpu_torch/serve``), group 3m-6m, after the CLIs and on
their files:

3m. ``python -m lux_tpu_torch.serve.http -file g.lux -port 0`` as a
    subprocess: up and warm (each engine's warmup seconds from its log),
    its tiled PageRank on phase 3's plan from the CLI's cache key;
4m. over HTTP: 64 concurrent SSSP roots, each answer's SHA-256 equal
    to a ``PushExecutor`` run from its root, in batches of more than 4
    lanes (queries per second, p50 and p99 latency); PageRank (ni 10)
    within the tolerance of phase 5's f64 oracle at 65,536 vertices,
    and its digest against phase 5's run; CC, BFS (with parents), label
    propagation and k-core bitwise against in-process runs (BFS and
    label propagation phase 5d's, with their iterations); ``/metrics``
    with zero serve-phase compiles, ``/stats`` with no build after
    warmup, ``/statusz`` (latency windows, audits, peak memory): the
    pool's gasck audit ran on every build with 0 findings, and
    ``programs.source`` is ``artifact``;
5m. an in-process ``Session`` on the weighted twin read back from
    ``gw.lux`` (flat PageRank, K8, against the oracle; DeltaSSSP bitwise
    phase 5d's), then ``apply_edits`` of the 1% batch while 8 client
    threads query SSSP: every answer bitwise its version's (N until the
    flip, N+1 after, by fresh 8-lane executors on each graph); the
    swap's apply, warm, refresh and flip seconds; no build and no
    compile on the serving path; the gasck audit on every build, 0
    findings, ``programs.source`` ``artifact``;
6m. an in-process ``Session`` on ``g.lux`` with ``LUX_SERVE_MESH=4``:
    every engine over 4 parts of a ``LocalMesh``, its answers bitwise
    4m's (sharded tiled PageRank within the oracle's tolerance), mesh
    keys on every pool entry; armed with 3n-4n's store, its BFS engine
    built under 4n's winner (its exchange mode and thresholds).
The in-process sessions' launches join the kernels line's counts.

The auto-tuner (``lux_tpu_torch/tune``), group 3n-6n, between 4m and
5m:

3n. ``tune()`` for BFS, kind ``gas``, with real probes and the tuner's
    defaults on the weighted twin read back natively from ``gw.lux``:
    each probe (rung, candidate, score, phase medians, switches, build
    and run seconds) and the winner logged; candidate 0 the defaults,
    the winner the last rung's argmin, 0 ``tuneck`` findings; each
    probe's launches checked against its direction log;
4n. ``tune()`` for BFS, kind ``gas_sharded``, over 4 parts of a
    ``LocalMesh`` on ``g``, every probe on one shared layout, with
    ``LUX_TUNE_MAX_CANDIDATES`` and ``LUX_TUNE_RUNGS`` logged; then
    ``python -m lux_tpu_torch.tools.luxlint --tune`` over the store: 0
    findings, rc 0;
5n. in 5m's session, armed with the store (``LUX_TUNE_DIR``): the BFS
    engine built under 3n's winner (its thresholds), ``tuned_for`` its
    id, every other app a counted fallback, BFS from 0 bitwise phase
    5d's, no build after warmup; the swap evicts the tuned config and
    version N+1's BFS is a counted fallback;
6n. the tuned and the default BFS executors of both searches to
    fixpoint, bitwise phase 5d's and each other, their launches checked
    against their direction logs, medians of 3 after ``warmup``, beside
    each search's seconds.

Each phase group's seconds are logged. Any failure exits non-zero.
Without a card it exits non-zero and prints no result. The last line is ``{"ok": true, "device": {...}}``; the line
before it lists the kernels as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
F32_FLOPS_PER_S = 67e12    # H100 SXM published f32 rate, outside tensor cores
ITERS = 10
RTOL, ATOL = 5e-5, 1e-9
CF_ITERS = 5
CF_RTOL, CF_ATOL = 1e-4, 1e-7   # tests/test_colfilter.py
SEED = 42


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: int, flops: int):
    """(ms, "bytes" or "operations"): the least time the card needs to
    move ``nbytes`` once and do ``flops`` f32 operations."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` calls, after one warm-up call,
    timed with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_seconds(fn) -> float:
    """Host seconds of ``fn()`` between two device synchronisations."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def device_busy(fn, top: int = 6):
    """(ms of device activity, [(name, ms)] of the ``top`` busiest
    kernels) during one ``fn()`` under ``torch.profiler``, or None when
    the profiler records no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    if not by_name:
        return None
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return sum(by_name.values()), [(n[:60], v) for n, v in ranked]


def check_close(name: str, got, want, rtol=RTOL, atol=ATOL) -> float:
    """Max abs error of ``got`` against ``want``; raises outside
    ``rtol``, ``atol`` (default 5e-5, 1e-9)."""
    g = got.double().cpu().numpy()
    w = want.double().cpu().numpy()
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=name)
    return float(np.max(np.abs(g - w), initial=0.0))


def check_equal(name: str, got, want) -> None:
    import torch

    if not torch.equal(got, want):
        diff = (got.double() - want.double()).abs().max().item()
        raise AssertionError(f"{name}: not bitwise equal (max diff {diff})")


def check_launches(label: str, counts: dict, want: dict) -> None:
    """Raise unless the launch counts of a main-path run are ``want``
    (every kernel not named there at 0)."""
    full = {**dict.fromkeys(counts, 0), **want}
    if counts != full:
        raise AssertionError(f"{label}: launches {counts}, expected {full}")


def keep(held, label, **kw) -> None:
    """Keep what a LocalMesh run gave under ``held["mesh"][label]``, for
    group 3k and 4k-6k to hold the runs over ranks against."""
    held.setdefault("mesh", {}).setdefault(label, {}).update(kw)


def record(kernels, name, source, replaces, err, ms, plain_ms, nbytes, flops,
           lib_ms):
    """Append one kernel's entry of the ``kernels`` JSON line (its
    launches are filled in after the main-path runs) and log it."""
    b_ms, b_by = bound(nbytes, flops)
    kernels.append({
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": 0, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": lib_ms,
    })
    log(f"[kernel] {name}: max_abs_err={err:.3e} ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
        f"library_ms={lib_ms if lib_ms is None else round(lib_ms, 4)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=22,
                    help="R-MAT scale (nv = 2**scale, 16 edges per vertex)")
    ap.add_argument("--mesh-rank", nargs=3,
                    metavar=("WORK", "GRAPH", "PLAN"),
                    help="run as one rank of group 4k-6k (the script "
                    "starts its ranks so, with torchrun's environment)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    if args.mesh_rank:
        return _rank_main(*args.mesh_rank)

    import torch

    # -- 1. environment ---------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.graph.graph import Graph
    from lux_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    log(f"[env] device {kind}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; count {torch.cuda.device_count()}")
    log(f"[env] nvidia-smi: {smi}")

    # -- 2. build -----------------------------------------------------------
    t = time.perf_counter()
    _cuda.library()
    log(f"[build] libluxk.so ready in {time.perf_counter() - t:.1f} s "
        f"({_cuda.BUILD_DIR})")
    from lux_tpu_torch.native import build as native_build

    t = time.perf_counter()
    native_build.load_library()   # a failed g++ build fails the run
    log(f"[build] {native_build.library_path().name} (g++, the native "
        f"reader, converter and CSR build) ready in "
        f"{time.perf_counter() - t:.1f} s")
    nvcc_log = _cuda.BUILD_DIR / "nvcc.log"
    if nvcc_log.exists():
        for line in nvcc_log.read_text().splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                log(f"[build] {line.strip()}")

    # -- 3. graph and plans -------------------------------------------------
    # Group 2p's CLI runs beside the generation. The weighted R-MAT draws
    # its weights from a generator of their own, so dropping them leaves
    # exactly the unweighted graph.
    prog_dir = _cuda.BUILD_DIR / "programs"
    lint = _programs_cli(prog_dir)
    tiers = _lint_clis()
    traces = _trace_clis()
    shutil.rmtree(_cuda.BUILD_DIR / "xplans", ignore_errors=True)
    t = time.perf_counter()
    try:
        gw = generate.rmat(args.scale, 16, seed=SEED, weighted=True)
    except BaseException:
        for proc in [lint] + [p for _, p in list(tiers.values())
                              + list(traces.values())]:
            proc.kill()
            proc.wait()
        raise
    g = Graph(nv=gw.nv, ne=gw.ne, row_ptr=gw.row_ptr, col_src=gw.col_src)
    t_gen = time.perf_counter() - t
    log(f"[graph] rmat({args.scale}, 16, seed={SEED}, weighted=True): "
        f"nv={g.nv} ne={g.ne} in {t_gen:.1f} s; g is it without weights")
    kernels = []
    group_s = {}

    def group(name, fn, *a):
        """``fn(*a)``, its seconds added to the group's."""
        t0 = time.perf_counter()
        out = fn(*a)
        took = time.perf_counter() - t0
        group_s[name] = group_s.get(name, 0.0) + took
        log(f"[time] phase group {name} took {took:.1f} s")
        return out

    group(PROGRAMS_GROUP, _program_phases, prog_dir, lint, dev)
    shutil.rmtree(prog_dir, ignore_errors=True)
    group(LINT_GROUP, _lint_phases, tiers)
    # The CLI group (3i-6i) writes its files while the graphs and phase 3's
    # plan are at hand, and holds each CLI run against the in-process run
    # of its path, which the phase groups leave in ``held``.
    held = {}
    cli_dir = _cuda.BUILD_DIR / "cli"
    cli = "3i-6i CLIs"
    totals, oracle, plan = group("3-6 tiled", _pagerank_phases, g, dev,
                                 kernels, held)
    # Group 3l-6l runs each part right after the group whose executors
    # it takes; its files live in ``tel_dir``.
    tel_dir = _cuda.BUILD_DIR / "telemetry"
    shutil.rmtree(tel_dir, ignore_errors=True)
    tel_dir.mkdir(parents=True)
    _add(totals, group(TELEMETRY_GROUP, _telemetry_tiled, held, tel_dir))
    # Group 2r once phase 5's guard has paid the dispatch mode's set-up.
    _add(totals, group(TRACE_GROUP, _trace_phases, traces, dev))
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    # Phases 3g-6g reuse phase 3's plan (planning costs host minutes at
    # scale), so they run here, before the plan is dropped.
    totals.update(group("3g-6g sharded tiled", _tiled_sharded_phases, g,
                        plan, oracle, dev, kernels, held))
    peak = max(peak, torch.cuda.max_memory_allocated())
    # Group 3k's tiled run holds phase 5g's while the plan is at hand.
    mesh = group(MESH_GROUP, _mesh_init, dev)
    for name, n in group(MESH_GROUP, _mesh_phases, {
            "tiled pagerank full": (g, plan, None)}, mesh, held,
            dev).items():
        totals[name] = totals.get(name, 0) + n
    peak = max(peak, torch.cuda.max_memory_allocated())
    plan_path = group(cli, _cli_files, cli_dir, {"g": g, "gw": gw}, plan)
    del plan
    torch.cuda.empty_cache()
    group(cli, _native_io, cli_dir, g)
    totals.update(group("4g probes", _probe_phases, dev, kernels))
    group(LINT_GROUP, _plan_lint, held.pop("plan_artifact"))
    peak = max(peak, torch.cuda.max_memory_allocated())
    torch.cuda.empty_cache()
    t = time.perf_counter()
    gu = generate.undirected(g)
    log(f"[push] undirected closure: nv={gu.nv} ne={gu.ne} in "
        f"{time.perf_counter() - t:.1f} s")
    group(cli, _cli_files, cli_dir, {"gu": gu})
    push_totals, push_ctx = group("3b-6b push", _push_phases, g, gu, dev,
                                  kernels)
    group(LINT_GROUP, _guard_phases, push_ctx, dev)
    for name, n in push_totals.items():
        totals[name] += n
    torch.cuda.empty_cache()
    pull_totals, gc, cf_oracle = group("3c-6c pull", _pull_phases, g, oracle,
                                       args.scale, dev, kernels, held)
    group(cli, _cli_files, cli_dir, {"gc": gc})
    for name, n in pull_totals.items():
        totals[name] += n
    torch.cuda.empty_cache()
    gas_totals, gas_ctx = group("3d-6d gas", _gas_phases, g, gw, gu,
                                oracle, dev, kernels)
    for name, n in gas_totals.items():
        totals[name] += n
    _add(totals, group(TELEMETRY_GROUP, _telemetry_fixpoints, push_ctx,
                       gas_ctx, tel_dir))
    torch.cuda.empty_cache()
    peak = max(peak, torch.cuda.max_memory_allocated())
    sharded_totals, sg_rmat = group("3e-6e sharded pull", _sharded_phases,
                                    g, oracle, gc, cf_oracle, dev, held)
    for name, n in sharded_totals.items():
        totals[name] += n
    _add(totals, group(TELEMETRY_GROUP, _telemetry_sharded, held, tel_dir))
    peak = max(peak, torch.cuda.max_memory_allocated())
    del gc
    torch.cuda.empty_cache()
    push_sharded_totals, sgs = group("3f-6f sharded push",
                                     _push_sharded_phases, g, gu, push_ctx,
                                     dev, kernels, held, sg_rmat)
    del sg_rmat
    for name, n in push_sharded_totals.items():
        totals[name] = totals.get(name, 0) + n
    peak = max(peak, torch.cuda.max_memory_allocated())
    torch.cuda.empty_cache()
    for name, n in group("3h-6h sharded gas", _gas_sharded_phases, g, gw,
                         gu, sgs, gas_ctx, oracle, dev, kernels,
                         held).items():
        totals[name] = totals.get(name, 0) + n
    group(LINT_GROUP, _exchange_artifacts)
    del gw
    peak = max(peak, torch.cuda.max_memory_allocated())
    torch.cuda.empty_cache()
    # Group 3k on the layouts of phases 3e-3h, then 4k-6k on the files of
    # phase 3i.
    runs = {label: (gu if key == "closure" else g, sgs[key],
                    held["mesh"][label].get("roots"))
            for label, (_, key, _) in MESH_RUNS.items() if key}
    for name, n in group(MESH_GROUP, _mesh_phases, runs, mesh, held,
                         dev).items():
        totals[name] = totals.get(name, 0) + n
    del runs, sgs, mesh
    torch.distributed.destroy_process_group()
    peak = max(peak, torch.cuda.max_memory_allocated())
    torch.cuda.empty_cache()
    group(RANKS_GROUP, _rank_phases, cli_dir / "ranks", cli_dir / "g.lux",
          plan_path, held, smi)
    for name, n in group("3j-6j incremental", _incremental_phases, g, gu,
                         push_ctx, held, dev, _cuda.BUILD_DIR / "wal").items():
        totals[name] = totals.get(name, 0) + n
    peak = max(peak, torch.cuda.max_memory_allocated())
    torch.cuda.empty_cache()
    device_line = f"torch device: cuda ({kind})"
    saved = group(cli, _cli_phases, cli_dir, device_line, held, push_ctx,
                  gas_ctx)
    group(TELEMETRY_GROUP, _telemetry_cli, cli_dir, device_line, saved)
    torch.cuda.empty_cache()
    # Group 3m-6m: 3m-4m over HTTP, then 3n-6n's searches and timings,
    # whose store arms the in-process sessions of 5m (with 5n) and 6m.
    http = group(SERVE_GROUP, _serve_http, cli_dir, device_line, g,
                 push_ctx, gas_ctx, oracle, held, dev, smi)
    tuned = group(TUNE_GROUP, _tune_phases, cli_dir, g, gas_ctx, dev, smi)
    _add(totals, tuned["launches"])
    peak = max(peak, torch.cuda.max_memory_allocated())
    _add(totals, group(SERVE_GROUP, _serve_swap, cli_dir, dev, gas_ctx,
                       oracle, held, smi, tuned))
    _add(totals, group(SERVE_GROUP, _serve_mesh, cli_dir, dev, http, oracle,
                       smi, tuned))
    os.environ.pop("LUX_TUNE_DIR")
    del tuned
    peak = max(peak, torch.cuda.max_memory_allocated())
    shutil.rmtree(cli_dir)
    shutil.rmtree(tel_dir)
    log("[time] phase groups (s): " + ", ".join(
        f"{k}={v:.1f}" for k, v in group_s.items()))

    for entry in kernels:
        entry["launches"] = totals[entry["name"]]
        if entry["launches"] <= 0:
            raise AssertionError(f"{entry['name']} never ran on the main path")
    log(f"[done] scale {args.scale} in {time.perf_counter() - t_start:.1f} s "
        f"on {smi}; peak device memory {peak / 2**30:.2f} GiB")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _pagerank_phases(g, dev, kernels, held):
    """Phases 3-6 on the tiled pull path; returns the launch counts of
    its two runs, summed, the f64 oracle of ``run(10)`` and the plan, and
    leaves the lane-select ``run(10)`` values and its ms per iteration in
    ``held["pagerank"]`` for the CLI group."""
    import torch

    import lux_tpu_torch.engine.tiled as tiled_mod
    from lux_tpu_torch.engine.tiled import TiledPullExecutor
    from lux_tpu_torch.models.pagerank import PageRank, reference_pagerank
    from lux_tpu_torch.ops import _cuda
    from lux_tpu_torch.ops.merge_tail_kernel import (
        level_apply,
        level_apply_ref,
        root_reduce,
    )
    from lux_tpu_torch.ops.segment import segment_sum_by_rowptr_plain
    from lux_tpu_torch.ops.tiled_spmv import (
        build_level,
        plan_hybrid,
        strip_level_spmv,
        strip_level_spmv_plain,
    )

    t = time.perf_counter()
    plan = plan_hybrid(g)
    t_plan = time.perf_counter() - t
    log(f"[plan] strips={plan.num_strips} strip_bytes={plan.strip_bytes} "
        f"coverage={plan.coverage:.4f} tail_edges={plan.tail_sb.shape[0]} "
        f"in {t_plan:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    t = time.perf_counter()
    ex_lane = TiledPullExecutor(g, PageRank(), plan=plan)
    torch.cuda.synchronize()
    log(f"[plan] lane-select executor built in "
        f"{time.perf_counter() - t:.1f} s")
    for hlev in plan.levels:
        t = host_seconds(lambda: build_level(hlev, plan.nvb, dev))
        log(f"[plan] cell build of level r={hlev.r} ({hlev.rows.shape[0]} "
            f"strips, {hlev.nbytes} B on the host): {t:.2f} s")
    t = time.perf_counter()
    # Keep the grouped plan the executor builds (group 2q saves and
    # verifies it): planning it again costs minutes at this scale.
    planner, kept = tiled_mod.plan_grouped_tail, []
    tiled_mod.plan_grouped_tail = lambda *a, **kw: kept.append(
        planner(*a, **kw)) or kept[-1]
    os.environ["LUX_GROUPED_TAIL"] = "1"
    try:
        ex_grp = TiledPullExecutor(g, PageRank(), plan=plan)
    finally:
        del os.environ["LUX_GROUPED_TAIL"]
        tiled_mod.plan_grouped_tail = planner
    torch.cuda.synchronize()
    gt = ex_grp.gtail
    level_rows = [int(c.shape[0]) for c in gt.codes]
    log(f"[plan] grouped plan + executor built in "
        f"{time.perf_counter() - t:.1f} s: merge levels={gt.n_levels} "
        f"stream rows={sum(level_rows)} widest level={max(level_rows)} "
        f"mean inflation={ex_grp.gtail_stats['mean_inflation']:.3f}")

    # -- 4. kernels against their plain versions ----------------------------
    rng = np.random.default_rng(SEED)
    dh = ex_lane.dhybrid
    nvb = dh.nvb
    x_float = torch.from_numpy(
        rng.random((nvb, 128), dtype=np.float32) + np.float32(0.5)).to(dev)
    x_int = torch.from_numpy(
        rng.integers(0, 4, size=(nvb, 128)).astype(np.float32)).to(dev)
    reps = 10

    # K1 strip_spmv on the cell streams, every level of the plan; once on
    # the card, each level's stream against the host plan's strips.
    err = 0.0
    for hlev, lev in zip(plan.levels, dh.levels):
        for x, exact in ((x_int, True), (x_float, False)):
            got = strip_level_spmv(x, lev)
            want = strip_level_spmv_plain(x, lev)
            if exact:
                check_equal(f"K1 r={lev.r} integral", got, want)
            else:
                err = max(err, check_close(f"K1 r={lev.r}", got, want))
        t = time.perf_counter()
        strip_form, nnz = _strip_form_product(hlev, x_int, nvb, dev)
        check_equal(f"K1 r={lev.r} against the host strips",
                    strip_level_spmv(x_int, lev), strip_form)
        if nnz != lev.n_cells:
            raise AssertionError(f"K1 r={lev.r}: {lev.n_cells} cells, the "
                                 f"strips hold {nnz} nonzero cells")
        log(f"[kernel] strip_spmv r={lev.r}: {lev.n_cells} cells in "
            f"{lev.nrows} rows ({lev.items.n_items} items); equal bitwise on "
            f"integral x to the strip-form product of the host strips "
            f"({time.perf_counter() - t:.1f} s)")
        del strip_form
    k1 = _k1_yardsticks(plan.levels, dh.levels, x_float, nvb, reps, "")
    record(kernels, "strip_spmv", "lux_tpu_torch/csrc/strip_spmv.cu",
           "lux_tpu/ops/tiled_spmv.py:945", err, *k1)

    # K2 tail_gather_sum, as the main path runs it: straight from the
    # (nv,) values, adding into the strips' sums.
    k2 = _k2_check("K2", dh.tail_src, dh.tail_row_ptr, g.nv, rng, reps, dev)
    record(kernels, "tail_gather_sum", "lux_tpu_torch/csrc/segment_sum.cu",
           "lux_tpu/ops/tiled_spmv.py:1027", *k2)

    # K3 level_apply, every level; each level's input is the plain chain's.
    x = x_float
    k3_ms = k3_plain = 0.0
    k3_bytes = 0
    for k in range(gt.n_levels + 1):
        a, b, c = gt.arow[k], gt.brow[k], gt.codes[k]
        if c.shape[0] == 0:
            continue
        want = level_apply_ref(x, a, b, c)
        check_equal(f"K3 level {k}", level_apply(x, a, b, c), want)
        k3_ms += cuda_ms(lambda: level_apply(x, a, b, c), reps)
        k3_plain += cuda_ms(lambda: level_apply_ref(x, a, b, c), reps)
        k3_bytes += 4 * x.numel() + 8 * a.numel() + c.numel() \
            + 4 * want.numel()
        x = want
    record(kernels, "level_apply", "lux_tpu_torch/csrc/level_apply.cu",
           "lux_tpu/ops/merge_tail_kernel.py:112", 0.0, k3_ms, k3_plain,
           k3_bytes, 0, None)

    # K4 segment_sum_rowptr on the root stream, with its lane mask.
    s_root = gt.nvalid_root.shape[0]
    root_f = torch.from_numpy(
        rng.random((s_root, 128), dtype=np.float32) + np.float32(0.5)).to(dev)
    root_i = torch.from_numpy(
        rng.integers(0, 4, size=(s_root, 128)).astype(np.float32)).to(dev)
    rr = (gt.nvalid_root, gt.dst_row_ptr)
    check_equal("K4 integral", root_reduce(root_i, *rr),
                segment_sum_by_rowptr_plain(root_i, gt.dst_row_ptr,
                                            gt.nvalid_root))
    # As the main path calls it: adding into the strips' sums.
    y_i = torch.from_numpy(
        rng.integers(0, 4, size=g.nv).astype(np.float32)).to(dev)
    y_f = torch.from_numpy(
        rng.random(g.nv, dtype=np.float32) + np.float32(0.5)).to(dev)
    check_equal("K4 integral, adding into a vector",
                root_reduce(root_i, *rr, y_i.clone()),
                segment_sum_by_rowptr_plain(root_i, gt.dst_row_ptr,
                                            gt.nvalid_root, y_i.clone()))
    err = check_close("K4", root_reduce(root_f, *rr, y_f.clone()),
                      segment_sum_by_rowptr_plain(root_f, gt.dst_row_ptr,
                                                  gt.nvalid_root,
                                                  y_f.clone()))
    k4_ms = cuda_ms(lambda: root_reduce(root_f, *rr, y_f), reps)
    k4_plain = cuda_ms(lambda: segment_sum_by_rowptr_plain(
        root_f, gt.dst_row_ptr, gt.nvalid_root, y_f), reps)
    # What the function needs: the live elements of the rows' stream
    # (lane < nvalid), nvalid, the row pointer, y read and written; an add
    # a live element and a row.
    lane = torch.arange(128, device=dev)
    lo, hi = (int(v) for v in gt.dst_row_ptr[[0, -1]].tolist())
    k4_live = int((lane[None, :] < gt.nvalid_root[:, None])
                  .reshape(-1)[lo:hi].sum())
    k4_bytes = 4 * k4_live + 4 * s_root \
        + 8 * gt.dst_row_ptr.numel() + 8 * g.nv
    k4_ops = k4_live + g.nv
    log(f"[kernel] K4 (one launch, adding into a vector): {k4_ms:.4f} ms, "
        f"was {K4_WAS_MS} ms (two passes over work items, then an add "
        f"pass); live elements {k4_live} of {root_f.numel()} "
        f"({k4_live / root_f.numel():.3f}); bound "
        f"{bound(k4_bytes, k4_ops)[0]:.4f} ms")

    def k4_library():
        live = lane[None, :] < gt.nvalid_root[:, None]
        return torch.segment_reduce(
            torch.where(live, root_f, 0.0).reshape(-1), "sum",
            offsets=gt.dst_row_ptr)

    k4_lib = cuda_ms(k4_library, reps)
    record(kernels, "segment_sum_rowptr", "lux_tpu_torch/csrc/segment_sum.cu",
           "lux_tpu/ops/merge_tail_kernel.py:146", err, k4_ms, k4_plain,
           k4_bytes, k4_ops, k4_lib)
    # Group 2q: the plan the grouped executor runs, saved, reloaded and
    # its tail held against the executor's; its lint runs meanwhile.
    held["plan_artifact"] = _plan_artifact(kept.pop(), gt, x_float, dev)
    del x_float, x_int, root_f, root_i, x, y_i, y_f
    torch.cuda.empty_cache()

    # -- 5. end to end, both configurations ---------------------------------
    t = time.perf_counter()
    oracle = reference_pagerank(g, ITERS)
    log(f"[e2e] f64 oracle ({ITERS} iterations) in "
        f"{time.perf_counter() - t:.1f} s")
    # Wrappers skip empty launches: count the levels and tails with work.
    nlev = sum(1 for lev in dh.levels if lev.items.n_items > 0)
    k2_per_iter = 1
    k3_per_iter = sum(1 for c in gt.codes if c.shape[0] > 0)
    none = dict.fromkeys(_cuda.LAUNCHES, 0)
    expected = {
        "lane-select": {**none, "strip_spmv": nlev * ITERS,
                        "tail_gather_sum": k2_per_iter * ITERS},
        "grouped": {**none, "strip_spmv": nlev * ITERS,
                    "level_apply": k3_per_iter * ITERS,
                    "segment_sum_rowptr": ITERS},
    }
    totals = dict.fromkeys(_cuda.LAUNCHES, 0)
    for label, ex in (("lane-select", ex_lane), ("grouped", ex_grp)):
        _cuda.reset_launches()
        out = ex.run(ITERS)
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        out = out.cpu().numpy()
        if out.shape != (g.nv,) or not np.all(np.isfinite(out)):
            raise AssertionError(f"{label}: bad output {out.shape}")
        np.testing.assert_allclose(out, oracle, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{label} vs f64 oracle")
        err = float(np.max(np.abs(out.astype(np.float64) - oracle)))
        log(f"[e2e] {label}: run({ITERS}) matches the f64 oracle "
            f"(max abs err {err:.3e}); launches {counts}")
        if counts != expected[label]:
            raise AssertionError(
                f"{label}: launches {counts}, expected {expected[label]}")
        for name, n in counts.items():
            totals[name] += n

        # -- 6. timing ------------------------------------------------------
        ex.warmup()
        vals = ex.init_values()
        ms = cuda_ms(lambda: ex.run(ITERS, vals=vals), 3) / ITERS
        if label == "lane-select":
            held["pagerank"] = {"values": out, "ms": ms}
        runs = [ex.phase_step(vals)[1] for _ in range(5)]
        phases = {k: float(np.median([r[k] for r in runs])) for k in runs[0]}
        log(f"[time] {label}: {ms:.3f} ms/iteration, "
            f"{g.ne / (ms * 1e-3) / 1e9:.3f} GTEPS")
        log(f"[time] {label} phases (ms, median of 5): " + ", ".join(
            f"{k}={v * 1e3:.3f}" for k, v in phases.items()))

    log(f"[time] peak device memory of phases 3-6 "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phases 3-6 "
        f"took {time.perf_counter() - t_phase:.1f} s after planning")
    # Group 2q: phase 5's executor, stepped under HostTransferGuard.
    _guard_tiled(ex_lane, held["pagerank"]["values"], nlev)
    # Group 2r: both executors' steps traced at this scale.
    for label, ex in (("lane-select", ex_lane), ("grouped", ex_grp)):
        want = {k: v // ITERS for k, v in expected[label].items() if v}
        _add(totals, _trace_scale(f"pagerank@tiled {label} (phase 5)", ex,
                                  {}, want))
    # Phase 3l takes the lane-select executor and its run's launches.
    held.setdefault("telemetry", {})["tiled"] = (ex_lane,
                                                 expected["lane-select"])
    return totals, oracle, plan


def _push_phases(g, gu, dev, kernels):
    """Phases 3b-6b on the push engine (SSSP on ``g``, CC on its closure
    ``gu``); returns the launch counts of its two runs to fixpoint,
    summed, and for phases 3f-6f per application its oracle, iterations,
    sparse iterations and median ms to fixpoint, with the SSSP
    executor."""
    import torch

    from lux_tpu_torch.engine.check import count_violations
    from lux_tpu_torch.engine.push import PushExecutor
    from lux_tpu_torch.models import SSSP, ConnectedComponents
    from lux_tpu_torch.models.components import reference_components
    from lux_tpu_torch.models.sssp import reference_sssp
    from lux_tpu_torch.ops import _cuda
    from lux_tpu_torch.ops import frontier as fq
    from lux_tpu_torch.ops import segment as seg

    # -- 3b. push executors -------------------------------------------------
    apps = {}
    for app, graph, prog, kw in (("sssp", g, SSSP(), {"start": 0}),
                                 ("cc", gu, ConnectedComponents(), {})):
        t = time.perf_counter()
        ex = PushExecutor(graph, prog)
        torch.cuda.synchronize()
        log(f"[push] {app} executor (host CSR, row tasks, device copy) "
            f"built in {time.perf_counter() - t:.1f} s: nv={graph.nv} "
            f"ne={graph.ne} blocked_dense={ex.blocked_dense} "
            f"sparse={ex.sparse} tiers={ex.tiers}")
        apps[app] = (ex, kw)
    ex_s, ex_c = apps["sssp"][0], apps["cc"][0]
    reps = 10

    # -- 4b. kernels against their plain versions ---------------------------
    # K5 on SSSP's state after 2 iterations and CC's first iteration, in
    # both input forms, two calls bitwise equal; the JSON row sums the
    # form the main path runs.
    st_s2, _ = ex_s.run(max_iters=2, start=0)
    k5 = dict.fromkeys(("ms", "plain", "bytes", "ops", "sectors"), 0.0)
    for label, ex, st in (("sssp after 2 iterations", ex_s, st_s2),
                          ("cc iteration 1", ex_c, ex_c.init_state())):
        prog = ex.program
        relax = seg.RELAX_OPS[prog.relax_op]
        packed = seg.pack_words(st.values, st.frontier)
        forms = {"packed": (packed, None),
                 "unpacked": (st.values, st.frontier)}
        want = seg.segment_minmax_relax_plain(
            ex.row_ptr, ex.col_src, packed, None, prog.combiner, relax)
        times = {}
        for form, (table, front) in forms.items():
            check_equal(f"K5 plain {form} {label}",
                        seg.segment_minmax_relax_plain(
                            ex.row_ptr, ex.col_src, table, front,
                            prog.combiner, relax), want)

            def k5_call(table=table, front=front):
                return seg.segment_minmax_relax(
                    ex.row_ptr, ex.col_src, table, front, prog.combiner,
                    prog.relax_op, ex.tasks)

            got = k5_call()
            check_equal(f"K5 {form} {label}", got, want)
            check_equal(f"K5 {form} {label} twice", k5_call(), got)
            times[form] = cuda_ms(k5_call, reps)
        main_form = "packed" if ex.blocked_dense else "unpacked"
        table, front = forms[main_form]
        plain_ms = cuda_ms(lambda: seg.segment_minmax_relax_plain(
            ex.row_ptr, ex.col_src, table, front, prog.combiner, relax), 2)
        nv, ne = ex.graph.nv, ex.graph.ne
        nbytes = 4 * ne + 8 * (nv + 1) + 4 * nv \
            + (4 if main_form == "packed" else 5) * nv
        active = int(st.frontier.sum())
        log(f"[push] K5 {label} ({active} of {nv} vertices active): bitwise "
            f"in both forms, two calls equal; packed {times['packed']:.4f} "
            f"ms, bits {times['unpacked']:.4f} ms, plain ({main_form}) "
            f"{plain_ms:.4f} ms, bytes bound {bound(nbytes, ne)[0]:.4f} ms")
        k5["ms"] += times[main_form]
        k5["plain"] += plain_ms
        k5["bytes"] += nbytes
        k5["ops"] += ne
        k5["sectors"] += 32 * ne
    # No one PyTorch call gathers, masks, relaxes and reduces per segment;
    # torch.segment_reduce has no integer kernels.
    record(kernels, "segment_minmax_relax", "lux_tpu_torch/csrc/gas.cu",
           "lux_tpu/engine/push.py:150", 0.0, k5["ms"], k5["plain"],
           k5["bytes"], k5["ops"], None)
    log_gathers("K5 (two calls)", k5["ms"], K5_WAS_MS,
                bound(k5["bytes"], k5["ops"])[0], k5["sectors"],
                "one 32-byte sector an edge", tag="push")
    del st_s2, packed, table, front, want, got
    torch.cuda.empty_cache()

    # K6 and K7 on the sparse-tier frontier of SSSP's run with the most
    # out-edges, and on a synthetic frontier of exactly Q vertices.
    ex_s.run(start=0)
    sparse_at = [(out, i) for i, (b, _, out) in enumerate(ex_s.branch_log)
                 if b > 0]
    if not sparse_at:
        raise AssertionError("SSSP's run took no sparse iteration")
    _, at = max(sparse_at)
    st_run, _ = ex_s.run(max_iters=at, start=0)
    rng = np.random.default_rng(SEED)
    q_cap = ex_s.queue_cap
    pick = rng.choice(g.nv, size=q_cap, replace=False)
    synth = torch.zeros(g.nv, dtype=torch.bool)
    synth[torch.from_numpy(pick)] = True
    st_synth = type(st_run)(st_run.values, synth.to(dev))
    k67 = {}
    for label, st in ((f"sssp iteration {at + 1}", st_run),
                      (f"synthetic Q={q_cap}", st_synth)):
        prog = ex_s.program
        relax = seg.RELAX_OPS[prog.relax_op]
        fr = st.frontier
        cnt = int(fr.sum())
        out = int(torch.where(fr, ex_s.out_degrees, 0).sum())
        rp, col_dst = ex_s.csr_row_ptr, ex_s.csr_col_dst
        want_q = fq.frontier_queue_plain(fr, rp)
        got_q = fq.frontier_queue(fr, rp, cnt)
        for part, got, want in zip(("q", "start", "deg", "offs"), got_q,
                                   want_q):
            check_equal(f"K6 {part} {label}", got, want)
        q, start, _, offs = got_q
        want = fq.queue_relax_scatter_plain(q, start, offs, col_dst,
                                            st.values, prog.combiner, relax)
        check_equal(f"K7 {label}", fq.queue_relax_scatter(
            q, start, offs, col_dst, st.values, prog.combiner, prog.relax_op,
            out), want)
        k6_ms = cuda_ms(lambda: fq.frontier_queue(fr, rp, cnt), reps)
        k6_plain = cuda_ms(lambda: fq.frontier_queue_plain(fr, rp), reps)
        k6_lib = cuda_ms(lambda: torch.nonzero(fr), reps)
        k7_ms = cuda_ms(lambda: fq.queue_relax_scatter(
            q, start, offs, col_dst, st.values, prog.combiner,
            prog.relax_op, out), reps)
        k7_plain = cuda_ms(lambda: fq.queue_relax_scatter_plain(
            q, start, offs, col_dst, st.values, prog.combiner, relax), reps)
        # Yardstick: the scatter alone, one scatter_reduce over int64
        # candidates and destinations built beforehand.
        slot = torch.repeat_interleave(torch.arange(cnt, device=dev),
                                       offs.diff())
        edge = start[slot] + torch.arange(out, device=dev) - offs[:-1][slot]
        dst_e = col_dst[edge].long()
        vals64 = seg.widen_u32(st.values)
        cand = relax(vals64[q.long()[slot]])
        k7_lib = cuda_ms(lambda: vals64.scatter_reduce(
            0, dst_e, cand, reduce="amin", include_self=True), reps)
        del slot, edge, dst_e, cand
        k6_bytes = g.nv + 16 * cnt + 28 * cnt + 8
        k7_bytes = 8 * g.nv + 4 * out + 20 * cnt + 8
        log(f"[push] K6/K7 {label}: cnt={cnt} out_edges={out}; bitwise; "
            f"K6 {k6_ms:.4f} ms (plain {k6_plain:.4f}, torch.nonzero "
            f"{k6_lib:.4f}, bound {bound(k6_bytes, 0)[0]:.4f}); K7 "
            f"{k7_ms:.4f} ms (plain {k7_plain:.4f}, scatter_reduce "
            f"{k7_lib:.4f}, bound {bound(k7_bytes, out)[0]:.4f})")
        if not k67:
            k67 = dict(k6=(k6_ms, k6_plain, k6_bytes, cnt, k6_lib),
                       k7=(k7_ms, k7_plain, k7_bytes, out, k7_lib))
    # K6 also on a dense frontier: half the vertices, drawn with the seed.
    fr = torch.from_numpy(rng.random(g.nv) < 0.5).to(dev)
    cnt = int(fr.sum())
    for part, got, want in zip(("q", "start", "deg", "offs"),
                               fq.frontier_queue(fr, rp, cnt),
                               fq.frontier_queue_plain(fr, rp)):
        check_equal(f"K6 {part} dense", got, want)
    k6_ms = cuda_ms(lambda: fq.frontier_queue(fr, rp, cnt), reps)
    k6_plain = cuda_ms(lambda: fq.frontier_queue_plain(fr, rp), reps)
    k6_lib = cuda_ms(lambda: torch.nonzero(fr), reps)
    log(f"[push] K6 dense frontier (half the vertices, cnt={cnt}): bitwise; "
        f"{k6_ms:.4f} ms (plain {k6_plain:.4f}, torch.nonzero "
        f"{k6_lib:.4f}, bound {bound(g.nv + 44 * cnt + 8, 0)[0]:.4f})")
    del fr
    _k6_k7_rows(ex_s, st_synth, q_cap, rng, dev)
    record(kernels, "frontier_queue", "lux_tpu_torch/csrc/frontier.cu",
           "lux_tpu/engine/push.py:447", 0.0, *k67["k6"])
    record(kernels, "queue_relax_scatter", "lux_tpu_torch/csrc/frontier.cu",
           "lux_tpu/engine/push.py:460", 0.0, *k67["k7"])
    log(f"[push] K7 on SSSP's first frontier (copy and fold, one launch): "
        f"{k67['k7'][0]:.4f} ms, was {K7_WAS_MS} ms (a clone, then the "
        f"fold)")
    del st_run, st_synth, synth, want, got_q, want_q, q, start, offs, vals64
    torch.cuda.empty_cache()

    # -- 5b. end to end -------------------------------------------------------
    t = time.perf_counter()
    oracles = {"sssp": reference_sssp(g, 0)}
    log(f"[push] sssp oracle (numpy BFS) in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    oracles["cc"] = reference_components(gu)
    log(f"[push] cc oracle (scipy) in {time.perf_counter() - t:.1f} s")
    push_kernels = ("segment_minmax_relax", "frontier_queue",
                    "queue_relax_scatter")
    totals = dict.fromkeys(_cuda.LAUNCHES, 0)
    ctx = {"sssp_ex": ex_s}
    for app, (ex, kw) in apps.items():
        _cuda.reset_launches()
        st, iters = ex.run(**kw)
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        vals = ex.values(st)
        if vals.shape != (ex.graph.nv,) or vals.dtype != np.uint32:
            raise AssertionError(f"{app}: bad output {vals.shape} {vals.dtype}")
        if not np.array_equal(vals, oracles[app]):
            raise AssertionError(
                f"{app}: {int(np.sum(vals != oracles[app]))} values differ "
                "from the oracle")
        viol = count_violations(ex.graph, st.values, ex.program)
        if viol:
            raise AssertionError(f"{app}: {viol} invariant violations")
        branches = ex.branch_log
        dense = sum(1 for b, _, _ in branches if b == 0)
        if dense + ex.sparse_iters != iters:
            raise AssertionError(f"{app}: {dense} dense + {ex.sparse_iters} "
                                 f"sparse != {iters} iterations")
        want = dict.fromkeys(_cuda.LAUNCHES, 0)
        want["segment_minmax_relax"] = dense
        want["frontier_queue"] = sum(1 for b, c, _ in branches if b > 0 and c > 0)
        want["queue_relax_scatter"] = sum(
            1 for b, c, e in branches if b > 0 and c > 0 and e > 0)
        if counts != want:
            raise AssertionError(f"{app}: launches {counts}, expected {want}")
        ctx[app] = {"oracle": oracles[app], "iters": iters,
                    "sparse_iters": ex.sparse_iters}
        log(f"[push] {app}: fixpoint in {iters} iterations "
            f"({ex.sparse_iters} sparse) matches the oracle bitwise, 0 "
            f"violations; branches {[(b, c, e) for b, c, e in branches]}; "
            f"launches { {k: counts[k] for k in push_kernels} }")
        for name, n in counts.items():
            totals[name] += n
    for name in push_kernels:
        if totals[name] <= 0:
            raise AssertionError(f"{name} never ran on the push path")

    # -- 6b. timing -----------------------------------------------------------
    probe = torch.zeros(2, dtype=torch.int64, device=dev)
    reads = []
    for _ in range(100):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probe.tolist()
        reads.append(time.perf_counter() - t0)
    read_ms = float(np.median(reads)) * 1e3
    log(f"[time] host read of the two frontier counters (16 bytes, idle "
        f"stream): median {read_ms:.4f} ms over 100")
    for app, (ex, kw) in apps.items():
        ex.warmup(**kw)
        secs = [host_seconds(lambda: ex.run(**kw)) for _ in range(3)]
        sec = float(np.median(secs))
        iters = len(ex.branch_log)
        ctx[app]["ms"] = sec * 1e3
        log(f"[time] push {app}: {iters} iterations ({ex.sparse_iters} "
            f"sparse) in {sec * 1e3:.3f} ms (median of 3: "
            f"{[round(x * 1e3, 3) for x in secs]}), "
            f"{sec / iters * 1e3:.3f} ms/iteration, "
            f"{ex.graph.ne * iters / sec / 1e9:.3f} GTEPS; host reads "
            f"{iters + 1} x {read_ms:.4f} ms")
        # The same run split: building the initial state (host arrays
        # copied to the card), and iterating from a state on the card.
        init = float(np.median([host_seconds(lambda: ex.init_state(**kw))
                                for _ in range(3)]))
        st0 = ex.init_state(**kw)
        iter_sec = float(np.median([host_seconds(lambda: ex.run(state=st0))
                                    for _ in range(3)]))
        log(f"[time] push {app}: init_state {init * 1e3:.3f} ms; run from "
            f"a device state {iter_sec * 1e3:.3f} ms, "
            f"{iter_sec / iters * 1e3:.3f} ms/iteration "
            f"(medians of 3)")
        busy = device_busy(lambda: ex.run(state=st0))
        if busy is None:
            log(f"[time] push {app}: device busy share not measured "
                "(the profiler saw no kernels)")
        else:
            busy_ms, top = busy
            log(f"[time] push {app}: device busy {busy_ms:.3f} ms of the "
                f"{iter_sec * 1e3:.3f} ms run from a device state "
                f"({busy_ms / (iter_sec * 1e3):.1%}; torch.profiler); top "
                "kernels (ms): " + ", ".join(f"{n}={v:.3f}" for n, v in top))
        st = ex.init_state(**kw)
        ex.warmup_phases(st)
        split = {}
        while True:
            st, cnt, times = ex.phase_step(st)
            branch = "dense" if times.pop("branch") == "dense" else "sparse"
            split.setdefault(branch, []).append(times)
            if cnt == 0:
                break
        for branch, runs in split.items():
            med = {k: float(np.median([r[k] for r in runs])) * 1e3
                   for k in runs[0]}
            log(f"[time] push {app} {branch} phases (ms, median of "
                f"{len(runs)}): " + ", ".join(
                    f"{k}={v:.3f}" for k, v in med.items()))
    return totals, ctx


def _k6_k7_rows(ex, st_cap, q_cap: int, rng, dev) -> None:
    """Phase 4b's rows beside the main path's: K6 at nv = 2^28 on a
    synthetic row pointer made on the card (the last vertex alone, then a
    seeded sparse frontier), bitwise against its plain version and timed
    beside ``torch.nonzero``; K6 and K7 at the push sparse branch's cap
    (``st_cap``, ``q_cap`` = nv // 16 + 128 vertices) and K7 on SSSP's
    first frontier, medians of 100 calls, K7 beside one ``scatter_reduce``
    over the same candidates."""
    import torch

    from lux_tpu_torch.ops import frontier as fq
    from lux_tpu_torch.ops import segment as seg
    from lux_tpu_torch.probes.gather import median_ms

    t = time.perf_counter()
    nv = 1 << 28
    rp = torch.arange(nv + 1, dtype=torch.int64, device=dev) * 3
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    one = torch.zeros(nv, dtype=torch.bool, device=dev)
    one[-1] = True
    sparse = torch.rand(nv, generator=gen, device=dev) < 1e-4
    for label, fr in (("the last vertex", one), ("sparse", sparse)):
        cnt = int(fr.sum())
        for part, got, want in zip(("q", "start", "deg", "offs"),
                                   fq.frontier_queue(fr, rp, cnt),
                                   fq.frontier_queue_plain(fr, rp)):
            check_equal(f"K6 nv=2^28 {label} {part}", got, want)
        ms = cuda_ms(lambda: fq.frontier_queue(fr, rp, cnt), 10)
        lib = cuda_ms(lambda: torch.nonzero(fr), 10)
        log(f"[push] K6 at nv=2^28, {label} (cnt={cnt}): bitwise; "
            f"{ms:.4f} ms, torch.nonzero {lib:.4f} ms, bytes bound "
            f"{bound(nv + 44 * cnt + 8, 0)[0]:.4f} ms")
    del rp, one, sparse
    torch.cuda.empty_cache()
    prog = ex.program
    relax = seg.RELAX_OPS[prog.relax_op]
    rp, col_dst = ex.csr_row_ptr, ex.csr_col_dst
    for label, st in (("SSSP's first frontier", ex.init_state(start=0)),
                      (f"the cap, {q_cap} vertices", st_cap)):
        fr = st.frontier
        cnt = int(fr.sum())
        q, start, _, offs = fq.frontier_queue(fr, rp, cnt)
        out = int(offs[-1])
        k6 = median_ms(lambda: fq.frontier_queue(fr, rp, cnt), dev)
        k6_lib = median_ms(lambda: torch.nonzero(fr), dev)
        k7 = median_ms(lambda: fq.queue_relax_scatter(
            q, start, offs, col_dst, st.values, prog.combiner,
            prog.relax_op, out), dev)
        slot = torch.repeat_interleave(torch.arange(cnt, device=dev),
                                       offs.diff())
        edge = start[slot] + torch.arange(out, device=dev) - offs[:-1][slot]
        dst_e = col_dst[edge].long()
        vals64 = seg.widen_u32(st.values)
        cand = relax(vals64[q.long()[slot]])
        k7_lib = median_ms(lambda: vals64.scatter_reduce(
            0, dst_e, cand, reduce="amin", include_self=True), dev)
        was = K7_MEDIAN_WAS_MS["first" if cnt == 1 else "cap"]
        log(f"[push] at {label} (cnt={cnt}, out_edges={out}), medians of "
            f"100 calls: K6 {k6:.4f} ms, torch.nonzero {k6_lib:.4f} ms; K7 "
            f"{k7:.4f} ms (was {was}), one scatter_reduce {k7_lib:.4f} ms")
        del slot, edge, dst_e, vals64, cand
    log(f"[push] phase 4b's extra rows took {time.perf_counter() - t:.1f} s")


def _pull_phases(g, pr_oracle, scale, dev, kernels, held):
    """Phases 3c-6c on the flat pull engine: flat PageRank on ``g`` and
    CF on ``bench.py``'s ratings graph of this scale; returns the launch
    counts of their two runs, summed, the ratings graph and CF's f64
    oracle of ``run(5)``, and leaves each run's values and ms per
    iteration in ``held["flat"]`` and ``held["cf"]``."""
    import torch

    from lux_tpu_torch.engine.pull import DEFAULT_EDGE_CHUNK, PullExecutor
    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.models import CollaborativeFiltering, PageRank
    from lux_tpu_torch.models.colfilter import K, reference_colfilter, rmse
    from lux_tpu_torch.ops import _cuda
    from lux_tpu_torch.ops import segment as seg
    from lux_tpu_torch.utils import flags

    # -- 3c. pull executors ---------------------------------------------------
    t = time.perf_counter()
    ex_pr = PullExecutor(g, PageRank())
    torch.cuda.synchronize()
    log(f"[pull] flat PageRank executor built in "
        f"{time.perf_counter() - t:.1f} s: edge_chunk={ex_pr.edge_chunk} "
        f"row tasks={ex_pr.tasks.n_tasks} ({ex_pr.tasks.n_hub} hub rows)")
    # bench.py's run_cf sizes: NetFlix-shaped at scale 22.
    n_users = min(480_000, 1 << max(scale - 3, 1))
    n_items = max(n_users // 27, 64)
    n_ratings = 12 << scale
    t = time.perf_counter()
    gc = generate.bipartite_ratings(n_users, n_items, n_ratings, seed=11)
    in_deg = gc.in_degrees
    log(f"[pull] bipartite_ratings({n_users}, {n_items}, {n_ratings}, "
        f"seed=11): nv={gc.nv} ne={gc.ne} max in-degree={int(in_deg.max())} "
        f"mean user in-degree={in_deg[:n_users].mean():.1f} in "
        f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    ex_cf = PullExecutor(gc, CollaborativeFiltering())
    torch.cuda.synchronize()
    auto = gc.ne * K * 4 > flags.get_int("LUX_EDGE_CHUNK_BYTES")
    want_chunk = DEFAULT_EDGE_CHUNK if auto else 0
    log(f"[pull] CF executor built in {time.perf_counter() - t:.1f} s: "
        f"edge_chunk={ex_cf.edge_chunk} (expected {want_chunk}) "
        f"row tasks={ex_cf.tasks.n_tasks} ({ex_cf.tasks.n_hub} hub rows)")
    if ex_pr.edge_chunk != 0 or ex_cf.edge_chunk != want_chunk:
        raise AssertionError("the pull executors chose another edge_chunk")

    # -- 4c. kernels against their plain versions -----------------------------
    rng = np.random.default_rng(SEED)
    reps = 10
    nv, ne = g.nv, g.ne
    rp, cs, tasks = ex_pr.row_ptr, ex_pr.col_src, ex_pr.tasks
    x_f = torch.from_numpy(
        rng.random(nv, dtype=np.float32) + np.float32(0.5)).to(dev)
    x_i = torch.from_numpy(
        rng.integers(0, 4, size=nv).astype(np.float32)).to(dev)
    check_equal("K8 integral", seg.gather_segment_sum(x_i, rp, cs, tasks),
                seg.gather_segment_sum_plain(x_i, rp, cs))
    got = seg.gather_segment_sum(x_f, rp, cs, tasks)
    err = check_close("K8", got, seg.gather_segment_sum_plain(x_f, rp, cs))
    check_equal("K8 twice", seg.gather_segment_sum(x_f, rp, cs, tasks), got)
    k8_ms = cuda_ms(lambda: seg.gather_segment_sum(x_f, rp, cs, tasks), reps)
    k8_plain = cuda_ms(lambda: seg.gather_segment_sum_plain(x_f, rp, cs), 2)
    # The function's bytes: col_src, row_ptr and vals read once, the output
    # written once (the row tasks are the kernel's plan, not its input).
    k8_bytes = 4 * ne + 8 * (nv + 1) + 4 * nv + 4 * nv
    csr = torch.sparse_csr_tensor(rp, cs.long(), torch.ones(ne, device=dev),
                                  size=(nv, nv))
    xv = x_f.reshape(-1, 1)
    diff = (csr @ xv).reshape(-1) - got
    log(f"[pull] K8 sparse yardstick max diff {diff.abs().max().item():.3e}")
    k8_lib = cuda_ms(lambda: csr @ xv, reps)
    del csr, xv, diff, got
    record(kernels, "gather_segment_sum", "lux_tpu_torch/csrc/pull_sum.cu",
           "lux_tpu/engine/pull.py:465", err, k8_ms, k8_plain, k8_bytes, ne,
           k8_lib)
    log_gathers("K8", k8_ms, K8_WAS_MS, bound(k8_bytes, ne)[0],
                32 * ne, "one 32-byte sector an edge")

    nvc, nec = gc.nv, gc.ne
    rpc, csc, wc, itc = (ex_cf.row_ptr, ex_cf.col_src, ex_cf.weights,
                         ex_cf.tasks)
    win = ex_cf.edge_chunk
    v_f = torch.from_numpy(rng.random((nvc, K), dtype=np.float32)
                           * np.float32(0.2) + np.float32(0.12)).to(dev)
    v_i = torch.from_numpy(
        rng.integers(0, 2, size=(nvc, K)).astype(np.float32)).to(dev)
    check_equal("K9 integral", seg.cf_edge_sum(v_i, rpc, csc, wc, itc),
                seg.cf_edge_sum_plain(v_i, rpc, csc, wc, window=win))
    got = seg.cf_edge_sum(v_f, rpc, csc, wc, itc)
    err = check_close("K9", got,
                      seg.cf_edge_sum_plain(v_f, rpc, csc, wc, window=win),
                      rtol=CF_RTOL, atol=CF_ATOL)
    check_equal("K9 twice", seg.cf_edge_sum(v_f, rpc, csc, wc, itc), got)
    del got
    k9_ms = cuda_ms(lambda: seg.cf_edge_sum(v_f, rpc, csc, wc, itc), reps)
    k9_plain = cuda_ms(lambda: seg.cf_edge_sum_plain(v_f, rpc, csc, wc,
                                                     window=win), 2)
    # col_src and weights, row_ptr, the (nv, K) table and the output.
    k9_bytes = 8 * nec + 8 * (nvc + 1) + 2 * 4 * K * nvc
    # Per edge: a K-term dot (2K), the error (1), K scaled adds (2K).
    k9_flops = (4 * K + 1) * nec
    # No one PyTorch call gathers two rows per edge, dots them and sums
    # the scaled rows per destination.
    record(kernels, "cf_edge_sum", "lux_tpu_torch/csrc/pull_sum.cu",
           "lux_tpu/engine/pull.py:489", err, k9_ms, k9_plain, k9_bytes,
           k9_flops, None)
    # A K-float row at a multiple of 4K bytes: 80 bytes at 0 or 16 past a
    # sector boundary span three 32-byte sectors.
    k9_sectors = (4 * K + 16 + 31) // 32
    log_gathers("K9", k9_ms, K9_WAS_MS, bound(k9_bytes, k9_flops)[0],
                32 * k9_sectors * nec,
                f"the {k9_sectors} sectors of a {4 * K}-byte row, an edge")
    del x_f, x_i, v_f, v_i
    torch.cuda.empty_cache()

    # -- 5c. end to end -------------------------------------------------------
    totals = dict.fromkeys(_cuda.LAUNCHES, 0)
    _cuda.reset_launches()
    out = ex_pr.run(ITERS)
    torch.cuda.synchronize()
    counts = dict(_cuda.LAUNCHES)
    out = out.cpu().numpy()
    if out.shape != (nv,) or not np.all(np.isfinite(out)):
        raise AssertionError(f"flat pagerank: bad output {out.shape}")
    np.testing.assert_allclose(out, pr_oracle, rtol=RTOL, atol=ATOL,
                               err_msg="flat pagerank vs f64 oracle")
    err = float(np.max(np.abs(out.astype(np.float64) - pr_oracle)))
    check_launches("flat pagerank", counts, {"gather_segment_sum": ITERS})
    held["flat"] = {"values": out}
    log(f"[pull] flat pagerank: run({ITERS}) matches the f64 oracle (max abs "
        f"err {err:.3e}); launches {counts['gather_segment_sum']}")
    for name, n in counts.items():
        totals[name] += n

    t = time.perf_counter()
    cf_oracle = reference_colfilter(gc, CF_ITERS, device=dev)
    log(f"[pull] CF f64 oracle ({CF_ITERS} iterations, on the card) in "
        f"{time.perf_counter() - t:.1f} s")
    v0 = ex_cf.init_values()
    rmse0 = rmse(gc, v0.cpu().numpy(), device=dev)
    _cuda.reset_launches()
    out = ex_cf.run(CF_ITERS)
    torch.cuda.synchronize()
    counts = dict(_cuda.LAUNCHES)
    out = out.cpu().numpy()
    if out.shape != (nvc, K) or not np.all(np.isfinite(out)):
        raise AssertionError(f"cf: bad output {out.shape}")
    np.testing.assert_allclose(out, cf_oracle, rtol=CF_RTOL, atol=CF_ATOL,
                               err_msg="cf vs f64 oracle")
    err = float(np.max(np.abs(out.astype(np.float64) - cf_oracle)))
    check_launches("cf", counts, {"cf_edge_sum": CF_ITERS})
    held["cf"] = {"values": out}
    log(f"[pull] cf: run({CF_ITERS}) matches the f64 oracle (max abs err "
        f"{err:.3e}); RMSE {rmse0:.6f} before, "
        f"{rmse(gc, out, device=dev):.6f} after; launches "
        f"{counts['cf_edge_sum']}")
    for name, n in counts.items():
        totals[name] += n

    # -- 6c. timing -----------------------------------------------------------
    for label, key, ex, graph, iters in (
            ("flat pagerank", "flat", ex_pr, g, ITERS),
            ("cf", "cf", ex_cf, gc, CF_ITERS)):
        ex.warmup()
        vals = ex.init_values()
        secs = [host_seconds(lambda: ex.run(iters, vals=vals))
                for _ in range(3)]
        sec = float(np.median(secs))
        ev_ms = cuda_ms(lambda: ex.run(iters, vals=vals), 3) / iters
        held[key]["ms"] = ev_ms
        log(f"[time] pull {label}: {sec / iters * 1e3:.3f} ms/iteration, "
            f"{graph.ne * iters / sec / 1e9:.3f} GTEPS (host clock, median "
            f"of 3 runs of {iters}: {[round(x * 1e3, 3) for x in secs]} ms); "
            f"{ev_ms:.3f} ms/iteration by CUDA events (mean of 3)")
        busy = device_busy(lambda: ex.run(iters, vals=vals))
        if busy is None:
            log(f"[time] pull {label}: device busy share not measured (the "
                "profiler saw no kernels)")
        else:
            busy_ms, top = busy
            log(f"[time] pull {label}: device busy {busy_ms:.3f} ms of "
                f"{sec * 1e3:.3f} ms ({busy_ms / (sec * 1e3):.1%}; "
                "torch.profiler); top kernels (ms): "
                + ", ".join(f"{n}={v:.3f}" for n, v in top))
    return totals, gc, cf_oracle


# K8's and K9's times at scale 22 before their redesign (the two-pass
# kernels of commit 18867e9, this script's run on an NVIDIA H100 80GB HBM3
# at 700 W, means of 10 calls), logged beside the new ones.
K8_WAS_MS, K9_WAS_MS = 0.585, 2.904
# The same for K5 (its two calls of phase 4b; one part, full and compact,
# of phase 4f) and P6 (merge4) before their redesign: the kernels of
# commit a047839, this script's run on the same card.
K5_WAS_MS = 1.618
K5_PART_WAS_MS = {"full": 0.141, "compact": 0.189}
MERGE4_WAS_MS = 0.084
# The same for K4, K7 and K11 (the two-pass K4 and the one-pass queue
# expansion of commit 77017f1, this script's run on the same card): K4 on
# the root stream, K7 on SSSP's first frontier, a part's split-table K7
# (one launch of the four, and a host read, per sparse iteration), K11's
# four first-push calls; and K7 at the cap and on the first frontier,
# medians of 100.
K4_WAS_MS, K7_WAS_MS, K7_SPLIT_WAS_MS, K11_WAS_MS = 0.249, 0.045, 0.032, 0.168
K7_MEDIAN_WAS_MS = {"first": 0.061, "cap": 0.139}


def log_gathers(name, ms, was_ms, bound_ms, sector_bytes, what,
                tag="pull") -> None:
    """Log a kernel's time beside its earlier time and bound, and the L2
    sector bytes of its random gathers as an achieved rate."""
    log(f"[{tag}] {name}: {ms:.4f} ms (was {was_ms:.3f} before the "
        f"redesign; bound {bound_ms:.4f} ms, {ms / bound_ms:.1f}x); its "
        f"gathers read {sector_bytes / 1e9:.2f} GB of L2 sectors ({what}), "
        f"{sector_bytes / ms / 1e9:.2f} TB/s")


GAS_KERNELS = ("gas_pull_acc", "frontier_queue", "gas_push_acc")


def _gas_expected(log) -> dict:
    """Launches of one GAS run from its direction log: K10 per pull
    iteration; K6 per push iteration with a frontier, K11 per push
    iteration whose frontier has out-edges (the wrappers skip empty
    launches)."""
    return {
        "gas_pull_acc": sum(1 for d, _, _ in log if d == 0),
        "frontier_queue": sum(1 for d, c, _ in log if d == 1 and c > 0),
        "gas_push_acc": sum(1 for d, c, e in log if d == 1 and c > 0 and e > 0),
    }


def _gas_phases(g, gw, gu, pr_oracle, dev, kernels):
    """Phases 3d-6d on the GAS engine: BFS and label propagation on
    ``g``, DeltaSSSP on its weighted twin ``gw``, k-core (k = 4) on the
    closure ``gu``; returns the launch counts of the phase 5d runs,
    summed, and a context for the sharded GAS phases: each program's
    oracle (which the phase 5d runs equal bitwise) and its adaptive
    iteration count."""
    import torch

    from lux_tpu_torch.engine.check import count_violations
    from lux_tpu_torch.engine.gas import (
        AdaptiveExecutor,
        MultiSourceGasExecutor,
        as_gas,
    )
    from lux_tpu_torch.models import (
        BFS,
        DeltaSSSP,
        KCore,
        LabelPropagation,
        PageRank,
    )
    from lux_tpu_torch.models.bfs import reference_bfs
    from lux_tpu_torch.models.kcore import reference_kcore
    from lux_tpu_torch.models.labelprop import reference_labelprop
    from lux_tpu_torch.models.sssp_delta import reference_sssp_delta
    from lux_tpu_torch.ops import _cuda
    from lux_tpu_torch.ops import frontier as fq
    from lux_tpu_torch.ops import segment as seg

    # -- 3d. GAS executors ----------------------------------------------------
    # name -> (graph, program maker, run kw, bench.py's max_iters)
    apps = {
        "bfs": (g, BFS, {"start": 0}, 32),
        "sssp_delta": (gw, DeltaSSSP, {"start": 0}, 32),
        "labelprop": (g, LabelPropagation, {}, 16),
        "kcore": (gu, lambda: KCore(k=4), {}, 32),
    }
    exs = {}
    for app, (graph, make, kw, _) in apps.items():
        t = time.perf_counter()
        ex = AdaptiveExecutor(graph, make())
        torch.cuda.synchronize()
        log(f"[gas] {app} executor (mode {ex.mode}) built in "
            f"{time.perf_counter() - t:.1f} s: nv={graph.nv} ne={graph.ne} "
            f"hi/lo counts {ex.hi_count}/{ex.lo_count} queue_cap="
            f"{ex.queue_cap} edge_budget={ex.edge_budget}")
        exs[app] = ex
    k_lanes = 8
    rng = np.random.default_rng(SEED)
    has_out = np.flatnonzero(g.out_degrees > 0)
    roots = [0] + sorted(int(r) for r in rng.choice(has_out, k_lanes - 1,
                                                    replace=False))
    t = time.perf_counter()
    mx = MultiSourceGasExecutor(g, BFS(), k=k_lanes)
    torch.cuda.synchronize()
    log(f"[gas] multi-source BFS executor (k={k_lanes}, roots {roots}) "
        f"built in {time.perf_counter() - t:.1f} s")

    # -- 4d. kernels against their plain versions -----------------------------
    reps = 10
    k10 = dict.fromkeys(("ms", "plain", "bytes", "ops", "lib"), 0.0)
    k11 = dict.fromkeys(("ms", "plain", "bytes", "ops", "lib"), 0.0)
    for app, ex in exs.items():
        graph, _, kw, _ = apps[app]
        prog = ex.program
        ex.run(**kw)
        dlog = ex.direction_log
        pulls = [(c, i) for i, (d, c, _) in enumerate(dlog) if d == 0]
        pushes = [(e, i) for i, (d, c, e) in enumerate(dlog)
                  if d == 1 and e > 0]
        log(f"[gas] {app}: adaptive log (direction, count, out-edges) "
            f"{dlog}")
        nv, ne = graph.nv, graph.ne
        weighted = prog.gather_op in seg.F32_GATHER_OPS
        # K10 on the pull iteration with the largest frontier.
        at = max(pulls)[1] if pulls else 0
        st, _ = ex.run(max_iters=at, **kw)
        args = (ex.row_ptr, ex.col_src, st.values, st.frontier,
                prog.combiner)

        def k10_call(args=args, prog=prog, ex=ex):
            return seg.gas_pull_acc(*args, prog.gather_op, ex.tasks,
                                    weights=ex.weights)

        def k10_plain(args=args, prog=prog, ex=ex):
            return seg.gas_pull_acc_plain(*args, prog.gather,
                                          weights=ex.weights)

        want = k10_plain()
        check_equal(f"K10 {app} iteration {at + 1}", k10_call(), want)
        ms = cuda_ms(k10_call, reps)
        plain_ms = cuda_ms(k10_plain, 2)
        # Yardstick: the reduce alone, one call over messages masked
        # beforehand (torch.segment_reduce has float kernels only, so the
        # uint32 programs take an int64 scatter_reduce).
        vals, dom = seg.gas_widen(st.values)
        src = ex.col_src.long()
        msg = torch.where(st.frontier[src],
                          prog.gather(vals[src], ex.weights),
                          seg.identity_for(prog.combiner, dom))
        if weighted:
            lib_ms = cuda_ms(lambda: torch.segment_reduce(
                msg, prog.combiner, offsets=ex.row_ptr, unsafe=True), reps)
        else:
            dst = torch.repeat_interleave(torch.arange(nv, device=dev),
                                          ex.row_ptr.diff())
            acc0 = torch.full((nv,), seg.identity_for(prog.combiner, dom),
                              dtype=torch.int64, device=dev)
            red = {"min": "amin", "max": "amax", "sum": "sum"}[prog.combiner]
            lib_ms = cuda_ms(lambda: acc0.scatter_reduce(
                0, dst, msg, reduce=red, include_self=True), reps)
            del dst, acc0
        del msg, vals, src, want
        nbytes = 4 * ne + 8 * (nv + 1) + 5 * nv + 4 * nv \
            + (4 * ne if weighted else 0)
        log(f"[gas] K10 {app} ({prog.combiner}, {prog.gather_op}) on "
            f"iteration {at + 1} (frontier {dlog[at][1]}): bitwise; "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, reduce yardstick "
            f"{lib_ms:.4f} ms, bytes bound {bound(nbytes, ne)[0]:.4f} ms")
        for key, v in (("ms", ms), ("plain", plain_ms), ("bytes", nbytes),
                       ("ops", ne), ("lib", lib_ms)):
            k10[key] += v
        # K11 on the push iteration with the most out-edges, and on the
        # pull state above (a large queue); the row times the former.
        cands = [(f"iteration {max(pushes)[1] + 1}",
                  ex.run(max_iters=max(pushes)[1], **kw)[0])] if pushes \
            else []
        cands.append((f"pull-state iteration {at + 1}", st))
        for i, (label, pst) in enumerate(cands):
            fr = pst.frontier
            cnt = int(fr.sum())
            out = int(torch.where(fr, ex.out_degrees, 0).sum())
            q, start, _, offs = fq.frontier_queue(fr, ex.csr_row_ptr, cnt)
            pargs = (q, start, offs, ex.csr_col_dst, pst.values,
                     prog.combiner)

            def k11_call(pargs=pargs, out=out, prog=prog, ex=ex):
                return fq.gas_push_acc(*pargs, prog.gather_op, out,
                                       weights=ex.csr_weights)

            def k11_plain(pargs=pargs, prog=prog, ex=ex):
                return fq.gas_push_acc_plain(*pargs, prog.gather,
                                             weights=ex.csr_weights)

            check_equal(f"K11 {app} {label}", k11_call(), k11_plain())
            check_equal(f"K10 = K11 {app} {label}", k11_call(),
                        seg.gas_pull_acc(ex.row_ptr, ex.col_src, pst.values,
                                         fr, prog.combiner, prog.gather_op,
                                         ex.tasks, weights=ex.weights))
            ms = cuda_ms(k11_call, reps)
            plain_ms = cuda_ms(k11_plain, 2)
            slot, edge = fq.queue_edges(q, start, offs)
            vals, dom = seg.gas_widen(pst.values)
            msg = prog.gather(vals[q.long()[slot]],
                              None if not weighted else ex.csr_weights[edge])
            dst = ex.csr_col_dst[edge].long()
            acc0 = torch.full((nv,), seg.identity_for(prog.combiner, dom),
                              dtype=msg.dtype, device=dev)
            red = {"min": "amin", "max": "amax", "sum": "sum"}[prog.combiner]
            lib_ms = cuda_ms(lambda: acc0.scatter_reduce(
                0, dst, msg, reduce=red, include_self=True), reps)
            del slot, edge, vals, msg, dst, acc0
            nbytes = 24 * cnt + 8 + 4 * out * (2 if weighted else 1) \
                + 4 * nv
            log(f"[gas] K11 {app} {label}: cnt={cnt} out_edges={out}; "
                f"bitwise, equal to K10; {ms:.4f} ms, plain {plain_ms:.4f} "
                f"ms, scatter_reduce {lib_ms:.4f} ms, bytes bound "
                f"{bound(nbytes, out)[0]:.4f} ms")
            if i == 0 and pushes:
                for key, v in (("ms", ms), ("plain", plain_ms),
                               ("bytes", nbytes), ("ops", out),
                               ("lib", lib_ms)):
                    k11[key] += v
        del st, cands, args
        torch.cuda.empty_cache()
    # K10 with 8 columns, on the multi-source state with the largest
    # frontier.
    st = mx.init_state(roots)
    best = (int(st.frontier.sum()), 0, st)
    for i in range(1, 32):
        st, cnt = mx.step(st)
        if cnt > best[0]:
            best = (cnt, i, st)
        if cnt == 0:
            break
    cnt, at, st = best
    margs = (mx.row_ptr, mx.col_src, st.values, st.frontier, "min")
    check_equal(f"K10 k={k_lanes} after {at} iterations",
                seg.gas_pull_acc(*margs, "add1", mx.tasks),
                seg.gas_pull_acc_plain(*margs, BFS().gather))
    ms = cuda_ms(lambda: seg.gas_pull_acc(*margs, "add1", mx.tasks), reps)
    plain_ms = cuda_ms(lambda: seg.gas_pull_acc_plain(*margs, BFS().gather),
                       2)
    mbytes = 4 * g.ne + 8 * (g.nv + 1) + 9 * g.nv * k_lanes
    log(f"[gas] K10 k={k_lanes} (multi-source BFS, {cnt} active lane "
        f"entries after {at} iterations): bitwise; {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bytes bound {bound(mbytes, g.ne * k_lanes)[0]:.4f}"
        " ms")
    del st, margs, best
    record(kernels, "gas_pull_acc", "lux_tpu_torch/csrc/gas.cu",
           "lux_tpu/engine/gas.py:349", 0.0, k10["ms"], k10["plain"],
           k10["bytes"], k10["ops"], k10["lib"])
    record(kernels, "gas_push_acc", "lux_tpu_torch/csrc/gas.cu",
           "lux_tpu/engine/gas.py:363", 0.0, k11["ms"], k11["plain"],
           k11["bytes"], k11["ops"], k11["lib"])
    log(f"[gas] K11's four first-push calls (fill, fold and decode in one "
        f"launch each): {k11['ms']:.4f} ms, was {K11_WAS_MS} ms")
    torch.cuda.empty_cache()

    # -- 5d. end to end -------------------------------------------------------
    totals = dict.fromkeys(_cuda.LAUNCHES, 0)

    def counted(fn):
        _cuda.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        for name, n in counts.items():
            totals[name] += n
        return out, counts

    oracles, gas_ctx = {}, {}
    t = time.perf_counter()
    oracles["bfs"] = reference_bfs(g, 0)
    log(f"[gas] bfs oracle (numpy BFS, parents) in "
        f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    oracles["sssp_delta"] = reference_sssp_delta(gw, 0)
    log(f"[gas] sssp_delta oracle (scipy Dijkstra) in "
        f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    oracles["labelprop"] = reference_labelprop(g)
    log(f"[gas] labelprop oracle (numpy) in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    oracles["kcore"] = reference_kcore(gu, 4)
    log(f"[gas] kcore oracle (numpy peeling) in "
        f"{time.perf_counter() - t:.1f} s")
    for app, (graph, make, kw, _) in apps.items():
        want = oracles[app][0] if app == "bfs" else oracles[app]
        results = {}
        for mode in ("adaptive", "pull", "push"):
            ex = exs[app] if mode == "adaptive" else AdaptiveExecutor(
                graph, make(), mode=mode)
            (st, iters), counts = counted(lambda: ex.run(**kw))
            vals = ex.values(st)
            if vals.shape != (graph.nv,) or vals.dtype != want.dtype:
                raise AssertionError(f"{app} {mode}: bad output "
                                     f"{vals.shape} {vals.dtype}")
            if not np.array_equal(vals, want):
                raise AssertionError(
                    f"{app} {mode}: {int(np.sum(vals != want))} values "
                    "differ from the oracle")
            fin = ex.finalize(st)
            if app == "bfs" and not np.array_equal(fin["parent"],
                                                   oracles["bfs"][1]):
                raise AssertionError(f"bfs {mode}: parents differ")
            if app == "sssp_delta":
                viol = count_violations(graph, st.values, ex.program)
                if viol:
                    raise AssertionError(f"sssp_delta {mode}: {viol} "
                                         "invariant violations")
            ofin = ex.program.finalize_host(graph, want)
            for key, v in ofin.items():
                if not np.array_equal(np.asarray(fin[key]), np.asarray(v)):
                    raise AssertionError(f"{app} {mode}: {key} differs")
            check_launches(f"{app} {mode}", counts,
                           _gas_expected(ex.direction_log))
            results[mode] = (vals, iters, ex.push_iters, ex.pull_iters,
                             ex.direction_switches)
            if mode == "adaptive":
                gas_ctx[app] = {"oracle": want, "iters": iters,
                                "push_iters": ex.push_iters,
                                "pull_iters": ex.pull_iters}
            extra = {k: v for k, v in ofin.items()
                     if not isinstance(v, np.ndarray)}
            log(f"[gas] {app} {mode}: fixpoint in {iters} iterations "
                f"({ex.push_iters} push, {ex.pull_iters} pull, "
                f"{ex.direction_switches} switches) matches the oracle "
                f"bitwise {extra}; launches "
                f"{ {k: counts[k] for k in GAS_KERNELS} }")
            if mode != "adaptive":
                del ex
                torch.cuda.empty_cache()
        for mode in ("pull", "push"):
            if not np.array_equal(results[mode][0], results["adaptive"][0]):
                raise AssertionError(f"{app}: {mode} differs from adaptive")
    # Multi-source lanes against single-source runs.
    (st, iters), counts = counted(lambda: mx.run(roots))
    check_launches("multi-source bfs", counts, {"gas_pull_acc": iters})
    ex = exs["bfs"]
    for j, r in enumerate(roots):
        single, _ = ex.run(start=r)
        if not np.array_equal(mx.values_for(st, j), ex.values(single)):
            raise AssertionError(f"multi-source lane {j} (root {r}) differs")
    log(f"[gas] multi-source bfs: {k_lanes} lanes in {iters} iterations "
        f"equal the single-source runs; launches {counts['gas_pull_acc']}")
    del st, single
    # PageRank through the pull adapter.
    ex_pr = AdaptiveExecutor(g, as_gas(PageRank()))
    (st, iters), counts = counted(lambda: ex_pr.run(max_iters=ITERS))
    out = ex_pr.values(st)
    if out.shape != (g.nv,) or not np.all(np.isfinite(out)):
        raise AssertionError(f"gas pagerank: bad output {out.shape}")
    np.testing.assert_allclose(out, pr_oracle, rtol=RTOL, atol=ATOL,
                               err_msg="gas pagerank vs f64 oracle")
    check_launches("gas pagerank", counts, {"gather_segment_sum": ITERS})
    log(f"[gas] pagerank through PullGasAdapter: run({ITERS}) (mode "
        f"{ex_pr.mode}) matches the f64 oracle (max abs err "
        f"{float(np.max(np.abs(out.astype(np.float64) - pr_oracle))):.3e})")
    del ex_pr, st, out
    for name in GAS_KERNELS:
        if totals[name] <= 0:
            raise AssertionError(f"{name} never ran on the GAS path")
    torch.cuda.empty_cache()

    # -- 6d. timing -----------------------------------------------------------
    for app, (graph, _, kw, max_iters) in apps.items():
        ex = exs[app]
        ex.warmup(**kw)
        secs = [host_seconds(lambda: ex.run(max_iters=max_iters, **kw))
                for _ in range(3)]
        sec = float(np.median(secs))
        iters = len(ex.direction_log)
        log(f"[time] gas {app}: {iters} iterations ({ex.push_iters} push/"
            f"{ex.pull_iters} pull, {ex.direction_switches} switches; "
            f"max_iters {max_iters}) in {sec * 1e3:.3f} ms (median of 3: "
            f"{[round(x * 1e3, 3) for x in secs]}), "
            f"{sec / iters * 1e3:.3f} ms/iteration, "
            f"{graph.ne * iters / sec / 1e9:.3f} GTEPS")
        st0 = ex.init_state(**kw)
        iter_sec = float(np.median([host_seconds(
            lambda: ex.run(max_iters=max_iters, state=st0))
            for _ in range(3)]))
        busy = device_busy(lambda: ex.run(max_iters=max_iters, state=st0))
        if busy is None:
            log(f"[time] gas {app}: run from a device state "
                f"{iter_sec * 1e3:.3f} ms; device busy share not measured "
                "(the profiler saw no kernels)")
        else:
            busy_ms, top = busy
            log(f"[time] gas {app}: run from a device state "
                f"{iter_sec * 1e3:.3f} ms; device busy {busy_ms:.3f} ms "
                f"({busy_ms / (iter_sec * 1e3):.1%}; torch.profiler); top "
                "kernels (ms): " + ", ".join(f"{n}={v:.3f}" for n, v in top))
        st = ex.init_state(**kw)
        split = {}
        for _ in range(max_iters):
            st, cnt, times = ex.phase_step(st)
            split.setdefault(times.pop("direction"), []).append(times)
            if cnt == 0:
                break
        for direction, runs in sorted(split.items()):
            med = {k: float(np.median([r[k] for r in runs])) * 1e3
                   for k in runs[0]}
            log(f"[time] gas {app} {direction} phases (ms, median of "
                f"{len(runs)}): " + ", ".join(
                    f"{k}={v:.3f}" for k, v in med.items()))
        gas_ctx[app]["ms"] = sec * 1e3
        del st, st0
    gas_ctx["bfs"]["parent"] = oracles["bfs"][1]
    gas_ctx["bfs"]["ex"] = exs["bfs"]     # phase 5l takes it
    return totals, gas_ctx


SHARDED_PARTS = 4


def _sharded_phases(g, pr_oracle, gc, cf_oracle, dev, held):
    """Phases 3e-6e on the sharded pull engine: PageRank on ``g`` in the
    full and compact exchange modes and CF on the ratings graph ``gc``,
    each over ``SHARDED_PARTS`` parts of a ``LocalMesh`` on the card;
    returns the launch counts of the phase 5e runs, summed, and the
    layout of ``g`` (phases 3f-3k reuse it). Keeps PageRank's values and
    ms per iteration for group 3k."""
    import torch

    from lux_tpu_torch.engine.pull import PullExecutor
    from lux_tpu_torch.engine.pull_sharded import ShardedPullExecutor
    from lux_tpu_torch.entry import dryrun_multichip
    from lux_tpu_torch.models import CollaborativeFiltering, PageRank
    from lux_tpu_torch.models.colfilter import K
    from lux_tpu_torch.ops import _cuda
    from lux_tpu_torch.ops import segment as seg
    from lux_tpu_torch.parallel.mesh import make_mesh
    from lux_tpu_torch.parallel.shard import ShardedGraph, resolve_exchange
    from lux_tpu_torch.utils.logging import get_logger

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    P = SHARDED_PARTS
    mesh = make_mesh(P, dev)
    flag = os.environ.get("LUX_EXCHANGE")

    # -- 3e. shard layouts and executors ----------------------------------------
    sgs = {}
    for name, graph, width in (("rmat", g, 1), ("ratings", gc, K)):
        t = time.perf_counter()
        sg = ShardedGraph.build(graph, P)
        plan = sg.exchange_plan()
        built = time.perf_counter() - t
        os.environ["LUX_EXCHANGE"] = "compact"
        mode, _ = resolve_exchange(sg, get_logger("engine"))
        full = P * (P - 1) * sg.max_nv * 4 * width
        log(f"[sharded] {name}: nv={graph.nv} ne={graph.ne} P={P} "
            f"max_nv={sg.max_nv} max_ne={sg.max_ne} part nv="
            f"{sg.local_nv.tolist()} part ne="
            f"{sg.local_row_ptr[:, -1].tolist()}; capacity {plan.capacity} "
            f"(profitable {plan.profitable}), compact resolves to {mode}; "
            f"exchange bytes per iteration at {4 * width} B rows: full "
            f"{full}, compact {plan.exchange_bytes_per_iter(4 * width)}; "
            f"built in {built:.1f} s")
        sgs[name] = sg
    exs = {}
    for label, graph, prog, sg, mode in (
            ("pagerank full", g, PageRank(), sgs["rmat"], "full"),
            ("pagerank compact", g, PageRank(), sgs["rmat"], "compact"),
            ("cf", gc, CollaborativeFiltering(), sgs["ratings"], "full")):
        os.environ["LUX_EXCHANGE"] = mode
        t = time.perf_counter()
        ex = ShardedPullExecutor(graph, prog, mesh=mesh, sg=sg)
        torch.cuda.synchronize()
        log(f"[sharded] {label} executor (LUX_EXCHANGE={mode}, resolved "
            f"{ex.exchange_mode}) built in {time.perf_counter() - t:.1f} s; "
            f"row tasks (hub rows) per part "
            f"{[(p.tasks.n_tasks, p.tasks.n_hub) for p in ex._parts]}; "
            f"exchange_bytes_per_iter {ex.exchange_bytes_per_iter()}")
        if ex.exchange_mode != mode:
            raise AssertionError(f"{label}: resolved {ex.exchange_mode}")
        exs[label] = ex
    if flag is None:
        del os.environ["LUX_EXCHANGE"]
    else:
        os.environ["LUX_EXCHANGE"] = flag
    # Phase 4l takes the compact PageRank executor; group 2q its plan.
    held.setdefault("telemetry", {})["pull_sharded"] = exs["pagerank compact"]
    _save_xplan("pull_pagerank_compact", "pull_sharded",
                exs["pagerank compact"])

    # -- 4e. K8 and K9 on one part's flat table, against the plain versions ----
    rng = np.random.default_rng(SEED)
    for label, q in (("pagerank compact", P - 1), ("cf", P - 1)):
        ex = exs[label]
        part = ex._parts[q]
        vals = ex.init_values()
        table = ex._table(ex._exchange(vals), q)
        args = (part.row_ptr, part.col_src, part.weights, ex.program.edge_op,
                ex._edge_fn, part.tasks, 0, "rowptr", part.row_base)
        plain = (part.row_ptr, part.col_src, part.weights, ex._edge_fn)
        pkw = dict(window=1 << 20, row_base=part.row_base)
        ints = torch.from_numpy(rng.integers(0, 2, size=tuple(table.shape))
                                .astype(np.float32)).to(dev)
        check_equal(f"{label} part {q} integral", seg.pull_sum(ints, *args),
                    seg.pull_sum_plain(ints, *plain, **pkw))
        got = seg.pull_sum(table, *args)
        want = seg.pull_sum_plain(table, *plain, **pkw)
        tol = (dict(rtol=CF_RTOL, atol=CF_ATOL) if label == "cf"
               else dict(rtol=RTOL, atol=ATOL))
        err = check_close(f"{label} part {q}", got, want, **tol)
        check_equal(f"{label} part {q} twice", seg.pull_sum(table, *args),
                    got)
        ms = cuda_ms(lambda: seg.pull_sum(table, *args), 10)
        n_e, rows = part.col_src.numel(), part.row_ptr.numel() - 1
        width = 1 if table.dim() == 1 else table.shape[1]
        # col_src (and weights), row_ptr, the table's rows read once (the
        # whole table: the sources are spread over it) and the output.
        nbytes = (4 * n_e * (1 if width == 1 else 2) + 8 * (rows + 1)
                  + 4 * width * (table.shape[0] + rows))
        flops = n_e * (1 if width == 1 else 4 * width + 1)
        b_ms = bound(nbytes, flops)[0]
        log(f"[sharded] {label}: part {q}'s kernel (row_base "
            f"{part.row_base}, {n_e} edges, {part.tasks.n_hub} hub rows) "
            f"matches its plain version bitwise on small integers and within "
            f"the tolerance on floats (max abs err {err:.3e}); two calls "
            f"bitwise equal; {ms:.4f} ms (mean of 10) against a bound of "
            f"{b_ms:.4f} ms (no time of a part was taken before the "
            "redesign)")
        del table, got, want, ints

    # -- 5e. end to end ---------------------------------------------------------
    totals = dict.fromkeys(_cuda.LAUNCHES, 0)
    outs = {}
    for label, iters, oracle, tol in (
            ("pagerank full", ITERS, pr_oracle, dict(rtol=RTOL, atol=ATOL)),
            ("pagerank compact", ITERS, pr_oracle,
             dict(rtol=RTOL, atol=ATOL)),
            ("cf", CF_ITERS, cf_oracle, dict(rtol=CF_RTOL, atol=CF_ATOL))):
        ex = exs[label]
        kernel = "cf_edge_sum" if label == "cf" else "gather_segment_sum"
        _cuda.reset_launches()
        out = ex.run(iters)
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        got = ex.gather_values(out)
        if got.shape != oracle.shape or not np.all(np.isfinite(got)):
            raise AssertionError(f"sharded {label}: bad output {got.shape}")
        np.testing.assert_allclose(got, oracle, err_msg=f"sharded {label}",
                                   **tol)
        err = float(np.max(np.abs(got.astype(np.float64) - oracle)))
        check_launches(f"sharded {label}", counts, {kernel: P * iters})
        log(f"[sharded] {label}: run({iters}) matches the f64 oracle (max "
            f"abs err {err:.3e}); launches {counts[kernel]} = {P} parts x "
            f"{iters} iterations")
        for name, n in counts.items():
            totals[name] += n
        outs[label] = (out, got)
        if label != "cf":
            keep(held, f"pull {label}", values=got)
    check_equal("sharded pagerank compact vs full",
                outs["pagerank compact"][0], outs["pagerank full"][0])
    log("[sharded] pagerank: compact equals full bitwise")
    for label, graph, prog, iters in (
            ("pagerank full", g, PageRank(), ITERS),
            ("cf", gc, CollaborativeFiltering(), CF_ITERS)):
        single = PullExecutor(graph, prog).run(iters).cpu().numpy()
        same = np.array_equal(outs[label][1], single)
        log(f"[sharded] {label}: equals the single-device PullExecutor "
            f"bitwise: {same} (max abs diff "
            f"{float(np.max(np.abs(outs[label][1] - single))):.3e})")
        del single
    del outs

    # -- 6e. timing -------------------------------------------------------------
    for label, graph, iters in (("pagerank full", g, ITERS),
                                ("pagerank compact", g, ITERS),
                                ("cf", gc, CF_ITERS)):
        ex = exs[label]
        ex.warmup()
        vals = ex.init_values()
        secs = [host_seconds(lambda: ex.run(iters, vals=vals))
                for _ in range(3)]
        sec = float(np.median(secs))
        ev_ms = cuda_ms(lambda: ex.run(iters, vals=vals), 3) / iters
        runs = [ex.phase_step(vals)[1] for _ in range(5)]
        split = {k: float(np.median([r[k] for r in runs])) * 1e3
                 for k in runs[0]}
        if label != "cf":
            keep(held, f"pull {label}", ms=sec / iters * 1e3)
        log(f"[time] sharded {label}: {sec / iters * 1e3:.3f} ms/iteration, "
            f"{graph.ne * iters / sec / 1e9:.3f} GTEPS (host clock, median "
            f"of 3 runs of {iters}: {[round(x * 1e3, 3) for x in secs]} ms);"
            f" {ev_ms:.3f} ms/iteration by CUDA events (mean of 3); "
            "phase_step split (ms, median of 5): " + ", ".join(
                f"{k}={v:.3f}" for k, v in split.items()))
        busy = device_busy(lambda: ex.run(iters, vals=vals))
        if busy is None:
            log(f"[time] sharded {label}: device busy share not measured "
                "(the profiler saw no kernels)")
        else:
            busy_ms, top = busy
            log(f"[time] sharded {label}: device busy {busy_ms:.3f} ms of "
                f"{sec * 1e3:.3f} ms ({busy_ms / (sec * 1e3):.1%}; "
                "torch.profiler); top kernels (ms): "
                + ", ".join(f"{n}={v:.3f}" for n, v in top))
        # The exchange alone: its input, the (P, max_nv, *t) values, read
        # once, and its output, the tables the parts read, written once.
        x_ms = cuda_ms(lambda: ex._exchange(vals), 10)
        flat = ex._exchange(vals)
        out_bytes = 0 if ex._xplan is None else flat.numel() * 4
        in_bytes = 0 if ex._xplan is None else vals.numel() * 4
        b_ms, _ = bound(in_bytes + out_bytes, 0)
        log(f"[time] sharded {label} exchange ({ex.exchange_mode}): "
            f"{x_ms:.4f} ms (mean of 10, CUDA events) against a bytes bound "
            f"of {b_ms:.4f} ms ({in_bytes + out_bytes} B); "
            f"{ex.exchange_bytes_per_iter()} B per iteration priced as "
            "interconnect bytes")
        del flat, vals
    del exs
    log(f"[sharded] peak device memory of phases 3e-6e "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    _cuda.reset_launches()
    dryrun_multichip(P)
    log(f"[sharded] dryrun_multichip({P}) passed on the card; launches "
        f"{ {k: v for k, v in _cuda.LAUNCHES.items() if v} }; phases 3e-6e "
        f"took {time.perf_counter() - t_phase:.1f} s")
    return totals, sgs["rmat"]


MULTI_LANES = 8


def _push_sharded_phases(g, gu, push, dev, kernels, held, sg_rmat=None):
    """Phases 3f-6f on the multi-source and sharded push engines: SSSP
    from vertex 0 on ``g`` over ``SHARDED_PARTS`` parts in the full and
    compact exchange modes, CC on the closure ``gu``, and 8-lane
    multi-source SSSP on one device and over the parts. ``push`` is
    phase 5b's context (oracles, iterations, ms to fixpoint, the SSSP
    executor). Returns the launch counts of the phase 5f runs, summed,
    and under ``<kernel>[split]`` those of the split-table calls; and the
    two shard layouts (``rmat``, ``closure``) for the sharded GAS
    phases. ``sg_rmat``, phase 3e's layout of ``g``, is reused. Leaves the
    full-mode SSSP's ms to fixpoint in ``held["sharded sssp"]``, the
    single-device 8-lane run's roots and host lanes in ``held["multi"]``
    and each run's values, ledgers and ms for group 3k."""
    import torch

    from lux_tpu_torch.engine.check import count_violations
    from lux_tpu_torch.engine.push import MultiSourcePushExecutor
    from lux_tpu_torch.engine.push_sharded import (
        ShardedMultiSourcePushExecutor,
        ShardedPushExecutor,
    )
    from lux_tpu_torch.models import SSSP, ConnectedComponents
    from lux_tpu_torch.ops import _cuda
    from lux_tpu_torch.ops import frontier as fq
    from lux_tpu_torch.ops import segment as seg
    from lux_tpu_torch.parallel.mesh import make_mesh
    from lux_tpu_torch.parallel.shard import ShardedGraph

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    P, K = SHARDED_PARTS, MULTI_LANES
    mesh = make_mesh(P, dev)
    flag = os.environ.get("LUX_EXCHANGE")
    reps = 10

    # -- 3f. host set-up ----------------------------------------------------
    sgs = {}
    for name, graph in (("rmat", g), ("closure", gu)):
        t = time.perf_counter()
        sg = (sg_rmat if name == "rmat" and sg_rmat is not None
              else ShardedGraph.build(graph, P))
        t_sg = time.perf_counter() - t
        t = time.perf_counter()
        sg.build_push_csr()     # cached on sg: the executors share it
        t_csr = time.perf_counter() - t
        plan = sg.exchange_plan()
        log(f"[push-sharded] {name}: nv={graph.nv} ne={graph.ne} P={P} "
            f"max_nv={sg.max_nv} ({P * sg.max_nv / graph.nv:.3f} nv padded "
            f"rows) max_ne={sg.max_ne} part nv={sg.local_nv.tolist()}; "
            f"layout {t_sg:.1f} s"
            f"{' (phase 3e' + chr(39) + 's)' if sg is sg_rmat else ''}, "
            f"push CSR {t_csr:.1f} s; compact capacity "
            f"{plan.capacity} (profitable {plan.profitable}); exchange bytes "
            f"per iteration at 5 B rows: full {P * (P - 1) * sg.max_nv * 5},"
            f" compact {plan.exchange_bytes_per_iter(5)}")
        sgs[name] = sg
    rng = np.random.default_rng(0)
    has_out = np.flatnonzero(g.out_degrees > 0)
    roots = [0] + rng.choice(has_out[has_out != 0], K - 1,
                             replace=False).tolist()
    exs = {}
    for label, graph, prog, sg, mode, lanes in (
            ("sssp full", g, SSSP(), sgs["rmat"], "full", 0),
            ("sssp compact", g, SSSP(), sgs["rmat"], "compact", 0),
            ("cc", gu, ConnectedComponents(), sgs["closure"], None, 0),
            ("multi full", g, SSSP(), sgs["rmat"], "full", K),
            ("multi compact", g, SSSP(), sgs["rmat"], "compact", K)):
        if mode is None:
            os.environ.pop("LUX_EXCHANGE", None)
        else:
            os.environ["LUX_EXCHANGE"] = mode
        t = time.perf_counter()
        if lanes:
            ex = ShardedMultiSourcePushExecutor(graph, prog, lanes,
                                                mesh=mesh, sg=sg)
            what = f"k={lanes}"
        else:
            ex = ShardedPushExecutor(graph, prog, mesh=mesh, sg=sg)
            what = (f"blocked_dense={ex.blocked_dense} sparse={ex.sparse} "
                    f"queue_cap={ex.queue_cap} edge_budget="
                    f"{ex.edge_budget} tiers={ex.tiers}")
        torch.cuda.synchronize()
        log(f"[push-sharded] {label} executor (LUX_EXCHANGE="
            f"{mode or 'unset'}, resolved {ex.exchange_mode}) built in "
            f"{time.perf_counter() - t:.1f} s: {what}; "
            f"exchange_bytes_per_iter {ex.exchange_bytes_per_iter()}")
        if ex.exchange_mode != (mode or "full"):
            raise AssertionError(f"{label}: resolved {ex.exchange_mode}")
        exs[label] = ex
    if flag is None:
        os.environ.pop("LUX_EXCHANGE", None)
    else:
        os.environ["LUX_EXCHANGE"] = flag
    t = time.perf_counter()
    mx1 = MultiSourcePushExecutor(g, SSSP(), K)
    torch.cuda.synchronize()
    log(f"[push-sharded] single-device multi-source executor (k={K}) built "
        f"in {time.perf_counter() - t:.1f} s; roots {roots}")

    # -- 4f. the kernels at the sharded path's shapes -----------------------
    # K5 on the dense iteration of the full-mode SSSP run with the largest
    # frontier, for the part with the most edges: over the packed flat
    # table (full) and over its receiver's table of values and frontier
    # (compact).
    ex = exs["sssp full"]
    ex.run(start=0)
    branches = list(ex.branch_log)
    relax = seg.RELAX_OPS["add1"]
    n = ex.sg.max_nv
    dense_at = [(e[1], i) for i, e in enumerate(branches) if e[0] == 0]
    if not dense_at:
        raise AssertionError("sharded SSSP took no dense iteration")
    _, at = max(dense_at)
    st, _ = ex.run(max_iters=at, start=0)
    q = int(np.argmax([pt.col_src.numel() for pt in ex._parts]))
    n_e = ex._parts[q].col_src.numel()
    n_src = int(torch.unique(ex._parts[q].col_src).numel())
    for form, x in (("full", ex), ("compact", exs["sssp compact"])):
        table, front = x._dense_load(st)
        pt = x._parts[q]
        k5_args = (pt.row_ptr, pt.col_src, x._table(table, q),
                   x._table(front, q), "min")

        def k5_call(k5_args=k5_args, tasks=pt.tasks):
            return seg.segment_minmax_relax(*k5_args, "add1", tasks)

        got = k5_call()
        check_equal(f"K5 sharded {form}, part {q}", got,
                    seg.segment_minmax_relax_plain(*k5_args, relax))
        check_equal(f"K5 sharded {form}, part {q}, twice", k5_call(), got)
        del got
        k5_ms = cuda_ms(k5_call, reps)
        k5_plain = cuda_ms(lambda k5_args=k5_args: (
            seg.segment_minmax_relax_plain(*k5_args, relax)), 2)
        # The part's edges and offsets, its sources' rows of the table
        # (a packed word, or a value and a frontier byte), its output.
        k5_bytes = 4 * n_e + 8 * (n + 1) + 4 * n \
            + (4 if front is None else 5) * n_src
        what = "packed" if front is None else "values and frontier"
        log(f"[push-sharded] K5 {form} ({what}) on SSSP iteration "
            f"{at + 1}, part {q} ({n_e} edges from {n_src} "
            f"sources, a {tuple(k5_args[2].shape)} table): bitwise, two "
            f"calls equal; "
            f"{k5_ms:.4f} ms (plain {k5_plain:.4f}, bytes bound "
            f"{bound(k5_bytes, n_e)[0]:.4f})")
        record(kernels, f"segment_minmax_relax[sharded {form}]",
               "lux_tpu_torch/csrc/gas.cu",
               "lux_tpu/engine/push.py:1110", 0.0, k5_ms, k5_plain,
               k5_bytes, n_e, None)
        log_gathers(f"K5 sharded {form}, part {q}", k5_ms,
                    K5_PART_WAS_MS[form], bound(k5_bytes, n_e)[0], 32 * n_e,
                    "one 32-byte sector an edge", tag="push-sharded")
        del table, front, k5_args
    del st

    # K6 and K7 on the sparse iteration of that run with the most
    # out-edges. K6 on the part with the largest frontier, as the sparse
    # branch calls it; K7 with the flat pre-step stack as values, the
    # receiving part with the most queued edges, its push_dst_local, out
    # its row.
    sparse_at = [(e[2], i) for i, e in enumerate(branches) if e[0] > 0]
    if not sparse_at:
        raise AssertionError("sharded SSSP took no sparse iteration")
    _, at = max(sparse_at)
    st, _ = ex.run(max_iters=at, start=0)
    stats = ex._frontier_stats(st)
    p6 = int(np.argmax(stats[2]))
    fr6, cnt6, rp6 = st.frontier[p6], stats[2][p6], ex._queue_row_ptr
    for name, got, want in zip(("q", "start", "deg", "offs"),
                               fq.frontier_queue(fr6, rp6, cnt6),
                               fq.frontier_queue_plain(fr6, rp6)):
        check_equal(f"K6 sharded {name}, part {p6}", got, want)
    k6_ms = cuda_ms(lambda: fq.frontier_queue(fr6, rp6, cnt6), reps)
    k6_plain = cuda_ms(lambda: fq.frontier_queue_plain(fr6, rp6), reps)
    k6_lib = cuda_ms(lambda: torch.nonzero(fr6), reps)
    k6_bytes = n + 16 * cnt6 + 28 * cnt6 + 8
    log(f"[push-sharded] K6 on SSSP iteration {at + 1}, part {p6} "
        f"({cnt6} of {stats[0]} queued vertices): bitwise; {k6_ms:.4f} ms "
        f"(plain {k6_plain:.4f}, torch.nonzero {k6_lib:.4f}, bytes bound "
        f"{bound(k6_bytes, 0)[0]:.4f})")
    record(kernels, "frontier_queue[sharded]",
           "lux_tpu_torch/csrc/frontier.cu", "lux_tpu/engine/push.py:1206",
           0.0, k6_ms, k6_plain, k6_bytes, cnt6, k6_lib)
    del fr6, rp6
    rows, ids = ex._sparse_load(st, stats)
    start = ex.push_row_ptr[:, ids]
    offs = torch.nn.functional.pad(
        (ex.push_row_ptr[:, ids + 1] - start).cumsum(1), (1, 0))
    totals = offs[:, -1].tolist()
    total, cnt = stats[1], rows.numel()
    if sum(totals) != total:
        raise AssertionError(f"K7 split table: receivers' totals {totals} "
                             f"against the frontier's {total} out-edges")
    k7_args = (rows, start, offs, ex.push_dst_local, st.values, "min")
    want = fq.queue_relax_scatter_plain(*k7_args, relax)
    check_equal(f"K7 split table, {P} parts in one launch",
                fq.queue_relax_scatter(*k7_args, "add1", total), want)
    check_equal(f"K7 split table, {P} parts in one launch, twice",
                fq.queue_relax_scatter(*k7_args, "add1", total), want)
    k7_ms = cuda_ms(lambda: fq.queue_relax_scatter(*k7_args, "add1", total),
                    reps)
    # The plain version is four scatters, one per part.
    k7_plain = cuda_ms(lambda: fq.queue_relax_scatter_plain(*k7_args, relax),
                       reps)
    # Yardstick: one scatter_reduce over the flat table, every part's
    # candidates and destinations built beforehand.
    flat64 = seg.widen_u32(st.values).reshape(-1)
    dsts, cands = [], []
    for q_ in range(P):
        slot, edge = fq.queue_edges(rows, start[q_], offs[q_])
        dsts.append(ex.push_dst_local[q_][edge].long() + q_ * n)
        cands.append(relax(flat64[rows.long()[slot]]))
    dst_e, cand = torch.cat(dsts), torch.cat(cands)
    k7_lib = cuda_ms(lambda: flat64.scatter_reduce(
        0, dst_e, cand, reduce="amin", include_self=True), reps)
    del dsts, cands, dst_e, cand, flat64, want, slot, edge
    # The stack copied (read and written), the queue's rows and values,
    # each part's start and offs at the queue, col_dst at the queued edges.
    k7_bytes = 8 * st.values.numel() + 8 * cnt + 16 * P * cnt + 8 * P \
        + 4 * total
    log(f"[push-sharded] K7 split table on SSSP iteration {at + 1}: one "
        f"launch over {P} parts (queue {cnt}, {total} edges, the parts "
        f"receiving {totals}): bitwise, two calls equal; {k7_ms:.4f} ms, "
        f"where one of the {P} launches it replaces (the largest part's) "
        f"took {K7_SPLIT_WAS_MS} ms after a clone and a host read (plain, "
        f"{P} scatters, {k7_plain:.4f}; one "
        f"scatter_reduce {k7_lib:.4f}; bytes bound "
        f"{bound(k7_bytes, total)[0]:.4f})")
    record(kernels, "queue_relax_scatter[split]",
           "lux_tpu_torch/csrc/frontier.cu", "lux_tpu/engine/push.py:1214",
           0.0, k7_ms, k7_plain, k7_bytes, total, k7_lib)
    del st, rows, ids, start, offs, k7_args
    torch.cuda.empty_cache()

    # K10 with K columns over the flat (P * max_nv, K) table, for the
    # part with the most edges, on the multi-source state with the
    # largest frontier.
    mx = exs["multi full"]
    st = mx.init_state(roots)
    best = (int(st.frontier.sum()), 0, st)
    for i in range(1, 32):
        st, c = mx.step(st)
        if c > best[0]:
            best = (c, i, st)
        if c == 0:
            break
    c, at, st = best
    table, front = mx._load(st)
    q = int(np.argmax([pt.col_src.numel() for pt in mx._parts]))
    part = mx._parts[q]
    n_e = part.col_src.numel()
    k10_args = (part.row_ptr, part.col_src, table, front, "min")
    want = seg.gas_pull_acc_plain(*k10_args, SSSP().relax)
    check_equal(f"K10 split table k={K}, part {q}",
                seg.gas_pull_acc(*k10_args, "add1", part.tasks), want)
    k10_ms = cuda_ms(lambda: seg.gas_pull_acc(*k10_args, "add1",
                                              part.tasks), reps)
    k10_plain = cuda_ms(lambda: seg.gas_pull_acc_plain(
        *k10_args, SSSP().relax), 2)
    src = part.col_src.long()
    msg = torch.where(front[src], relax(seg.widen_u32(table[src])),
                      seg.identity_for("min", np.uint32))
    dst = torch.repeat_interleave(torch.arange(n, device=dev),
                                  part.row_ptr.diff())[:, None].expand(-1, K)
    acc0 = torch.full((n, K), seg.identity_for("min", np.uint32),
                      dtype=torch.int64, device=dev)
    k10_lib = cuda_ms(lambda: acc0.scatter_reduce(
        0, dst, msg, reduce="amin", include_self=True), reps)
    del src, msg, dst, acc0, want
    k10_bytes = 4 * n_e + 8 * (n + 1) + 5 * g.nv * K + 4 * n * K
    log(f"[push-sharded] K10 split table k={K} on part {q} ({n_e} edges, "
        f"{c} active lane entries after {at} iterations, a "
        f"({P * n}, {K}) table): bitwise; {k10_ms:.4f} ms (plain "
        f"{k10_plain:.4f}, scatter_reduce {k10_lib:.4f}, bytes bound "
        f"{bound(k10_bytes, n_e * K)[0]:.4f})")
    record(kernels, "gas_pull_acc[split]", "lux_tpu_torch/csrc/gas.cu",
           "lux_tpu/engine/push.py:1708", 0.0, k10_ms, k10_plain, k10_bytes,
           n_e * K, k10_lib)
    del st, best, table, front, k10_args
    # B11: K10 with K columns on one device, on the single-device
    # multi-source state with the largest frontier.
    st = mx1.init_state(roots)
    best = (int(st.frontier.sum()), 0, st)
    for i in range(1, 32):
        st, c = mx1.step(st)
        if c > best[0]:
            best = (c, i, st)
        if c == 0:
            break
    c, at, st = best
    b11_args = (mx1.row_ptr, mx1.col_src, st.values, st.frontier, "min")
    check_equal(f"K10 k={K} one device", seg.gas_pull_acc(
        *b11_args, "add1", mx1.tasks), seg.gas_pull_acc_plain(
            *b11_args, SSSP().relax))
    b11_ms = cuda_ms(lambda: seg.gas_pull_acc(*b11_args, "add1",
                                              mx1.tasks), reps)
    b11_plain = cuda_ms(lambda: seg.gas_pull_acc_plain(
        *b11_args, SSSP().relax), 2)
    # The same reduce in one PyTorch call: an int64 scatter_reduce of the
    # masked (ne, K) messages, as the split-table row above measures it.
    src = mx1.col_src.long()
    msg = torch.where(st.frontier[src], relax(seg.widen_u32(st.values[src])),
                      seg.identity_for("min", np.uint32))
    dst = torch.repeat_interleave(torch.arange(g.nv, device=dev),
                                  mx1.row_ptr.diff())[:, None].expand(-1, K)
    acc0 = torch.full((g.nv, K), seg.identity_for("min", np.uint32),
                      dtype=torch.int64, device=dev)
    b11_lib = cuda_ms(lambda: acc0.scatter_reduce(
        0, dst, msg, reduce="amin", include_self=True), reps)
    del src, msg, dst, acc0
    b11_bytes = 4 * g.ne + 8 * (g.nv + 1) + 9 * g.nv * K
    log(f"[push-sharded] K10 k={K} on one device (multi-source SSSP, {c} "
        f"active lane entries after {at} iterations): bitwise; "
        f"{b11_ms:.4f} ms (plain {b11_plain:.4f}, scatter_reduce "
        f"{b11_lib:.4f}, bytes bound {bound(b11_bytes, g.ne * K)[0]:.4f})")
    del st, best, b11_args
    torch.cuda.empty_cache()

    # -- 5f. end to end -------------------------------------------------------
    totals = dict.fromkeys(_cuda.LAUNCHES, 0)
    totals.update(dict.fromkeys(
        ("segment_minmax_relax[sharded full]",
         "segment_minmax_relax[sharded compact]", "frontier_queue[sharded]",
         "queue_relax_scatter[split]", "gas_pull_acc[split]"), 0))

    def counted(fn):
        _cuda.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        for name, v in counts.items():
            totals[name] += v
        return out, counts

    finals = {}
    for label, app, kw in (("sssp full", "sssp", {"start": 0}),
                           ("sssp compact", "sssp", {"start": 0}),
                           ("cc", "cc", {})):
        ex = exs[label]
        (st, iters), counts = counted(lambda: ex.run(**kw))
        vals = ex.gather_values(st)
        ref = push[app]
        if vals.shape != (ex.graph.nv,) or vals.dtype != np.uint32:
            raise AssertionError(f"{label}: bad output {vals.shape}")
        if not np.array_equal(vals, ref["oracle"]):
            raise AssertionError(
                f"sharded {label}: {int(np.sum(vals != ref['oracle']))} "
                "values differ from the oracle")
        viol = count_violations(ex.graph, vals, ex.program)
        if viol:
            raise AssertionError(f"sharded {label}: {viol} violations")
        if iters != ref["iters"]:
            raise AssertionError(f"sharded {label}: {iters} iterations, "
                                 f"single-device {ref['iters']}")
        with_edges = sum(1 for pt in ex._parts if pt.col_src.numel())
        dense = iters - ex.sparse_iters
        check_launches(f"sharded {label}", counts, {
            "segment_minmax_relax": with_edges * dense,
            "frontier_queue": sum(k6 for k6, _ in ex.queue_log),
            "queue_relax_scatter": sum(k7 for _, k7 in ex.queue_log)})
        form = "compact" if ex._xch is not None else "full"
        totals[f"segment_minmax_relax[sharded {form}]"] += \
            counts["segment_minmax_relax"]
        totals["frontier_queue[sharded]"] += counts["frontier_queue"]
        totals["queue_relax_scatter[split]"] += counts["queue_relax_scatter"]
        log(f"[push-sharded] {label}: fixpoint in {iters} iterations "
            f"({ex.sparse_iters} sparse; single-device {ref['iters']} "
            f"({ref['sparse_iters']} sparse)) matches the oracle and the "
            f"single-device PushExecutor bitwise, 0 violations; branches "
            f"{[e[:3] for e in ex.branch_log]}; queues (K6, K7 launches) "
            f"{ex.queue_log}; launches K5 {counts['segment_minmax_relax']} "
            f"= {with_edges} parts x {dense} dense, K6 "
            f"{counts['frontier_queue']}, K7 {counts['queue_relax_scatter']}")
        finals[label] = st
        keep(held, f"push {label}", values=vals, iters=iters,
             sparse=ex.sparse_iters, log=list(ex.branch_log))
    for part in ("values", "frontier"):
        check_equal(f"sharded sssp compact vs full {part}",
                    getattr(finals["sssp compact"], part),
                    getattr(finals["sssp full"], part))
    log("[push-sharded] sssp: compact equals full bitwise (values and "
        "frontier)")
    del finals

    (mst, miters), counts = counted(lambda: mx1.run(roots))
    check_launches("multi-source sssp", counts, {"gas_pull_acc": miters})
    single = push["sssp_ex"]
    longest = 0
    for j, r in enumerate(roots):
        sst, sn = single.run(start=r)
        longest = max(longest, sn)
        if not np.array_equal(mx1.values_for(mst, j), single.values(sst)):
            raise AssertionError(f"multi-source lane {j} (root {r}) differs "
                                 "from its single-source run")
    if miters != longest:
        raise AssertionError(f"multi-source: {miters} iterations, longest "
                             f"single-source run {longest}")
    lanes = seg.u32_to_numpy(mst.values)
    held["multi"] = (roots, lanes)      # group 3j-6j's old lanes
    log(f"[push-sharded] multi-source sssp k={K}: {miters} iterations; "
        f"every lane equals its single-source PushExecutor run bitwise "
        f"(longest {longest} iterations); launches K10 "
        f"{counts['gas_pull_acc']}")
    for label in ("multi full", "multi compact"):
        mx = exs[label]
        (st, iters), counts = counted(lambda: mx.run(roots))
        check_launches(f"sharded {label}", counts,
                       {"gas_pull_acc": P * iters})
        totals["gas_pull_acc[split]"] += counts["gas_pull_acc"]
        got = mx.gather_values(st)
        if got.shape != (g.nv, K) or not np.array_equal(got, lanes):
            raise AssertionError(f"sharded {label}: differs from the "
                                 "single-device multi-source run")
        if iters != miters:
            raise AssertionError(f"sharded {label}: {iters} iterations")
        log(f"[push-sharded] {label}: {iters} iterations, equal to the "
            f"single-device multi-source run bitwise; launches K10 "
            f"{counts['gas_pull_acc']} = {P} parts x {iters}")
        keep(held, f"push {label}", values=got, iters=iters, roots=roots)
    del mst, st, lanes

    # -- 6f. timing -----------------------------------------------------------
    for label, app, kw in (("sssp full", "sssp", {"start": 0}),
                           ("sssp compact", "sssp", {"start": 0}),
                           ("cc", "cc", {})):
        ex = exs[label]
        ex.warmup(**kw)
        secs = [host_seconds(lambda: ex.run(**kw)) for _ in range(3)]
        sec = float(np.median(secs))
        iters = len(ex.branch_log)
        init = float(np.median([host_seconds(lambda: ex.init_state(**kw))
                                for _ in range(3)]))
        st0 = ex.init_state(**kw)
        iter_sec = float(np.median([host_seconds(lambda: ex.run(state=st0))
                                    for _ in range(3)]))
        if label == "sssp full":
            held["sharded sssp"] = {"ms": sec * 1e3}
        keep(held, f"push {label}", ms=sec * 1e3)
        log(f"[time] sharded push {label}: {iters} iterations "
            f"({ex.sparse_iters} sparse) in {sec * 1e3:.3f} ms (median of 3:"
            f" {[round(x * 1e3, 3) for x in secs]}), "
            f"{sec / iters * 1e3:.3f} ms/iteration, "
            f"{ex.graph.ne * iters / sec / 1e9:.3f} GTEPS; init_state "
            f"{init * 1e3:.3f} ms; run from a device state "
            f"{iter_sec * 1e3:.3f} ms; single-device PushExecutor "
            f"{push[app]['ms']:.3f} ms to fixpoint (phase 6b)")
        busy = device_busy(lambda: ex.run(state=st0))
        if busy is None:
            log(f"[time] sharded push {label}: device busy share not "
                "measured (the profiler saw no kernels)")
        else:
            busy_ms, top = busy
            log(f"[time] sharded push {label}: device busy {busy_ms:.3f} ms "
                f"of the {iter_sec * 1e3:.3f} ms run from a device state "
                f"({busy_ms / (iter_sec * 1e3):.1%}; torch.profiler); top "
                "kernels (ms): " + ", ".join(f"{n}={v:.3f}" for n, v in top))
        st = ex.init_state(**kw)
        ex.warmup_phases(st)
        split = {}
        while True:
            st, c, times = ex.phase_step(st)
            branch = "dense" if times.pop("branch") == "dense" else "sparse"
            split.setdefault(branch, []).append(times)
            if c == 0:
                break
        for branch, runs in split.items():
            med = {k: float(np.median([r[k] for r in runs])) * 1e3
                   for k in runs[0]}
            log(f"[time] sharded push {label} {branch} phases (ms, median of"
                f" {len(runs)}; load = the exchange): " + ", ".join(
                    f"{k}={v:.3f}" for k, v in med.items()))
        # The dense exchange alone: views in full mode (plus the packing
        # under blocked_dense), the compact tables of values and frontier.
        x_ms = cuda_ms(lambda: ex._dense_load(st0), reps)
        rows_all = P * ex.sg.max_nv
        if ex._xch is not None:
            x_bytes = 5 * rows_all + 5 * P * rows_all
        elif ex.blocked_dense:
            x_bytes = 9 * rows_all
        else:
            x_bytes = 0
        log(f"[time] sharded push {label} exchange ({ex.exchange_mode}, "
            f"blocked_dense={ex.blocked_dense}): {x_ms:.4f} ms (mean of "
            f"{reps}, CUDA events) against a bytes bound of "
            f"{bound(x_bytes, 0)[0]:.4f} ms ({x_bytes} B); "
            f"{ex.exchange_bytes_per_iter()} B per iteration priced as "
            "interconnect bytes")
        del st, st0
    for label, mx in (("multi 1 device", mx1), ("multi full",
                                                exs["multi full"]),
                      ("multi compact", exs["multi compact"])):
        mx.warmup(start=roots[0])
        secs = [host_seconds(lambda: mx.run(roots)) for _ in range(3)]
        sec = float(np.median(secs))
        st0 = mx.init_state(roots)
        iter_sec = float(np.median([
            host_seconds(lambda: mx.run(roots, state=st0))
            for _ in range(3)]))
        runs = []
        st = st0
        while True:
            st, c, times = mx.phase_step(st)
            times.pop("branch")
            runs.append(times)
            if c == 0:
                break
        med = {k: float(np.median([r[k] for r in runs])) * 1e3
               for k in runs[0]}
        if label != "multi 1 device":
            keep(held, f"push {label}", ms=sec * 1e3)
        log(f"[time] {label} sssp k={K}: {miters} iterations in "
            f"{sec * 1e3:.3f} ms (median of 3: "
            f"{[round(x * 1e3, 3) for x in secs]}), "
            f"{sec / miters * 1e3:.3f} ms/iteration, "
            f"{g.ne * miters / sec / 1e9:.3f} GTEPS ({K} lanes each); run "
            f"from a device state {iter_sec * 1e3:.3f} ms; phases (ms, "
            f"median of {len(runs)}): " + ", ".join(
                f"{k}={v:.3f}" for k, v in med.items()))
        busy = device_busy(lambda: mx.run(roots, state=st0))
        if busy is None:
            log(f"[time] {label}: device busy share not measured (the "
                "profiler saw no kernels)")
        else:
            busy_ms, top = busy
            log(f"[time] {label}: device busy {busy_ms:.3f} ms of the "
                f"{iter_sec * 1e3:.3f} ms run from a device state "
                f"({busy_ms / (iter_sec * 1e3):.1%}; torch.profiler); top "
                "kernels (ms): " + ", ".join(f"{n}={v:.3f}" for n, v in top))
        if label != "multi 1 device":
            x_ms = cuda_ms(lambda: mx._load(st0), reps)
            rows_all = P * mx.sg.max_nv
            x_bytes = (5 * K * rows_all * (P + 1) if mx._xch is not None
                       else 0)
            log(f"[time] {label} exchange ({mx.exchange_mode}): "
                f"{x_ms:.4f} ms (mean of {reps}) against a bytes bound of "
                f"{bound(x_bytes, 0)[0]:.4f} ms ({x_bytes} B); "
                f"{mx.exchange_bytes_per_iter()} B per iteration priced as "
                "interconnect bytes")
        del st, st0
    del exs, mx1
    log(f"[push-sharded] peak device memory of phases 3f-6f "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phases "
        f"3f-6f took {time.perf_counter() - t_phase:.1f} s")
    return totals, sgs



GAS_SHARDED_APPS = {
    # label -> (graph key, program maker, LUX_EXCHANGE, run kw, 5d app,
    # bench.py's max_iters)
    "bfs full": ("rmat", "bfs", "full"),
    "bfs compact": ("rmat", "bfs", "compact"),
    "bfs frontier": ("rmat", "bfs", "frontier"),
    "sssp_delta full": ("weighted", "sssp_delta", "full"),
    "sssp_delta frontier": ("weighted", "sssp_delta", "frontier"),
    "labelprop frontier": ("rmat", "labelprop", "frontier"),
    "kcore frontier": ("closure", "kcore", "frontier"),
}


def _gas_sharded_expected(ex) -> dict:
    """Launches of one sharded GAS run from its direction log: K10 per
    part and pull iteration; K6 per part with a frontier and push
    iteration; K11 once per push iteration with out-edges."""
    log = ex.direction_log
    return {
        "gas_pull_acc": ex.num_parts * sum(1 for e in log if e[0] == 0),
        "frontier_queue": sum(sum(1 for c in e[4] if c)
                              for e in log if e[0] == 1),
        "gas_push_acc": sum(1 for e in log
                            if e[0] == 1 and e[1] > 0 and e[2] > 0),
    }


def _gas_sharded_phases(g, gw, gu, sgs, gas, pr_oracle, dev,
                        kernels, held) -> dict:
    """Phases 3h-6h on the sharded GAS engines over ``SHARDED_PARTS``
    parts: adaptive BFS from 0 on ``g`` in the full, compact and frontier
    exchange modes, DeltaSSSP from 0 on the weighted twin ``gw`` (full,
    frontier), label propagation on ``g`` and k-core (k = 4) on the
    closure ``gu`` (frontier, whose dense starts downgrade), 8-lane BFS
    (compact) and PageRank through ``PullGasAdapter``. ``sgs`` holds
    phase 3f's layouts of ``g`` and ``gu``; ``gas`` is phase 5d's context
    (oracles, iterations, ms to fixpoint). Returns the launch counts of
    the phase 5h runs, summed, and under ``gas_push_acc[sharded]`` K11's
    launches over the parts. Keeps frontier-mode BFS's and the 8-lane
    BFS's values, ledgers and ms for group 3k."""
    import torch

    from lux_tpu_torch.engine.check import count_violations
    from lux_tpu_torch.engine.gas import as_gas
    from lux_tpu_torch.engine.gas_sharded import (
        ShardedAdaptiveExecutor,
        ShardedMultiSourceGasExecutor,
    )
    from lux_tpu_torch.models import (
        BFS,
        DeltaSSSP,
        KCore,
        LabelPropagation,
        PageRank,
    )
    from lux_tpu_torch.ops import _cuda
    from lux_tpu_torch.ops import frontier as fq
    from lux_tpu_torch.ops import segment as seg
    from lux_tpu_torch.parallel.mesh import make_mesh
    from lux_tpu_torch.parallel.shard import ShardedGraph

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    P, K = SHARDED_PARTS, MULTI_LANES
    mesh = make_mesh(P, dev)
    flag = os.environ.get("LUX_EXCHANGE")
    reps = 10

    # -- 3h. the weighted twin's layout and the executors --------------------
    t = time.perf_counter()
    sgw = ShardedGraph.build(gw, P)
    sgw.build_push_csr()
    sgw.exchange_plan()
    log(f"[gas-sharded] weighted twin: layout, push CSR and compact plan in "
        f"{time.perf_counter() - t:.1f} s (the rmat and closure layouts are "
        "phase 3f's)")
    layouts = {"rmat": (g, sgs["rmat"]), "closure": (gu, sgs["closure"]),
               "weighted": (gw, sgw)}
    makers = {"bfs": BFS, "sssp_delta": DeltaSSSP,
              "labelprop": LabelPropagation, "kcore": lambda: KCore(k=4)}
    kws = {"bfs": {"start": 0}, "sssp_delta": {"start": 0},
           "labelprop": {}, "kcore": {}}
    max_iters = {"bfs": 32, "sssp_delta": 32, "labelprop": 16, "kcore": 32}
    exs = {}

    def build(label, mode, make):
        if mode is None:
            os.environ.pop("LUX_EXCHANGE", None)
        else:
            os.environ["LUX_EXCHANGE"] = mode
        t = time.perf_counter()
        ex = make()
        torch.cuda.synchronize()
        log(f"[gas-sharded] {label} executor (LUX_EXCHANGE={mode or 'unset'}"
            f", resolved {ex.exchange_mode}) built in "
            f"{time.perf_counter() - t:.1f} s; exchange_bytes_per_iter "
            f"{ex.exchange_bytes_per_iter()}")
        if ex.exchange_mode != (mode or "full"):
            raise AssertionError(f"{label}: resolved {ex.exchange_mode}")
        exs[label] = ex
        return ex

    for label, (key, app, mode) in GAS_SHARDED_APPS.items():
        graph, sg = layouts[key]
        ex = build(label, mode, lambda: ShardedAdaptiveExecutor(
            graph, makers[app](), mesh=mesh, sg=sg))
        log(f"[gas-sharded] {label}: P={P} max_nv={sg.max_nv} "
            f"max_ne={sg.max_ne} hi/lo counts {ex.hi_count}/{ex.lo_count} "
            f"queue_cap={ex.queue_cap} edge_budget={ex.edge_budget} "
            f"frontier_cap={ex.frontier_cap} frontier_evidence="
            f"{ex.frontier_evidence()}")
    rng = np.random.default_rng(0)
    has_out = np.flatnonzero(g.out_degrees > 0)
    roots = [0] + rng.choice(has_out[has_out != 0], K - 1,
                             replace=False).tolist()
    mx = build("multi compact", "compact",
               lambda: ShardedMultiSourceGasExecutor(
                   g, BFS(), K, mesh=mesh, sg=sgs["rmat"]))
    pr = build("pagerank", None, lambda: ShardedAdaptiveExecutor(
        g, as_gas(PageRank()), mesh=mesh, sg=sgs["rmat"]))
    if flag is None:
        os.environ.pop("LUX_EXCHANGE", None)
    else:
        os.environ["LUX_EXCHANGE"] = flag
    log(f"[gas-sharded] multi-source roots {roots}")
    _save_xplan("gas_bfs_compact", "gas_sharded", exs["bfs compact"])

    # -- 4h. K11 over the P receivers in one launch --------------------------
    # BFS's first frontier (vertex 0) and a synthetic frontier of
    # queue_cap vertices a part (drawn with the seed) on BFS's state after
    # 2 iterations; DeltaSSSP (the f32 decode over all P rows) at the cap
    # on its state after 2 iterations. Each bitwise against the plain
    # version, which folds receiver by receiver.
    row = None
    for label, app in (("bfs full", "bfs"), ("sssp_delta full",
                                            "sssp_delta")):
        ex = exs[label]
        prog = ex.program
        weighted = prog.gather_op in seg.F32_GATHER_OPS
        n = ex.sg.max_nv
        mid, _ = ex.run(max_iters=2, **kws[app])
        cap_fr = torch.zeros((P, n), dtype=torch.bool)
        for p in range(P):
            nv_p = int(ex.sg.local_nv[p])
            cap_fr[p, torch.from_numpy(rng.choice(
                nv_p, min(nv_p, ex.queue_cap), replace=False))] = True
        cands = [("cap", mid._replace(frontier=cap_fr.to(dev)))]
        if app == "bfs":
            cands.insert(0, ("first frontier", ex.init_state(**kws[app])))
        for what, st in cands:
            stats = ex._frontier_stats(st)
            rows, ids = ex._push_load(st, stats)
            start, offs = ex._ranges(ids)
            cnt, total = rows.numel(), stats.out_edges
            if int(offs[:, -1].sum()) != total:
                raise AssertionError(f"K11 {label} {what}: receivers' "
                                     "totals differ from the out-edges")
            args = (rows, start, offs, ex.push_dst_local, st.values,
                    prog.combiner)

            def call(args=args, prog=prog, ex=ex, total=total):
                return fq.gas_push_acc(*args, prog.gather_op, total,
                                       weights=ex.push_weights)

            def plain(args=args, prog=prog, ex=ex):
                return fq.gas_push_acc_plain(*args, prog.gather,
                                             weights=ex.push_weights)

            want = plain()
            check_equal(f"K11 {P} receivers {label} {what}", call(), want)
            check_equal(f"K11 {P} receivers {label} {what}, twice", call(),
                        want)
            ms = cuda_ms(call, reps)
            plain_ms = cuda_ms(plain, 2)
            # Yardstick: one scatter_reduce over the flat (P * max_nv)
            # accumulator, every receiver's messages and destinations
            # built beforehand.
            vals, dom = seg.gas_widen(st.values.reshape(-1))
            dsts, msgs = [], []
            for p in range(P):
                slot, edge = fq.queue_edges(rows, start[p], offs[p])
                dsts.append(ex.push_dst_local[p][edge].long() + p * n)
                msgs.append(prog.gather(
                    vals[rows.long()[slot]],
                    ex.push_weights[p][edge] if weighted else None))
            dst, msg = torch.cat(dsts), torch.cat(msgs)
            acc0 = torch.full((P * n,), seg.identity_for(prog.combiner, dom),
                              dtype=msg.dtype, device=dev)
            red = {"min": "amin", "max": "amax", "sum": "sum"}[prog.combiner]
            lib_ms = cuda_ms(lambda: acc0.scatter_reduce(
                0, dst, msg, reduce=red, include_self=True), reps)
            del dsts, msgs, dst, msg, acc0, vals, want
            # The queue's rows and values, each receiver's start and offs,
            # the edges read (destination, and weight for add_w) and the
            # (P, max_nv) accumulator written.
            nbytes = 8 * cnt + 16 * P * cnt + 8 * P \
                + 4 * total * (2 if weighted else 1) + 4 * P * n
            log(f"[gas-sharded] K11 over {P} receivers, {label} {what}: "
                f"queue {cnt}, {total} edges (receivers "
                f"{offs[:, -1].tolist()}): bitwise, two calls equal; "
                f"{ms:.4f} ms (plain {plain_ms:.4f}, one scatter_reduce "
                f"{lib_ms:.4f}, bound {bound(nbytes, total)[0]:.4f})")
            if row is None:
                row = (ms, plain_ms, nbytes, total, lib_ms)
        del mid, cands, st, args
    record(kernels, "gas_push_acc[sharded]", "lux_tpu_torch/csrc/gas.cu",
           "lux_tpu/engine/gas_sharded.py:362", 0.0, row[0], row[1], row[2],
           row[3], row[4])
    torch.cuda.empty_cache()

    # -- 5h. end to end -------------------------------------------------------
    totals = dict.fromkeys(_cuda.LAUNCHES, 0)
    totals["gas_push_acc[sharded]"] = 0

    def counted(fn):
        _cuda.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        for name, v in counts.items():
            totals[name] += v
        return out, counts

    finals = {}
    for label, (key, app, mode) in GAS_SHARDED_APPS.items():
        ex = exs[label]
        graph = layouts[key][0]
        (st, iters), counts = counted(lambda: ex.run(**kws[app]))
        vals = ex.gather_values(st)
        ref = gas[app]
        if vals.shape != (graph.nv,) or vals.dtype != ref["oracle"].dtype:
            raise AssertionError(f"sharded {label}: bad output {vals.shape} "
                                 f"{vals.dtype}")
        if not np.array_equal(vals, ref["oracle"]):
            raise AssertionError(
                f"sharded {label}: {int(np.sum(vals != ref['oracle']))} "
                "values differ from phase 5d's")
        if iters != ref["iters"]:
            raise AssertionError(f"sharded {label}: {iters} iterations, "
                                 f"phase 5d {ref['iters']}")
        if app == "bfs" and not np.array_equal(ex.finalize(st)["parent"],
                                               ref["parent"]):
            raise AssertionError(f"sharded {label}: parents differ")
        if app == "sssp_delta":
            viol = count_violations(graph, vals, ex.program)
            if viol:
                raise AssertionError(f"sharded {label}: {viol} violations")
        if app in ("labelprop", "kcore") and ex.exchange_downgrades < 1:
            raise AssertionError(f"sharded {label}: the dense start did not "
                                 "downgrade")
        check_launches(f"sharded {label}", counts, _gas_sharded_expected(ex))
        totals["gas_push_acc[sharded]"] += counts["gas_push_acc"]
        log(f"[gas-sharded] {label}: fixpoint in {iters} iterations "
            f"({ex.push_iters} push, {ex.pull_iters} pull, "
            f"{ex.direction_switches} switches, {ex.exchange_downgrades} "
            f"downgrades) equals phase 5d's single-device run bitwise; "
            f"ledger (direction, count, out-edges, branch) "
            f"{[e[:4] for e in ex.direction_log]}; launches "
            f"{ {k: counts[k] for k in GAS_KERNELS} }")
        finals[label] = vals
        if label == "bfs frontier":
            keep(held, f"gas {label}", values=vals, iters=iters,
                 log=[e[:4] for e in ex.direction_log],
                 down=ex.exchange_downgrades)
    for a, b in (("bfs compact", "bfs full"), ("bfs frontier", "bfs full"),
                 ("sssp_delta frontier", "sssp_delta full")):
        if not np.array_equal(finals[a], finals[b]):
            raise AssertionError(f"sharded {a} differs from {b}")
    del finals
    # 8 lanes against single-root runs of the sharded BFS.
    (st, iters), counts = counted(lambda: mx.run(roots))
    check_launches("sharded multi compact", counts,
                   {"gas_pull_acc": P * iters})
    single = exs["bfs full"]
    longest = 0
    for j, r in enumerate(roots):
        sst, sn = single.run(start=r)
        longest = max(longest, sn)
        if not np.array_equal(mx.values_for(st, j),
                              single.gather_values(sst)):
            raise AssertionError(f"sharded multi-source lane {j} (root {r}) "
                                 "differs from its single-root run")
    if iters != longest:
        raise AssertionError(f"sharded multi-source: {iters} iterations, "
                             f"longest single-root run {longest}")
    log(f"[gas-sharded] multi compact bfs k={K}: {iters} iterations; every "
        f"lane equals its single-root run bitwise; launches K10 "
        f"{counts['gas_pull_acc']} = {P} parts x {iters}")
    keep(held, "gas multi compact", values=mx.gather_values(st), iters=iters,
         roots=roots)
    del st, sst
    # PageRank through the pull adapter: K8 once per part and iteration.
    (st, iters), counts = counted(lambda: pr.run(max_iters=ITERS))
    out = pr.gather_values(st)
    if out.shape != (g.nv,) or not np.all(np.isfinite(out)):
        raise AssertionError(f"sharded gas pagerank: bad output {out.shape}")
    np.testing.assert_allclose(out, pr_oracle, rtol=RTOL, atol=ATOL,
                               err_msg="sharded gas pagerank vs f64 oracle")
    check_launches("sharded gas pagerank", counts,
                   {"gather_segment_sum": P * ITERS})
    log(f"[gas-sharded] pagerank through PullGasAdapter: run({ITERS}) "
        f"matches the f64 oracle (max abs err "
        f"{float(np.max(np.abs(out.astype(np.float64) - pr_oracle))):.3e});"
        f" launches K8 {counts['gather_segment_sum']}")
    del st, out
    torch.cuda.empty_cache()

    # -- 6h. timing -----------------------------------------------------------
    for label, (key, app, mode) in GAS_SHARDED_APPS.items():
        ex = exs[label]
        graph = layouts[key][0]
        kw, mi = kws[app], max_iters[app]
        ex.warmup(**kw)
        secs = [host_seconds(lambda: ex.run(max_iters=mi, **kw))
                for _ in range(3)]
        sec = float(np.median(secs))
        iters = len(ex.direction_log)
        st0 = ex.init_state(**kw)
        iter_sec = float(np.median([host_seconds(
            lambda: ex.run(max_iters=mi, state=st0)) for _ in range(3)]))
        log(f"[time] sharded gas {label}: {iters} iterations "
            f"({ex.push_iters} push/{ex.pull_iters} pull, "
            f"{ex.exchange_downgrades} downgrades) in {sec * 1e3:.3f} ms "
            f"(median of 3: {[round(x * 1e3, 3) for x in secs]}), "
            f"{sec / iters * 1e3:.3f} ms/iteration, "
            f"{graph.ne * iters / sec / 1e9:.3f} GTEPS; run from a device "
            f"state {iter_sec * 1e3:.3f} ms; single-device "
            f"{gas[app]['ms']:.3f} ms (phase 6d)")
        if label == "bfs frontier":
            keep(held, f"gas {label}", ms=sec * 1e3)
        st = ex.init_state(**kw)
        ex.warmup_phases(st)
        split, pull_state = {}, None
        for _ in range(mi):
            before = st
            st, c, times = ex.phase_step(st)
            branch = times.pop("branch")
            times.pop("downgraded")
            split.setdefault(branch, []).append(times)
            if branch.startswith("pull") and pull_state is None:
                pull_state = before
            if c == 0:
                break
        for branch, runs in sorted(split.items()):
            med = {k: float(np.median([r[k] for r in runs])) * 1e3
                   for k in runs[0]}
            log(f"[time] sharded gas {label} {branch} phases (ms, median of "
                f"{len(runs)}; CUDA events): " + ", ".join(
                    f"{k}={v:.3f}" for k, v in med.items()))
        if ex._xch is not None and pull_state is not None:
            stats = ex._frontier_stats(pull_state)
            rows_all = P * ex.sg.max_nv
            # The stacks of values and frontier read once, every
            # receiver's tables of both written once.
            x_bytes = 5 * rows_all + 5 * P * rows_all
            sends = [("compact", lambda: (ex._xch.tables(pull_state.values),
                                          ex._xch.tables(
                                              pull_state.frontier)))]
            if ex._fx is not None and stats.widest <= ex.frontier_cap:
                sends.append(("frontier", lambda: ex._fx.tables(
                    pull_state.values, pull_state.frontier)))
            widest = (f", widest pair {stats.widest} of frontier_cap "
                      f"{ex.frontier_cap}" if ex._fx is not None else "")
            for what, fn in sends:
                x_ms = cuda_ms(fn, reps)
                log(f"[time] sharded gas {label} {what} exchange alone (a "
                    f"pull state of {stats.count} active{widest}): "
                    f"{x_ms:.4f} ms (mean of {reps}, CUDA events) against a "
                    f"bytes bound of {bound(x_bytes, 0)[0]:.4f} ms "
                    f"({x_bytes} B); {ex.exchange_bytes_per_iter()} B per "
                    "iteration priced as interconnect bytes")
        del st, st0, pull_state
    mx.warmup(start=roots[0])
    secs = [host_seconds(lambda: mx.run(roots)) for _ in range(3)]
    sec = float(np.median(secs))
    st0 = mx.init_state(roots)
    x_ms = cuda_ms(lambda: mx._load(st0), reps)
    rows_all = P * mx.sg.max_nv
    x_bytes = 5 * K * rows_all * (P + 1)
    keep(held, "gas multi compact", ms=sec * 1e3)
    log(f"[time] sharded gas multi compact bfs k={K}: {mx.pull_iters} "
        f"iterations in {sec * 1e3:.3f} ms (median of 3: "
        f"{[round(x * 1e3, 3) for x in secs]}), "
        f"{sec / mx.pull_iters * 1e3:.3f} ms/iteration, "
        f"{g.ne * mx.pull_iters / sec / 1e9:.3f} GTEPS ({K} lanes each); "
        f"its K-lane compact exchange alone {x_ms:.4f} ms (mean of {reps}) "
        f"against a bytes bound of {bound(x_bytes, 0)[0]:.4f} ms "
        f"({x_bytes} B); {mx.exchange_bytes_per_iter()} B per iteration "
        "priced as interconnect bytes")
    del st0
    pr.warmup()
    secs = [host_seconds(lambda: pr.run(max_iters=ITERS)) for _ in range(3)]
    sec = float(np.median(secs))
    log(f"[time] sharded gas pagerank (PullGasAdapter, {pr.exchange_mode}): "
        f"{sec / ITERS * 1e3:.3f} ms/iteration (median of 3 run({ITERS}): "
        f"{[round(x * 1e3, 3) for x in secs]}), "
        f"{g.ne * ITERS / sec / 1e9:.3f} GTEPS")
    # Group 2r: the compact BFS executor's step traced at this scale, its
    # push branch (K6 per part with a frontier, K11 once when the queue
    # has out-edges) and its compact pull (K10 per part) as alternatives.
    ex = exs["bfs compact"]
    st = ex._frontier_stats(ex.init_state(start=0))
    want = {"gas_pull_acc": P}
    if st.count:
        want["frontier_queue"] = sum(1 for c in st.counts if c)
        if st.recv_edges:
            want["gas_push_acc"] = 1
    _add(totals, _trace_scale("bfs@gas_sharded+compact (phase 3h)", ex,
                              {"start": 0}, want))
    del exs, mx, pr, sgw, layouts, ex
    log(f"[gas-sharded] peak device memory of phases 3h-6h "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phases "
        f"3h-6h took {time.perf_counter() - t_phase:.1f} s")
    return totals


def _tiled_sharded_phases(g, plan, pr_oracle, dev, kernels, held) -> dict:
    """Phases 3g-6g on the sharded tiled engine: PageRank on ``g`` over
    ``SHARDED_PARTS`` parts of a ``LocalMesh`` on the card, built on
    phase 3's ``plan``, in the full and compact exchange modes. Returns
    the launch counts of the phase 5g runs under ``strip_spmv[sharded]``
    and ``tail_gather_sum[sharded]``, and leaves the full mode's
    ``run(10)`` values and ms per iteration in
    ``held["sharded tiled"]``."""
    import torch

    from lux_tpu_torch.engine.tiled_sharded import ShardedTiledExecutor
    from lux_tpu_torch.models.pagerank import PageRank
    from lux_tpu_torch.ops import _cuda
    from lux_tpu_torch.ops.tiled_spmv import (
        strip_level_spmv,
        strip_level_spmv_plain,
    )
    from lux_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    P = SHARDED_PARTS
    mesh = make_mesh(P, dev)
    flag = os.environ.get("LUX_EXCHANGE")
    reps = 10

    # -- 3g. the partition and both executors -------------------------------
    exs = {}
    for mode in ("full", "compact"):
        os.environ["LUX_EXCHANGE"] = mode
        t = time.perf_counter()
        ex = ShardedTiledExecutor(g, PageRank(), mesh=mesh, plan=plan)
        torch.cuda.synchronize()
        log(f"[tiled-sharded] LUX_EXCHANGE={mode} resolves to "
            f"{ex.exchange_mode}; executor built in "
            f"{time.perf_counter() - t:.1f} s; exchange_bytes_per_iter "
            f"{ex.exchange_bytes_per_iter()}")
        exs[mode] = ex
    if flag is None:
        del os.environ["LUX_EXCHANGE"]
    else:
        os.environ["LUX_EXCHANGE"] = flag
    _save_xplan("tiled_pagerank_compact", "tiled_sharded", exs["compact"])
    ex = exs["full"]
    parts = ex._parts
    strips = [[lev.n_cells for lev in p.levels] for p in parts]
    bands = [[(lev.row0, lev.nrows) for lev in p.levels] for p in parts]
    log(f"[tiled-sharded] P={P} nvb={plan.nvb} max_nvb={ex.part.max_nvb} "
        f"max_nv={ex.max_nv} ({P * ex.max_nv / g.nv:.3f} x nv padded rows); "
        f"blocks per part {[len(b) for b in ex.part.blocks]}; cells per "
        f"part and level {strips}, their bands of rows (first, count) "
        f"{bands}; tail edges per part "
        f"{[int(p.tail_row_ptr[-1]) for p in parts]}; remote rows read "
        f"{ex._remote_read_counts.tolist()}")

    # -- 4g. K1 and K2 at one part's shapes ---------------------------------
    q = 0
    part = parts[q]
    rng = np.random.default_rng(SEED + 7)
    nvb = plan.nvb
    x_float = torch.from_numpy(
        rng.random((nvb, 128), dtype=np.float32) + np.float32(0.5)).to(dev)
    x_int = torch.from_numpy(
        rng.integers(0, 4, size=(nvb, 128)).astype(np.float32)).to(dev)
    err = 0.0
    for lev in part.levels:
        for x, exact in ((x_int, True), (x_float, False)):
            got = strip_level_spmv(x, lev)
            want = strip_level_spmv_plain(x, lev)
            if exact:
                check_equal(f"K1 part {q} r={lev.r} integral", got, want)
            else:
                err = max(err, check_close(f"K1 part {q} r={lev.r}", got,
                                           want))
    runs = []
    for hlev in plan.levels:
        n = hlev.rows.shape[0]
        cmax = -(-n // P)
        runs.append((min(q * cmax, n), min((q + 1) * cmax, n)))
    k1 = _k1_yardsticks(plan.levels, part.levels, x_float, nvb, reps,
                        f" part {q}", runs)
    record(kernels, "strip_spmv[sharded]", "lux_tpu_torch/csrc/strip_spmv.cu",
           "lux_tpu/engine/tiled_sharded.py:539", err, *k1)
    # K2 on part 0 (the hub rows' blocks) and on the last part, over the
    # exchanged (nvb, 128) table, adding into the part's strip sums.
    k2 = _k2_check(f"K2 part {q}", part.tail_src, part.tail_row_ptr,
                   nvb * 128, rng, reps, dev)
    record(kernels, "tail_gather_sum[sharded]",
           "lux_tpu_torch/csrc/segment_sum.cu",
           "lux_tpu/engine/tiled_sharded.py:568", *k2)
    last = parts[-1]
    _k2_check(f"K2 part {P - 1}", last.tail_src, last.tail_row_ptr,
              nvb * 128, rng, reps, dev)
    m = int(part.tail_row_ptr[-1])
    log(f"[tiled-sharded] part {q}: K1 over {strips[q]} cells into "
        f"{bands[q]} rows, K2 over {m} tail edges into {ex.max_nv} rows")
    del x_float, x_int

    # -- 5g. end to end, both modes -------------------------------------------
    k1_per_iter = sum(1 for p in parts for lev in p.levels
                      if lev.items.n_items > 0)
    k2_per_iter = len(parts)
    totals = {"strip_spmv[sharded]": 0, "tail_gather_sum[sharded]": 0}
    outs = {}
    for mode, ex in exs.items():
        _cuda.reset_launches()
        out = ex.run(ITERS)
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        got = ex.gather_values(out)
        if got.shape != pr_oracle.shape or not np.all(np.isfinite(got)):
            raise AssertionError(f"sharded tiled {mode}: bad output "
                                 f"{got.shape}")
        np.testing.assert_allclose(got, pr_oracle, rtol=RTOL, atol=ATOL,
                                   err_msg=f"sharded tiled {mode}")
        err = float(np.max(np.abs(got.astype(np.float64) - pr_oracle)))
        check_launches(f"sharded tiled {mode}", counts, {
            "strip_spmv": k1_per_iter * ITERS,
            "tail_gather_sum": k2_per_iter * ITERS})
        log(f"[tiled-sharded] {mode} (resolved {ex.exchange_mode}): "
            f"run({ITERS}) matches the f64 oracle (max abs err {err:.3e}); "
            f"launches K1 {counts['strip_spmv']} = {k1_per_iter} part-levels"
            f" x {ITERS}, K2 {counts['tail_gather_sum']} = {k2_per_iter} "
            f"parts x {ITERS}")
        totals["strip_spmv[sharded]"] += counts["strip_spmv"]
        totals["tail_gather_sum[sharded]"] += counts["tail_gather_sum"]
        outs[mode] = out
        if mode == "full":
            held["sharded tiled"] = {"values": got}
            keep(held, "tiled pagerank full", values=got)
    check_equal("sharded tiled compact vs full", outs["compact"],
                outs["full"])
    log("[tiled-sharded] compact equals full bitwise"
        + ("" if exs["compact"].exchange_mode == "compact" else
           " (compact resolved to full at this size: the same exchange)"))
    del outs

    # -- 6g. timing ---------------------------------------------------------
    for mode, ex in exs.items():
        ex.warmup()
        vals = ex.init_values()
        secs = [host_seconds(lambda: ex.run(ITERS, vals=vals))
                for _ in range(3)]
        sec = float(np.median(secs))
        ev_ms = cuda_ms(lambda: ex.run(ITERS, vals=vals), 3) / ITERS
        if mode == "full":
            held["sharded tiled"]["ms"] = ev_ms
            keep(held, "tiled pagerank full", ms=sec / ITERS * 1e3)
        runs = [ex.phase_step(vals)[1] for _ in range(5)]
        split = {k: float(np.median([r[k] for r in runs])) * 1e3
                 for k in runs[0]}
        log(f"[time] sharded tiled {mode}: {sec / ITERS * 1e3:.3f} "
            f"ms/iteration, {g.ne * ITERS / sec / 1e9:.3f} GTEPS (host "
            f"clock, median of 3 runs of {ITERS}: "
            f"{[round(x * 1e3, 3) for x in secs]} ms); {ev_ms:.3f} "
            "ms/iteration by CUDA events (mean of 3); phase_step split (ms, "
            "median of 5): " + ", ".join(f"{k}={v:.3f}"
                                          for k, v in split.items()))
        busy = device_busy(lambda: ex.run(ITERS, vals=vals))
        if busy is None:
            log(f"[time] sharded tiled {mode}: device busy share not "
                "measured (the profiler saw no kernels)")
        else:
            busy_ms, top = busy
            log(f"[time] sharded tiled {mode}: device busy {busy_ms:.3f} ms "
                f"of {sec * 1e3:.3f} ms ({busy_ms / (sec * 1e3):.1%}; "
                "torch.profiler); top kernels (ms): "
                + ", ".join(f"{n}={v:.3f}" for n, v in top))
        # The exchange alone: full reads nvb rows of the stacked values at
        # block_map and writes the (nvb, 128) operand; compact also reads
        # the whole stack and writes one operand per part.
        x_ms = cuda_ms(lambda: ex._exchange(vals), reps)
        ops = ex._exchange(vals)
        x_bytes = (2 * nvb * 512 if ex._xch is None
                   else vals.numel() * 4 + ops.numel() * 4)
        # The strip merge alone: the four full-height partials in
        # owner-stacked order, and the reduce_scatter.
        partials = ex._partials(ops)
        merge_ms = cuda_ms(lambda: ex._merge(partials), reps)
        merge_bytes = partials.numel() * 4 + vals.numel() * 4
        log(f"[time] sharded tiled {mode} exchange ({ex.exchange_mode}): "
            f"{x_ms:.4f} ms (mean of {reps}) against a bytes bound of "
            f"{bound(x_bytes, 0)[0]:.4f} ms ({x_bytes} B); strip merge "
            f"(stack_map + reduce_scatter) {merge_ms:.4f} ms against "
            f"{bound(merge_bytes, 0)[0]:.4f} ms; "
            f"{ex.exchange_bytes_per_iter()} B per iteration priced as "
            "interconnect bytes")
        del vals, ops, partials
    del exs, ex, parts, part
    log(f"[tiled-sharded] peak device memory of phases 3g-6g "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phases 3g-6g "
        f"took {time.perf_counter() - t_phase:.1f} s")
    return totals


# Launches of each probe kernel when the three probes run: one warm-up
# and 10 timed calls per probe line (P2: 3 lane and 4 row lines, the rows
# of 512 and more through the strip kernel; P3, P4, P5, its int8 form and
# P6 one line each), and P7's tiny case plus three lines of 11.
PROBE_LAUNCHES = {
    "block_take[axis=1 int32]": 4 * 11, "block_take[axis=1 int8]": 11,
    "block_take[axis=0 int32]": 2 * 11, "block_take[axis=0 int8]": 11,
    "block_take_strip[axis=0 int32]": 3 * 11,
    "merge4": 11, "level_apply": 1 + 3 * 11,
}
# PR 15's times of the block_take lines (PERF.md), NVIDIA H100 80GB HBM3 at
# 700 W: P2's largest line on the row kernel, and P3, P4, P5 and P5's
# int8 form, which keep it.
P2_WAS_MS = 0.304
TAKE_WAS_MS = {"axis=1 int32": 0.136, "axis=1 int8": 0.108,
               "axis=0 int32": 0.139, "axis=0 int8": 0.112}


def _probe_phases(dev, kernels) -> dict:
    """Phase 4g on the gather probes P2-P7: each probe's entry point as a
    user runs it (its launches are the main path's), then ``block_take``
    in its four forms, ``merge4`` and P7's K3 launch bitwise against
    their plain versions at the probes' full shapes, timed. Returns the
    probe run's launch counts under the ``kernels`` line's names."""
    import torch

    from lux_tpu_torch.ops import _cuda
    from lux_tpu_torch.probes import dgather, dgather2, merge_kernel
    from lux_tpu_torch.probes import gather as pg

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    for probe in (dgather, dgather2, merge_kernel):
        log(f"[probe] python -m {probe.__name__}")
        probe.main([])
    torch.cuda.synchronize()
    counts = dict(_cuda.LAUNCHES)
    check_launches("probes", counts, PROBE_LAUNCHES)
    totals = {k: counts[k] for k in PROBE_LAUNCHES if k != "level_apply"}
    totals["level_apply[probe P7]"] = counts["level_apply"]

    reps = 10
    rng = np.random.default_rng(SEED + 9)
    put = lambda a: torch.from_numpy(a).to(dev)

    def needed(mask_shape, index, dim):
        """Distinct elements the gather reads: ones scattered into a
        mask by the (int64) index along ``dim``."""
        mask = torch.zeros(mask_shape, dtype=torch.bool, device=dev)
        mask.scatter_(dim, index, True)
        return int(mask.sum())

    rows = dgather2.S * dgather2.NB
    x = put(rng.standard_normal((rows, 128), dtype=np.float32))
    forms = (("axis=1 int32", 1, dgather2.S, 128, np.int32,
              "tools/probe_dgather2.py:62"),
             ("axis=1 int8", 1, dgather2.S, 128, np.int8,
              "tools/probe_dgather2.py:91"),
             ("axis=0 int32", 0, 8, 8, np.int32,
              "tools/probe_dgather2.py:110"),
             ("axis=0 int8", 0, 8, 8, np.int8,
              "tools/probe_dgather2.py:110"))
    for label, axis, block, hi, itype, replaces in forms:
        idx = put(rng.integers(0, hi, (rows, 128)).astype(itype))
        got = pg.block_take(x, idx, axis, block)
        check_equal(f"block_take[{label}]", got,
                    pg.block_take_plain(x, idx, axis, block))
        ms = cuda_ms(lambda: pg.block_take(x, idx, axis, block), reps)
        plain = cuda_ms(lambda: pg.block_take_plain(x, idx, axis, block),
                        reps)
        idx64 = idx.long()
        if axis == 1:
            lib = cuda_ms(lambda: torch.gather(x, 1, idx64), reps)
            reads = needed((rows, 128), idx64, 1)
        else:
            shape = (rows // block, block, 128)
            xv, iv = x.view(shape), idx64.view(shape)
            lib = cuda_ms(lambda: torch.gather(xv, 1, iv), reps)
            reads = needed(shape, iv, 1)
        nbytes = 4 * reads + idx.numel() * idx.element_size() + 4 * x.numel()
        log(f"[probe] block_take[{label}] at ({rows}, 128), blocks of "
            f"{block} rows: bitwise; {reads} distinct elements of x read; "
            f"{ms:.4f} ms (PR 15: {TAKE_WAS_MS[label]:.3f})")
        record(kernels, f"block_take[{label}]",
               "lux_tpu_torch/csrc/probe_gather.cu", replaces, 0.0, ms,
               plain, nbytes, 0, lib)
        del idx, idx64, got
    del x

    # P2's axis-0 lines at the probe's shapes, drawn on the card, each
    # bitwise and timed; the kernels line takes the strip kernel at the
    # largest, (8192, 128) blocks x 32.
    gen = torch.Generator(dev)
    gen.manual_seed(SEED + 2)
    for S, width, axis, reps2 in dgather.SHAPES:
        if axis != 0:
            continue
        x = torch.randn((reps2 * S, width), generator=gen, device=dev)
        idx = torch.randint(0, S, (reps2 * S, width), generator=gen,
                            device=dev, dtype=torch.int32)
        plan = pg.strip_plan(S, width, idx.dtype)
        name = pg.take_kernel(0, idx.dtype, strip=plan is not None)
        line = f"P2 ({S}, {width}) x {reps2} axis=0"
        check_equal(f"block_take[{line}]", pg.block_take(x, idx, 0, S),
                    pg.block_take_plain(x, idx, 0, S))
        ms = cuda_ms(lambda: pg.block_take(x, idx, 0, S), reps)
        plain = cuda_ms(lambda: pg.block_take_plain(x, idx, 0, S), reps)
        shape = (reps2, S, width)
        xv, iv = x.view(shape), idx.long().view(shape)
        lib = cuda_ms(lambda: torch.gather(xv, 1, iv), reps)
        reads = needed(shape, iv, 1)
        nbytes = 4 * reads + 4 * idx.numel() + 4 * x.numel()
        b_ms = bound(nbytes, 0)[0]
        was = (f"; the row kernel's {P2_WAS_MS:.3f} ms before the strip "
               "kernel (PR 15)" if S == 8192 else "")
        log(f"[probe] {line}: {name}"
            + (f" (strips of {plan[0]} floats, {plan[1]} rows in shared "
               "memory)" if plan else "")
            + f", bitwise; {ms:.4f} ms against a bound of {b_ms:.4f} ms "
            f"({reads} distinct elements read), {100 * b_ms / ms:.0f}% of "
            f"it; plain {plain:.4f} ms, torch.gather {lib:.4f} ms{was}")
        if S == 8192:
            record(kernels, name, "lux_tpu_torch/csrc/probe_gather.cu",
                   "tools/probe_dgather.py:30", 0.0, ms, plain, nbytes, 0,
                   lib)
        del x, idx, xv, iv

    r = dgather2.R
    cand = put(rng.standard_normal((r, 4, 128), dtype=np.float32))
    lane = put(rng.integers(0, 128, (r, 128), dtype=np.int32))
    sel = put(rng.integers(0, 4, (r, 128), dtype=np.int32))
    got = pg.merge4(cand, lane, sel)
    check_equal("merge4", got, pg.merge4_plain(cand, lane, sel))
    check_equal("merge4 twice", pg.merge4(cand, lane, sel), got)
    del got
    ms = cuda_ms(lambda: pg.merge4(cand, lane, sel), reps)
    plain = cuda_ms(lambda: pg.merge4_plain(cand, lane, sel), reps)
    flat = cand.view(r, 512)
    gidx = sel.long() * 128 + lane.long()
    lib = cuda_ms(lambda: torch.gather(flat, 1, gidx), reps)
    med = {hold: (pg.median_ms(lambda: pg.merge4(cand, lane, sel), dev,
                               hold=hold),
                  pg.median_ms(lambda: torch.gather(flat, 1, gidx), dev,
                               hold=hold))
           for hold in (False, True)}
    reads = needed((r, 512), gidx, 1)
    # l, s and out, then cand three ways: its distinct elements (the
    # table's bound), the 32-byte sectors the picks touch, all of it.
    io = 8 * lane.numel() + 4 * lane.numel()
    sectors = needed((r, 64), gidx // 8, 1)
    floors = {"distinct elements": 4 * reads + io,
              "touched sectors": 32 * sectors + io,
              "all of cand streamed": 4 * cand.numel() + io}
    log(f"[probe] merge4 at R={r}: bitwise, two calls equal; mean of "
        f"{reps} {ms:.4f} ms (was {MERGE4_WAS_MS:.3f} before the "
        f"redesign), torch.gather {lib:.4f} ms; medians of 100 with the "
        f"enqueue: merge4 {med[False][0]:.4f} ms, torch.gather "
        f"{med[False][1]:.4f} ms; medians of 100 on a held card: merge4 "
        f"{med[True][0]:.4f} ms, torch.gather {med[True][1]:.4f} ms; bytes "
        f"floors: "
        + ", ".join(f"{k} {bound(b, 0)[0]:.4f} ms ({b} B)"
                    for k, b in floors.items()))
    record(kernels, "merge4", "lux_tpu_torch/csrc/probe_gather.cu",
           "tools/probe_dgather2.py:138", 0.0, ms, plain,
           floors["distinct elements"], 0, lib)
    del cand, lane, sel, flat, gidx

    g_n = merge_kernel.G_RATE
    r_in = 8 * g_n + 8
    stream = put(rng.standard_normal((r_in, 128), dtype=np.float32))
    aoff = put(rng.integers(0, r_in // 8 - 1, g_n).astype(np.int32))
    boff = put(rng.integers(0, r_in // 8 - 1, g_n).astype(np.int32))
    idx = put(rng.integers(-128, 128, (16 * g_n, 128)).astype(np.int8))
    check_equal("merge_level (P7 on K3)",
                pg.merge_level(stream, aoff, boff, idx),
                pg.merge_level_plain(stream, aoff, boff, idx))
    ms = cuda_ms(lambda: pg.merge_level(stream, aoff, boff, idx), reps)
    plain = cuda_ms(lambda: pg.merge_level_plain(stream, aoff, boff, idx),
                    reps)
    v = idx.long()
    src = torch.where(v >= 0, pg.expand_offsets(aoff).long()[:, None],
                      pg.expand_offsets(boff).long()[:, None]) * 128 \
        + (v & 127)
    reads = needed((r_in * 128,), src.view(-1), 0)
    record(kernels, "level_apply[probe P7]",
           "lux_tpu_torch/csrc/level_apply.cu",
           "tools/probe_merge_kernel.py:45", 0.0, ms, plain,
           4 * reads + 8 * g_n + idx.numel() + 4 * idx.numel(), 0, None)
    del stream, aoff, boff, idx, v, src
    log(f"[probe] peak device memory of phase 4g "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; it took "
        f"{time.perf_counter() - t_phase:.1f} s; launches {totals}")
    return totals

PROGRAMS_GROUP = "2p program contracts"
GAS_FIXTURES = (("lux601_bad_identity", "LUX601"),
                ("lux602_inexact_sum", "LUX602"),
                ("lux603_push_pull_skew", "LUX603"),
                ("lux604_nonmonotone_incremental", "LUX604"),
                ("lux605_clobbering_apply", "LUX605"),
                ("lux606_overclaimed_frontier", "LUX606"))


def _programs_cli(work):
    """Start ``python -m lux_tpu_torch.tools.luxlint --programs
    --gascap-out <work>/gascap.json`` on the card, as a user runs it;
    group 2p collects it (it runs beside the graph's generation)."""
    work.mkdir(parents=True, exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if k not in ("LUX_PLATFORM", "LUX_GASCAP_DIR")}
    return subprocess.Popen(
        [sys.executable, "-m", "lux_tpu_torch.tools.luxlint", "--programs",
         "--gascap-out", str(work / "gascap.json")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def _program_phases(work, lint, dev) -> None:
    """Group 2p, the program-contract tier (``analysis/gasck.py``) with
    the program hooks on the card: ``lint``, the ``luxlint --programs``
    run of :func:`_programs_cli` (rc 0, 0 findings over the 8 registry
    programs, the written artifact's id the committed
    ``lux_tpu_torch/analysis/gascap.json``'s); each seeded fixture of
    ``tests/torch_gas_fixtures/`` fires exactly its rule; the incremental
    gate admits an SSSP that does not declare ``incremental_ok`` and
    refuses the over-claiming ``DriftingMin`` and ``Claimant`` with a
    ``ProgramContractError`` naming LUX604 and its sub-check."""
    import importlib.util

    import torch

    from lux_tpu_torch.analysis import gasck
    from lux_tpu_torch.engine.incremental import require_incremental
    from lux_tpu_torch.engine.program import ProgramContractError
    from lux_tpu_torch.models import SSSP, ConnectedComponents
    from lux_tpu_torch.ops.segment import U32_MASK

    out = work / "gascap.json"
    t0 = time.perf_counter()
    stdout, stderr = lint.communicate(timeout=300)
    wait_s = time.perf_counter() - t0
    lines = [ln for ln in stdout.splitlines() if ln.startswith("LUXLINT ")]
    summary = json.loads(lines[-1][len("LUXLINT "):]) if lines else {}
    if (lint.returncode != 0 or summary.get("findings") != 0
            or summary.get("files") != 8):
        raise AssertionError(f"luxlint --programs: rc {lint.returncode}, "
                             f"{summary}\n{stdout[-2000:]}{stderr[-2000:]}")
    committed = gasck.load_capmap(
        str(Path(gasck.__file__).with_name(gasck.CAP_FILENAME)))
    art = gasck.load_capmap(str(out))
    if art["id"] != committed["id"]:
        raise AssertionError(f"luxlint --programs on the card wrote "
                             f"{art['id']}, the committed artifact is "
                             f"{committed['id']}")
    log(f"[programs] python -m lux_tpu_torch.tools.luxlint --programs "
        f"--gascap-out on the card, beside the graph's generation: rc 0, "
        f"{summary['files']} programs, 0 findings, the tier "
        f"{summary['elapsed_s']} s (waited {wait_s:.1f} s for the CLI); "
        f"artifact {art['id']} = the committed one")

    t0 = time.perf_counter()
    fixtures = Path(__file__).resolve().parent / "tests" / \
        "torch_gas_fixtures"
    for stem, rule in GAS_FIXTURES:
        rep = gasck.verify_fixture_paths([str(fixtures / f"{stem}.py")],
                                         device=dev)
        rules = sorted({f.rule for f in rep.findings})
        if rules != [rule] or rep.errors:
            raise AssertionError(f"{stem}: fired {rules}, errors "
                                 f"{rep.errors}; expected exactly {rule}")
    fix_s = time.perf_counter() - t0

    class Quiet(SSSP):
        incremental_ok = False

    class Claimant(ConnectedComponents):
        name = "claimant"

        def relax(self, src_vals, weights):
            return (src_vals + 1) & U32_MASK

    spec = importlib.util.spec_from_file_location(
        "_smoke_lux604", fixtures / "lux604_nonmonotone_incremental.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    t0 = time.perf_counter()
    require_incremental(Quiet(), dev)
    for prog in (mod.DriftingMin(), Claimant()):
        try:
            require_incremental(prog, dev)
        except ProgramContractError as e:
            if "LUX604" not in str(e) or "not inflationary" not in str(e):
                raise AssertionError(f"{prog.name}: refused as {e}") from e
            log(f"[programs] gate refuses {prog.name}: {e}")
        else:
            raise AssertionError(f"{prog.name}: the incremental gate "
                                 "admitted a program whose LUX604 proof "
                                 "fails")
    torch.cuda.synchronize()
    log(f"[programs] the six fixtures fire exactly their rules, hooks on "
        f"{dev} ({fix_s:.2f} s); the gate admits an SSSP that does not "
        f"declare incremental_ok and refuses DriftingMin and Claimant "
        f"(three proofs {time.perf_counter() - t0:.2f} s)")


# -- 2q: the static tiers, their artifacts and HostTransferGuard -------------

LINT_GROUP = "2q static tiers"
LINT_TIERS = {"ast": (), "threads": ("--threads",)}
GUARD_STEPS = 10


def _luxlint_json(proc, label):
    """(summary, document) of a finished ``luxlint --json`` run."""
    out, err = proc.communicate(timeout=600)
    if "LUXLINT " not in out:
        raise AssertionError(f"{label}: rc {proc.returncode}, no summary\n"
                             f"{out[-2000:]}{err[-2000:]}")
    doc = json.loads(out[:out.rindex("LUXLINT ")])
    return doc["summary"], doc, err


def _lint_clis():
    """Start the port's static tiers as a user runs them, on the card's
    host: ``python -m lux_tpu_torch.tools.luxlint`` (the AST tier over
    ``lux_tpu_torch`` and ``chip_smoke.py``) and ``--threads``; group 2q
    collects them (they run beside the graph's generation). The exchange
    tier, which now traces steps too, is group 2r's."""
    env = {k: v for k, v in os.environ.items() if k != "LUX_PLATFORM"}
    return {name: (time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "lux_tpu_torch.tools.luxlint", "--json",
         *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env)) for name, args in LINT_TIERS.items()}


def _lint_phases(procs) -> None:
    """Group 2q's CLIs: each rc 0 with 0 findings and 0 errors, its
    suppressions counted per rule."""
    from collections import Counter

    for name, (t0, proc) in procs.items():
        t = time.perf_counter()
        summary, doc, err = _luxlint_json(proc, f"luxlint {name}")
        waited = time.perf_counter() - t
        if (proc.returncode != 0 or summary["findings"]
                or summary["errors"] or not summary["ok"]):
            raise AssertionError(f"luxlint {name}: rc {proc.returncode}, "
                                 f"{summary}\n{err[-2000:]}")
        per_rule = dict(sorted(Counter(
            f["rule"] for f in doc["suppressed"]).items()))
        if summary["files"] < 90:
            raise AssertionError(f"luxlint {name}: {summary}")
        log(f"[lint] {name}: rc 0, {summary['files']} files, 0 findings, "
            f"suppressed {summary['suppressed']} {per_rule}, schema "
            f"{summary['schema']}, the tier {summary['elapsed_s']} s "
            f"(waited {waited:.1f} s for the CLI, "
            f"{time.perf_counter() - t0:.1f} s since its start)")


def _plan_artifact(gplan, gt, x, dev):
    """Phase 3's grouped-tail plan, the one the grouped executor was
    built from: saved with ``save_grouped_plan``, loaded back (mmap),
    uploaded with ``DeviceGroupedTail.build``; the grouped tail (K3 per
    level, K4) from the reloaded plan bitwise equal to the executor's own
    on ``x``. A copy with one code of level 0 flipped negative is made
    beside it, and ``luxlint --plans --json`` is started over both in
    the background; :func:`_plan_lint` collects it. Returns what it
    needs."""
    import torch

    from lux_tpu_torch.ops import _cuda
    from lux_tpu_torch.ops.merge_tail_kernel import (DeviceGroupedTail,
                                                     grouped_tail_sums)
    from lux_tpu_torch.ops.merge_tail_plan import (load_grouped_plan,
                                                   save_grouped_plan)

    root = _cuda.BUILD_DIR / "gplan"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    good, bad = root / "plan", root / "flipped"
    t = time.perf_counter()
    save_grouped_plan(str(good), gplan)
    save_s = time.perf_counter() - t
    nbytes = sum(f.stat().st_size for f in good.iterdir())
    # The copy: codes.npy copied and one code flipped, the rest linked.
    bad.mkdir()
    for f in good.iterdir():
        if f.name == "codes.npy":
            shutil.copyfile(f, bad / f.name)
        else:
            os.link(f, bad / f.name)
    codes = np.load(bad / "codes.npy", mmap_mode="r+")
    r0 = int(gplan.level_ptr[1])
    row = int(np.argmax(np.asarray(gplan.nvalid[:r0]) > 0))
    codes[row, 0] = -1 - int(codes[row, 0])
    codes.flush()
    del codes
    env = {k: v for k, v in os.environ.items() if k != "LUX_PLATFORM"}
    lint = (time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "lux_tpu_torch.tools.luxlint", "--plans",
         "--json", str(good), str(bad)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env))
    t = time.perf_counter()
    back = load_grouped_plan(str(good), mmap=True)
    load_s = time.perf_counter() - t
    t = time.perf_counter()
    gt_back = DeviceGroupedTail.build(back, dev)
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t
    got = grouped_tail_sums(x, gt_back)
    want = grouped_tail_sums(x, gt)
    if not torch.equal(got, want):
        raise AssertionError("the reloaded grouped plan's tail differs from "
                             "the executor's")
    rows = int(gplan.arow.shape[0])
    log(f"[lint] phase 3's grouped plan ({gplan.n_levels} merge levels, "
        f"{rows} stream rows, {gplan.n_edges} reals): saved in "
        f"{save_s:.1f} s ({nbytes} B), loaded back by mmap in "
        f"{load_s:.2f} s, uploaded in {up_s:.2f} s; its grouped tail (K3 "
        f"x {gt_back.n_levels + 1} levels, K4) equals the executor's "
        f"bitwise; luxlint --plans started on it and on a copy with code "
        f"[{row}, 0] of level 0 flipped")
    del gt_back, back, got, want
    return {"root": root, "good": str(good), "bad": str(bad),
            "lint": lint, "bytes": nbytes}


def _plan_lint(art) -> None:
    """Collect :func:`_plan_artifact`'s ``luxlint --plans``: rc 1, the
    saved plan 0 findings, the flipped copy only LUX203 (the code-plane
    rule it breaks); then remove the directory."""
    t0, proc = art["lint"]
    t = time.perf_counter()
    summary, doc, err = _luxlint_json(proc, "luxlint --plans")
    waited = time.perf_counter() - t
    by_path = {}
    for f in doc["findings"]:
        by_path.setdefault(f["path"], set()).add(f["rule"])
    if (proc.returncode != 1 or summary["errors"]
            or set(by_path) != {art["bad"]}
            or by_path[art["bad"]] != {"LUX203"}):
        raise AssertionError(f"luxlint --plans: rc {proc.returncode}, "
                             f"{summary}, {by_path}\n{err[-2000:]}")
    log(f"[lint] luxlint --plans on the scale's grouped plan "
        f"({art['bytes']} B) and its flipped copy: rc 1; the plan 0 "
        f"findings, the copy {summary['findings']} LUX203 finding(s); "
        f"the tier {summary['elapsed_s']} s for both (waited {waited:.1f} "
        f"s for the CLI, {time.perf_counter() - t0:.1f} s since its "
        f"start, beside the phases that followed)")
    shutil.rmtree(art["root"], ignore_errors=True)


def _save_xplan(label: str, kind: str, ex) -> None:
    """Save ``ex``'s compact exchange plan with ``save_exchange_artifact``
    (remote-read counts, row bytes, ledger) under the build directory's
    ``xplans/<label>``, for :func:`_exchange_artifacts`."""
    from lux_tpu_torch.analysis.ir import _plan_evidence
    from lux_tpu_torch.graph.partition import save_exchange_artifact
    from lux_tpu_torch.ops import _cuda

    plan = ex._xplan
    if plan is None:
        raise AssertionError(f"{label}: no compact plan to save")
    ev = _plan_evidence(kind, ex, plan)
    save_exchange_artifact(plan, str(_cuda.BUILD_DIR / "xplans" / label),
                           remote_read_counts=ev["remote_read_counts"],
                           row_bytes=ev["row_bytes"], ledger=ev["ledger"])


def _exchange_artifacts() -> None:
    """The compact plans of phases 3e, 3g and 3h, saved by
    :func:`_save_xplan`, through ``luxlint --exchange --json`` with a
    copy of 3e's whose first real ``recv_pos`` is misrouted: the saved
    plans 0 findings, the copy only LUX402 (rc 1); then remove them."""
    from lux_tpu_torch.ops import _cuda

    root = _cuda.BUILD_DIR / "xplans"
    dirs = sorted(str(d) for d in root.iterdir())
    if len(dirs) != 3:
        raise AssertionError(f"exchange artifacts: {dirs}")
    src = root / "pull_pagerank_compact"
    bad = root / "misrouted"
    shutil.copytree(src, bad)
    meta = json.loads((bad / "meta.json").read_text())
    counts = np.load(bad / "counts.npy")
    recv = np.load(bad / "recv_pos.npy")
    cap = int(meta["capacity"])
    q, p = (int(v) for v in np.argwhere(
        (counts > 0) & ~np.eye(counts.shape[0], dtype=bool))[0])
    recv[q, p * cap] += 1
    np.save(bad / "recv_pos.npy", recv)
    nbytes = sum(f.stat().st_size for d in dirs for f in Path(d).iterdir())
    t = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "lux_tpu_torch.tools.luxlint", "--exchange",
         "--json", *dirs, str(bad)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    summary, doc, err = _luxlint_json(proc, "luxlint --exchange DIRS")
    by_path = {}
    for f in doc["findings"]:
        by_path.setdefault(f["path"], set()).add(f["rule"])
    if (proc.returncode != 1 or summary["errors"] or summary["files"] != 4
            or by_path != {str(bad): {"LUX402"}}):
        raise AssertionError(f"luxlint --exchange DIRS: rc "
                             f"{proc.returncode}, {summary}, {by_path}\n"
                             f"{err[-2000:]}")
    log(f"[lint] exchange artifacts of phases 3e (pull PageRank), 3g "
        f"(tiled) and 3h (GAS BFS), compact over {SHARDED_PARTS} parts "
        f"({nbytes} B): luxlint --exchange 0 findings on each, and LUX402 "
        f"only on the copy with recv_pos[{q}, sender {p}, slot 0] "
        f"misrouted (rc 1); the tier {summary['elapsed_s']} s, the CLI "
        f"{time.perf_counter() - t:.1f} s")
    shutil.rmtree(root)


def _guard_tiled(ex, want, nlev: int) -> None:
    """``GUARD_STEPS`` steps of phase 5's tiled executor (K1, K2) under
    ``HostTransferGuard``, then ``torch.cuda.synchronize()`` inside
    ``allow()``: no step reads the card on the host, the values equal
    phase 5's ``run(10)`` bitwise, and the launches are K1 once per
    level and K2 once per step."""
    import torch

    from lux_tpu_torch.analysis.sentinel import HostTransferGuard
    from lux_tpu_torch.ops import _cuda

    t = time.perf_counter()
    with HostTransferGuard("first use"):
        # The first op under a dispatch mode pays torch's one-time
        # set-up of its Python dispatcher (hundreds of imports).
        torch.zeros(1) + 1
    first_s = time.perf_counter() - t
    v = ex.init_values()
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t = time.perf_counter()
    with HostTransferGuard("tiled steps") as guard:
        for _ in range(GUARD_STEPS):
            v = ex.step(v)
        with guard.allow():
            torch.cuda.synchronize()
    took = time.perf_counter() - t
    counts = {k: n for k, n in _cuda.LAUNCHES.items() if n}
    if counts != {"strip_spmv": nlev * GUARD_STEPS,
                  "tail_gather_sum": GUARD_STEPS}:
        raise AssertionError(f"guarded tiled steps: launches {counts}")
    if not np.array_equal(v.cpu().numpy(), want):
        raise AssertionError("guarded tiled steps differ from run(10)")
    log(f"[guard] {GUARD_STEPS} tiled step() calls (K1, K2) under "
        f"HostTransferGuard: no device->host read, then "
        f"torch.cuda.synchronize() inside allow(); values bitwise phase "
        f"5's run({ITERS}); launches {counts}; {took * 1e3:.1f} ms (the "
        f"dispatch mode's one-time set-up before them {first_s:.2f} s)")


def _guard_phases(push: dict, dev) -> None:
    """``HostTransferGuard`` on the card: ``.item()``, ``.cpu()``,
    ``.tolist()`` and ``float()`` of a CUDA tensor each raise
    ``HostTransferError`` inside it and pass inside ``allow()``; the push
    executor's SSSP ``step`` raises at its per-iteration counter read
    (``_read``, ROADMAP A20)."""
    import traceback

    import torch

    from lux_tpu_torch.analysis.sentinel import (HostTransferError,
                                                 HostTransferGuard)

    t = torch.arange(1 << 20, dtype=torch.float32, device=dev)
    forms = {".item()": lambda: t.sum().item(), ".cpu()": t.cpu,
             ".tolist()": lambda: t[:8].tolist(),
             "float()": lambda: float(t[3])}
    raised = {}
    with HostTransferGuard("forms") as guard:
        for name, form in forms.items():
            try:
                form()
            except HostTransferError as e:
                raised[name] = str(e).split(" inside ")[0]
            else:
                raise AssertionError(f"HostTransferGuard let {name} of a "
                                     "CUDA tensor through")
            with guard.allow():
                form()
    log(f"[guard] inside HostTransferGuard each form of a CUDA tensor "
        f"raises HostTransferError: {raised}; inside allow() each passes")
    ex = push["sssp_ex"]
    state = ex.init_state(start=0)
    torch.cuda.synchronize()
    try:
        with HostTransferGuard("push sssp"):
            ex.step(state)
    except HostTransferError as e:
        frames = [f.name for f in traceback.extract_tb(e.__traceback__)]
        if "_read" not in frames:
            raise AssertionError(f"push step raised outside _read: "
                                 f"{frames}") from e
        log(f"[guard] the push executor's SSSP step() raises at its "
            f"counter read ({' -> '.join(frames[-4:])}: {e}): one host read "
            f"per iteration, where lux_tpu reads once a chunk (ROADMAP "
            f"A20)")
    else:
        raise AssertionError("the push executor's step read nothing on "
                             "the host under HostTransferGuard")


# -- 2r: the trace tiers (analysis/trace.py, analysis/ir.py) -----------------

TRACE_GROUP = "2r trace tiers"
TRACE_TIERS = {"ir": ("--ir",), "exchange": ("--exchange",)}
# Each torch fixture, the tier that runs it; it must fire exactly the rule
# its stem names.
TRACE_FIXTURES = {
    "lux101_dtype_drift": "--ir", "lux102_host_callback": "--ir",
    "lux103_blowup": "--ir", "lux104_donation": "--ir",
    "lux105_collective": "--ir", "lux404_overlap": "--exchange",
    "lux405_sentinel": "--exchange", "lux406_bytes": "--exchange"}
IR_TARGETS, EXCHANGE_RESULTS, EXCHANGE_PLANS = 59, 63, 23
# Each traced kernel wrapper and the kernel it launches.
TRACE_LAUNCH = {
    "lux.strip_level_spmv": "strip_spmv",
    "lux.lane_select_tail_sums": "tail_gather_sum",
    "lux.level_apply": "level_apply", "lux.root_reduce":
    "segment_sum_rowptr", "lux.segment_sum_by_rowptr": "segment_sum_rowptr",
    "lux.segment_minmax_relax": "segment_minmax_relax",
    "lux.gas_pull_acc": "gas_pull_acc", "lux.frontier_queue":
    "frontier_queue", "lux.queue_relax_scatter": "queue_relax_scatter",
    "lux.gas_push_acc": "gas_push_acc"}


def _trace_clis():
    """Start the trace tiers' registries as a user runs them, on the
    card: ``python -m lux_tpu_torch.tools.luxlint --ir`` (every
    registered program x executor's step traced, LUX101-105) and
    ``--exchange`` (every sharded registry executor's step, LUX404-406,
    and its compact plan, LUX401-403/407); group 2r collects them (they
    run beside the graph's generation)."""
    env = {k: v for k, v in os.environ.items() if k != "LUX_PLATFORM"}
    return {name: (time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "lux_tpu_torch.tools.luxlint", "--json",
         *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env)) for name, args in TRACE_TIERS.items()}


def _trace_phases(procs, dev) -> dict:
    """Group 2r: the registry CLIs rc 0 with 0 findings and 0 errors
    (59 IR targets; the exchange matrix's 63 results, 23 of them compact
    plans); each torch fixture of ``tests/torch_ir_fixtures/`` through
    luxlint's ``main`` in this process, on the card, rc 1 with exactly
    its rule; then every registry target traced here on the card and on
    the CPU: 0 findings of LUX101-105 and LUX404-406 on the card, and
    their kernel and collective nodes equal in sequence and shape
    (glue-op differences are logged). Returns the card traces'
    launches, which are at most their kernel nodes (a wrapper with no
    work launches nothing)."""
    import contextlib
    import io

    import torch

    from lux_tpu_torch.analysis import ir, trace
    from lux_tpu_torch.ops import _cuda
    from lux_tpu_torch.tools import luxlint

    want = {"ir": (IR_TARGETS, "luxlint.ir.v1"),
            "exchange": (EXCHANGE_RESULTS, "luxlint-exchange.v1")}
    for name, (t0, proc) in procs.items():
        t = time.perf_counter()
        summary, doc, err = _luxlint_json(proc, f"luxlint --{name}")
        waited = time.perf_counter() - t
        if (proc.returncode != 0 or summary["findings"] or summary["errors"]
                or not summary["ok"]
                or (summary["files"], summary["schema"]) != want[name]):
            raise AssertionError(f"luxlint --{name}: rc {proc.returncode}, "
                                 f"{summary}\n{err[-2000:]}")
        log(f"[trace] --{name}: rc 0, {summary['files']} "
            + ("registry targets traced on the card" if name == "ir" else
               f"results (the sharded registry's traced steps and its "
               f"{EXCHANGE_PLANS} compact plans, on the card)")
            + f", 0 findings, schema {summary['schema']}, the tier "
            f"{summary['elapsed_s']} s (waited {waited:.1f} s for the CLI, "
            f"{time.perf_counter() - t0:.1f} s since its start)")

    fixtures = Path(__file__).resolve().parent / "tests" / "torch_ir_fixtures"
    fired = {}
    t = time.perf_counter()
    for stem, tier in TRACE_FIXTURES.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = luxlint.main([tier, "--json", str(fixtures / f"{stem}.py")])
        out = buf.getvalue()
        by_rule = json.loads(out[out.rindex("LUXLINT ") + 8:])["by_rule"]
        if rc != 1 or list(by_rule) != ["LUX" + stem[3:6]]:
            raise AssertionError(f"fixture {stem}: rc {rc}, {by_rule}")
        fired[stem] = by_rule
    log(f"[trace] the {len(fired)} torch fixtures, each through luxlint "
        f"{{--ir, --exchange}} on the card: rc 1, exactly its rule "
        f"({dict((k[:6], v) for k, v in fired.items())}) in "
        f"{time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    card = ir.registry_targets(device=dev)
    cpu = {x.name: x for x in ir.registry_targets(device="cpu")}
    build_s = time.perf_counter() - t
    rules = ir.all_ir_rules() + ir.exchange_ir_rules()
    torch.cuda.synchronize()
    _cuda.reset_launches()
    nodes, glue, kernel_nodes = 0, [], {}
    card_s = cpu_s = 0.0
    for target in card:
        kept = []
        t = time.perf_counter()
        res = ir.check_target(target, rules, kept)
        card_s += time.perf_counter() - t
        if res.error or res.findings:
            raise AssertionError(f"{target.name} on the card: {res.error} "
                                 f"{[f.format() for f in res.findings]}")
        t = time.perf_counter()
        on_cpu = ir.trace_target(cpu[target.name])
        cpu_s += time.perf_counter() - t
        mine, theirs = (trace.kernel_sequence(kept[0]),
                        trace.kernel_sequence(on_cpu))
        if mine != theirs:
            raise AssertionError(f"{target.name}: kernel/collective nodes "
                                 f"differ, card {mine} CPU {theirs}")
        for op, _, _ in mine:
            kernel_nodes[op] = kernel_nodes.get(op, 0) + 1
        nodes += len(kept[0].nodes)
        ga = [n.op for n in kept[0].nodes if n.kind == "aten"]
        gb = [n.op for n in on_cpu.nodes if n.kind == "aten"]
        if ga != gb:
            glue.append(f"{target.name} ({len(ga)} vs {len(gb)})")
    torch.cuda.synchronize()
    counts = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    per_kernel = {}
    for op, n in kernel_nodes.items():
        if op in TRACE_LAUNCH:
            per_kernel[TRACE_LAUNCH[op]] = per_kernel.get(
                TRACE_LAUNCH[op], 0) + n
    pull = kernel_nodes.get("lux.pull_sum", 0)
    over = {k: v for k, v in counts.items() if v > per_kernel.get(k, 0)
            + (pull if k in ("gather_segment_sum", "cf_edge_sum") else 0)}
    if over or not counts:
        raise AssertionError(f"registry traces: launches {counts} beyond "
                             f"their kernel nodes {kernel_nodes}")
    log(f"[trace] {len(card)} registry targets traced in process on the "
        f"card ({card_s:.2f} s) and on the CPU ({cpu_s:.2f} s; both "
        f"registries built in {build_s:.2f} s): {nodes} card nodes, 0 "
        f"findings; kernel and collective nodes equal in sequence and "
        f"shape on both ({dict(sorted(kernel_nodes.items()))}); glue-op "
        f"sequences differ in {len(glue)} target(s)"
        + (f": {', '.join(glue[:8])}" if glue else "")
        + f"; launches {counts}")
    return counts


def _trace_scale(label, ex, init_kw: dict, want: dict) -> dict:
    """Group 2r at the main path's scale: ``ex.trace_step`` traced on
    the card with 0 findings of LUX101-105 and LUX404-406, its launches
    ``want``; logs its seconds, node count and largest intermediate over
    the step's input bytes. Returns its launches."""
    import torch

    from lux_tpu_torch.analysis import ir
    from lux_tpu_torch.ops import _cuda

    t = time.perf_counter()
    target = ir.target_from_spec(label, ex.trace_step(**init_kw))
    torch.cuda.synchronize()
    _cuda.reset_launches()
    kept = []
    res = ir.check_target(target, ir.all_ir_rules()
                          + ir.exchange_ir_rules(), kept)
    torch.cuda.synchronize()
    took = time.perf_counter() - t
    counts = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    if res.error or res.findings:
        raise AssertionError(f"trace {label}: {res.error} "
                             f"{[f.format() for f in res.findings]}")
    if counts != want:
        raise AssertionError(f"trace {label}: launches {counts}, expected "
                             f"{want}")
    tr = kept[0]
    kinds = {}
    for n in tr.nodes:
        kinds[n.kind] = kinds.get(n.kind, 0) + 1
    big, inb = tr.largest_intermediate(), tr.input_bytes()
    log(f"[trace] {label}: traced on the card in {tr.seconds:.3f} s "
        f"({took:.2f} s with its spec and the rules), {len(tr.nodes)} nodes "
        f"{kinds}, 0 findings of LUX101-105 and LUX404-406; largest "
        f"intermediate {big} B = {big / max(inb, 1):.4f}x the step's "
        f"{inb} input bytes; launches {counts}")
    return counts


def _k2_check(label, tail_src, row_ptr, n_x: int, rng, reps: int, dev):
    """K2 over one tail stream and row pointer, as the main path calls it
    (adding into a row vector, x of ``n_x`` values): bitwise against its
    plain version on integral x with accumulate off and on, within
    rtol=5e-5, atol=1e-9 on random floats; then its time, the plain
    version's, cuSPARSE's (``torch.sparse`` CSR @ x) and its bytes.
    Returns (max_abs_err, ms, plain_ms, bytes, adds, library_ms)."""
    import torch

    from lux_tpu_torch.ops.tiled_spmv import (
        lane_select_tail_sums,
        lane_select_tail_sums_plain,
    )

    rows = row_ptr.shape[0] - 1
    x_int = torch.from_numpy(
        rng.integers(0, 4, size=n_x).astype(np.float32)).to(dev)
    x_float = torch.from_numpy(
        rng.random(n_x, dtype=np.float32) + np.float32(0.5)).to(dev)
    y_int = torch.from_numpy(
        rng.integers(0, 4, size=rows).astype(np.float32)).to(dev)
    y_float = torch.from_numpy(rng.random(rows, dtype=np.float32)).to(dev)
    args = (tail_src, row_ptr)
    check_equal(f"{label} integral", lane_select_tail_sums(x_int, *args),
                lane_select_tail_sums_plain(x_int, *args))
    check_equal(f"{label} integral, accumulate",
                lane_select_tail_sums(x_int, *args, out=y_int.clone()),
                lane_select_tail_sums_plain(x_int, *args, out=y_int.clone()))
    err = check_close(label, lane_select_tail_sums(
        x_float, *args, out=y_float.clone()), lane_select_tail_sums_plain(
            x_float, *args, out=y_float.clone()))
    y = y_float.clone()
    ms = cuda_ms(lambda: lane_select_tail_sums(x_float, *args, out=y), reps)
    plain_ms = cuda_ms(lambda: lane_select_tail_sums_plain(
        x_float, *args, out=y), reps)
    m = int(row_ptr[-1])
    csr = torch.sparse_csr_tensor(row_ptr, tail_src[:m].long(),
                                  torch.ones(m, device=dev),
                                  size=(rows, n_x))
    xv = x_float.reshape(-1, 1)
    lib_ms = cuda_ms(lambda: csr @ xv, reps)
    del csr
    # The stream, the row pointer, y read and written, x's distinct
    # sources once.
    n_src = int(torch.unique(tail_src[:m]).numel())
    nbytes = 4 * m + 8 * (rows + 1) + 8 * rows + 4 * n_src
    log(f"[kernel] {label}: {m} edges into {rows} rows, bitwise on integral "
        f"x (accumulate off and on); {ms:.4f} ms, plain {plain_ms:.4f}, "
        f"cuSPARSE {lib_ms:.4f}, bytes bound {bound(nbytes, m)[0]:.4f} ms "
        f"(each gather reads a 32-byte L2 sector: {32 * m / 1e9:.3f} GB)")
    return err, ms, plain_ms, nbytes, m, lib_ms


def _strip_form_product(hlev, x, nvb: int, dev, chunk: int = 1 << 17):
    """K1 as the strips define it, for one host plan level: f32
    strip-times-block products a chunk of host strips at a time, summed
    per destination row in f64 (exact for integral ``x``); with the
    level's count of nonzero cells."""
    import torch

    r = hlev.r
    y = torch.zeros(nvb * 128, dtype=torch.float64, device=dev)
    lanes = torch.arange(r, device=dev)
    nnz = 0
    for lo in range(0, hlev.rows.shape[0], chunk):
        s = torch.from_numpy(np.ascontiguousarray(
            hlev.strips[lo:lo + chunk])).to(dev)
        nnz += int(torch.count_nonzero(s))
        cols = torch.from_numpy(
            np.asarray(hlev.cols[lo:lo + chunk], np.int64)).to(dev)
        rows = torch.from_numpy(
            np.asarray(hlev.rows[lo:lo + chunk], np.int64)).to(dev)
        contrib = (s.float() * x[cols][:, None, :]).sum(-1)
        y.index_add_(0, (rows[:, None] * r + lanes).reshape(-1),
                     contrib.reshape(-1).double())
        del s, contrib
    return y.float(), nnz


def _k1_yardsticks(host_levels, levels, x, nvb: int, reps: int, label: str,
                   runs=None):
    """K1's ms, plain ms, bytes, flops and cuSPARSE ms, summed over the
    levels of a plan (or of one part, whose strip run of each host level
    is ``runs``). Bytes: each cell's 4-byte source and 1-byte count, the
    8-byte row pointer and the 4-byte output of each row of the level's
    band, and every distinct source value once. The yardstick is one
    cuSPARSE CSR product over the same cells, with one entry per cell:
    the count as the value, the source as the column."""
    import torch

    from lux_tpu_torch.ops.tiled_spmv import (
        strip_level_spmv,
        strip_level_spmv_plain,
    )

    ms = plain = lib = 0.0
    nbytes = flops = strip_bytes = 0
    xv = x.reshape(-1, 1)
    for k, (hlev, lev) in enumerate(zip(host_levels, levels)):
        if lev.n_cells == 0:
            continue
        n = lev.n_cells
        # As the executors call it: a part's band adds into a zeroed
        # full-height partial; a whole level writes a new vector.
        out = None if lev.nrows == lev.height else torch.zeros(
            lev.height, dtype=torch.float32, device=x.device)
        ms += cuda_ms(lambda: strip_level_spmv(x, lev, out), reps)
        plain += cuda_ms(lambda: strip_level_spmv_plain(x, lev, out), 2)
        distinct = int(torch.unique(lev.src[:n]).numel())
        nbytes += 5 * n + 8 * (lev.nrows + 1) + 4 * distinct + 4 * lev.nrows
        flops += 2 * n
        # The same level as the strips stored it: every strip byte, its
        # column, the full-height row pointer, all of x and the output.
        t0, t1 = (0, hlev.rows.shape[0]) if runs is None else runs[k]
        strip_bytes += (t1 - t0) * (hlev.r * 128 + 4) \
            + 8 * (nvb * 128 // hlev.r + 1) + 4 * x.numel() + 4 * lev.nrows
        csr = torch.sparse_csr_tensor(
            lev.row_ptr, lev.src[:n].long(), lev.cnt[:n].float(),
            size=(lev.nrows, nvb * 128))
        diff = (csr @ xv).reshape(-1) - strip_level_spmv(x, lev)[
            lev.row0:lev.row0 + lev.nrows]
        log(f"[kernel] strip_spmv{label} r={lev.r}: cuSPARSE CSR of "
            f"{csr.values().numel()} entries ({n} cells), max diff "
            f"{diff.abs().max().item():.3e}; {distinct} distinct sources")
        lib += cuda_ms(lambda: csr @ xv, reps)
        del csr, diff, out
    log(f"[kernel] strip_spmv{label}: bound on the cell stream "
        f"{bound(nbytes, flops)[0]:.4f} ms ({nbytes} B), on the strip "
        f"layout {bound(strip_bytes, 0)[0]:.4f} ms ({strip_bytes} B)")
    return ms, plain, nbytes, flops, lib


# -- 3j-6j: dynamic graphs and incremental recompute --------------------------

EDIT_SEED = 17                   # tools/snapshot_smoke.py:114
PR_WARM_ITERS, PR_WARM_TOL = 20, 1e-7
# tests/test_incremental.py:261 holds warm PageRank within rtol 1e-3,
# atol 1e-6 at nv ~ 256; a rank here is about 0.85 / nv ~ 2e-7, so the
# atol is scaled to the ranks: PR_WARM_ATOL_NV / nv.
PR_WARM_RTOL, PR_WARM_ATOL_NV = 1e-3, 1e-3
INC_KERNELS = ("segment_minmax_relax", "frontier_queue",
               "queue_relax_scatter", "gather_segment_sum", "gas_pull_acc")


def _edit_batch(graph, symmetric=False, seed=EDIT_SEED):
    """``lux_tpu``'s "~1% edit batch" (``tools/snapshot_smoke.py:114-125``)
    drawn as arrays, the same draws: ``ne // 100`` edits, half inserts
    with both ends uniform over nv, half deletes of existing edges drawn
    without replacement, ``default_rng(17)``. ``symmetric`` adds the
    reverse of every insert and delete, as tests/test_incremental.py
    does for CC on a closure."""
    from lux_tpu_torch.graph import EdgeEdits

    rng = np.random.default_rng(seed)
    n = max(2, graph.ne // 100)
    pairs = rng.integers(graph.nv, size=(n // 2, 2))
    e = rng.choice(graph.ne, size=n - n // 2, replace=False)
    ins_s, ins_d = pairs[:, 0], pairs[:, 1]
    del_s = graph.col_src[e].astype(np.int64)
    del_d = graph.col_dst[e].astype(np.int64)
    if symmetric:
        ins_s, ins_d = np.r_[ins_s, ins_d], np.r_[ins_d, ins_s]
        del_s, del_d = np.r_[del_s, del_d], np.r_[del_d, del_s]
    return EdgeEdits(ins_src=ins_s, ins_dst=ins_d, ins_w=None,
                     del_src=del_s, del_dst=del_d)


def _incremental_phases(g, gu, push, held, dev, work) -> dict:
    """Phases 3j-6j: an edit batch arrives, a snapshot is minted and
    logged to the WAL (under ``work``), and warm-started fixpoints run
    on the new graph: SSSP from vertex 0 and CC on the edited closure
    (K5-K7), 8-lane SSSP (K10 with 8 columns) and PageRank (K8).
    ``push`` is phase 5b's context (its fixpoints are the old values);
    ``held["multi"]`` phase 5f's roots and lanes. Returns the launch
    counts of the four warm runs, summed."""
    import torch

    from lux_tpu_torch.analysis import gasck
    from lux_tpu_torch.engine.check import count_violations
    from lux_tpu_torch.engine.incremental import (IncrementalExecutor,
                                                  incremental_pagerank)
    from lux_tpu_torch.engine.pull import PullExecutor
    from lux_tpu_torch.engine.push import MultiSourcePushExecutor, PushExecutor
    from lux_tpu_torch.graph import DeltaGraph, SnapshotStore
    from lux_tpu_torch.graph.delta import removed_edges
    from lux_tpu_torch.models import SSSP, ConnectedComponents, PageRank
    from lux_tpu_torch.models.components import reference_components
    from lux_tpu_torch.models.pagerank import true_ranks
    from lux_tpu_torch.models.sssp import reference_sssp
    from lux_tpu_torch.ops import _cuda
    from lux_tpu_torch.utils import checkpoint

    torch.cuda.reset_peak_memory_stats()
    host = {}

    def timed_host(name, fn):
        t0 = time.perf_counter()
        out = fn()
        host[name] = host.get(name, 0.0) + time.perf_counter() - t0
        return out

    # -- 3j. snapshots ---------------------------------------------------------
    shutil.rmtree(work, ignore_errors=True)
    edits = timed_host("edits", lambda: _edit_batch(g))
    store = SnapshotStore(g, wal_dir=str(work))
    timed_host("WAL append + fsync", lambda: store.enqueue(edits))
    snap = timed_host("merge + fingerprint + commit", store.apply)
    new_g = snap.graph
    removed = timed_host("removed_edges",
                         lambda: removed_edges(g, edits.del_src,
                                               edits.del_dst))
    inserted = (edits.ins_src, edits.ins_dst)
    wal = store.wal_stats()
    rec = timed_host("recover", lambda: SnapshotStore.recover(g, str(work)))
    head = rec.current()
    if (head.version, head.fingerprint) != (1, snap.fingerprint) or not (
            np.array_equal(head.graph.row_ptr, new_g.row_ptr)
            and np.array_equal(head.graph.col_src, new_g.col_src)):
        raise AssertionError(
            f"recovered version {head.version} fingerprint "
            f"{head.fingerprint} differs from version 1's "
            f"{snap.fingerprint}")
    # A second batch below LUX_DELTA_COMPACT_RATIO stacks version 2 on
    # version 0's anchor, as version 1 is: replay must rebuild it there.
    edits2 = timed_host("edits", lambda: _edit_batch(g, seed=EDIT_SEED + 1))
    snap2 = timed_host("merge + fingerprint + commit",
                       lambda: store.apply(edits2))
    rec = timed_host("recover", lambda: SnapshotStore.recover(g, str(work)))
    head = rec.current()
    if snap2.delta.base is not g or (head.version, head.fingerprint) != (
            2, snap2.fingerprint) or not (
            np.array_equal(head.graph.row_ptr, snap2.graph.row_ptr)
            and np.array_equal(head.graph.col_src, snap2.graph.col_src)):
        raise AssertionError(
            f"recovered version {head.version} fingerprint "
            f"{head.fingerprint} differs from version 2's "
            f"{snap2.fingerprint} (stacked on version 0: "
            f"{snap2.delta.base is g})")
    wal2 = store.wal_stats()
    del rec, head, store, snap2
    shutil.rmtree(work, ignore_errors=True)
    timed_host("CSR", new_g.csr)
    log(f"[incremental] batch (seed {EDIT_SEED}): {edits.n_ins} inserts, "
        f"{edits.n_del} deletes removing {removed[0].size} edges; version 1"
        f": ne={new_g.ne} fingerprint {snap.fingerprint} (version 0 "
        f"{checkpoint.fingerprint_hex(g)}); WAL {wal['records']} records, "
        f"{wal['bytes']} B; recover gave version 1, its fingerprint and "
        "row_ptr and col_src bitwise; a second batch (seed "
        f"{EDIT_SEED + 1}) stacked version 2 on version 0's anchor, WAL "
        f"{wal2['records']} records, {wal2['bytes']} B, and recover gave "
        "version 2 bitwise")
    edits_c = timed_host("edits (closure)",
                         lambda: _edit_batch(gu, symmetric=True))
    new_gu = timed_host("merge (closure)", lambda: DeltaGraph.fresh(
        gu).stack(edits_c).merged())
    removed_c = timed_host("removed_edges (closure)",
                           lambda: removed_edges(gu, edits_c.del_src,
                                                 edits_c.del_dst))
    inserted_c = (edits_c.ins_src, edits_c.ins_dst)
    timed_host("CSR (closure)", new_gu.csr)
    log(f"[incremental] closure batch (symmetrised): {edits_c.n_ins} "
        f"inserts, {edits_c.n_del} deletes removing {removed_c[0].size} "
        f"edges; ne {gu.ne} -> {new_gu.ne}")

    # -- 5j. results held on the card ------------------------------------------
    totals = dict.fromkeys(_cuda.LAUNCHES, 0)
    runs = {}

    def counted(fn):
        _cuda.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(_cuda.LAUNCHES)

    def push_want(ex):
        log_ = ex.branch_log
        return {"segment_minmax_relax": sum(1 for b, _, _ in log_ if b == 0),
                "frontier_queue": sum(1 for b, c, _ in log_ if b and c),
                "queue_relax_scatter": sum(1 for b, c, e in log_
                                           if b and c and e)}

    # Each IncrementalExecutor below is built through the LUX604 gate
    # (analysis/gasck.py), which proves a program once per process: the
    # proofs 5j adds are those of its programs no earlier phase proved.
    proofs0 = gasck.incremental_proofs()
    unproven = sum(not gasck.incremental_proven(p)
                   for p in (SSSP(), ConnectedComponents()))
    oracles = {}
    for app, graph, prog, old, rem, ins, kw, oracle in (
            ("sssp", new_g, SSSP(), push["sssp"]["oracle"], removed,
             inserted, {"start": 0}, lambda: reference_sssp(new_g, 0)),
            ("cc", new_gu, ConnectedComponents(), push["cc"]["oracle"],
             removed_c, inserted_c, {}, lambda: reference_components(
                 new_gu))):
        t = time.perf_counter()
        ex = PushExecutor(graph, prog)
        inc = IncrementalExecutor(graph, prog, push=ex)
        torch.cuda.synchronize()
        host[f"executor ({app})"] = time.perf_counter() - t
        (st, iters, info), counts = counted(
            lambda: inc.run(old, removed=rem, inserted=ins, **kw))
        host[f"invalidation ({app})"] = inc.host_seconds["invalidation"]
        host[f"state upload ({app})"] = inc.host_seconds["upload"]
        check_launches(f"warm {app}", counts, push_want(ex))
        branches, sparse = list(ex.branch_log), ex.sparse_iters
        vals = ex.values(st)
        (fst, fiters), fcounts = counted(lambda: ex.run(**kw))
        check_launches(f"from-scratch {app}", fcounts, push_want(ex))
        oracles[app] = timed_host(f"oracle ({app})", oracle)
        if vals.shape != (graph.nv,) or vals.dtype != np.uint32:
            raise AssertionError(f"warm {app}: bad output {vals.shape}")
        if not np.array_equal(vals, ex.values(fst)):
            raise AssertionError(f"warm {app}: differs from the "
                                 "from-scratch run on the card")
        if not np.array_equal(vals, oracles[app]):
            raise AssertionError(
                f"warm {app}: {int(np.sum(vals != oracles[app]))} values "
                "differ from the oracle")
        viol = count_violations(graph, st.values, prog)
        if viol:
            raise AssertionError(f"warm {app}: {viol} invariant violations")
        for name, n in counts.items():
            totals[name] += n
        runs[app] = {"ex": ex, "inc": inc, "old": old, "rem": rem,
                     "ins": ins, "kw": kw, "iters": iters, "info": info,
                     "scratch_iters": fiters}
        log(f"[incremental] warm {app}: {iters} iterations "
            f"({sparse} sparse; branches {branches}) against "
            f"{fiters} from scratch; info {info}; values equal the "
            "from-scratch run on the card and the oracle bitwise, 0 "
            f"violations; launches K5 {counts['segment_minmax_relax']}, K6 "
            f"{counts['frontier_queue']}, K7 {counts['queue_relax_scatter']}")
        del st, fst

    roots, lanes = held.pop("multi")
    t = time.perf_counter()
    mx = MultiSourcePushExecutor(new_g, SSSP(), len(roots))
    minc = IncrementalExecutor(new_g, SSSP(), push=runs["sssp"]["ex"],
                               multi=mx)
    torch.cuda.synchronize()
    host["executor (multi)"] = time.perf_counter() - t
    proofs = gasck.incremental_proofs() - proofs0
    if proofs != unproven:
        raise AssertionError(f"5j: {proofs} LUX604 proofs for three "
                             "IncrementalExecutors of SSSP, CC and SSSP; "
                             f"expected {unproven}, one a program not "
                             "proven before")
    log(f"[incremental] 5j: the three IncrementalExecutors (SSSP, CC, "
        f"8-lane SSSP) passed the LUX604 gate with {proofs} new proofs, "
        f"one for each of the {unproven} of their programs no earlier "
        f"phase proved (hooks on {dev})")
    cols = [np.ascontiguousarray(lanes[:, j]) for j in range(len(roots))]
    del lanes
    (mst, miters, minfo), counts = counted(
        lambda: minc.run_multi(roots, cols, removed=removed,
                               inserted=inserted))
    host["invalidation (multi)"] = minc.host_seconds["invalidation"]
    host["state upload (multi)"] = minc.host_seconds["upload"]
    check_launches("warm multi-source", counts, {"gas_pull_acc": miters})
    for name, n in counts.items():
        totals[name] += n
    (fst, fiters), fcounts = counted(lambda: mx.run(roots))
    check_launches("from-scratch multi-source", fcounts,
                   {"gas_pull_acc": fiters})
    check_equal("warm multi-source lanes", mst.values, fst.values)
    if not np.array_equal(mx.values_for(mst, 0), oracles["sssp"]):
        raise AssertionError("warm multi-source lane 0 differs from the "
                             "SSSP oracle")
    runs["multi"] = {"iters": miters, "info": minfo, "scratch_iters": fiters}
    log(f"[incremental] warm multi-source sssp k={len(roots)} (roots "
        f"{roots}): {miters} iterations against {fiters} from scratch; "
        f"info {minfo}; every lane equals the from-scratch run on the card "
        f"bitwise, lane 0 the oracle; launches K10 {counts['gas_pull_acc']}")
    del mst, fst

    t = time.perf_counter()
    pg_old = PullExecutor(g, PageRank())
    pg_new = PullExecutor(new_g, PageRank())
    torch.cuda.synchronize()
    host["executor (pagerank)"] = time.perf_counter() - t
    ni, tol = PR_WARM_ITERS, PR_WARM_TOL
    old_pr = pg_old.run(ni)
    del pg_old
    # The warm vector (ni = 0 returns it), bitwise the old true ranks
    # re-divided by the new out-degrees: eight iterations at ALPHA 0.15
    # shrink a wrong start by 0.15**8, so the ranks alone cannot tell.
    warm0, zero = incremental_pagerank(pg_new, old_pr, g.out_degrees, 0)
    old_h, od, nd = old_pr.cpu().numpy(), g.out_degrees, new_g.out_degrees
    true0 = np.where(od == 0, old_h, old_h * od)
    want0 = np.where(nd == 0, true0, true0 / np.maximum(nd, 1)).astype(
        np.float32)
    moved = (od != nd) & (np.maximum(od, nd) > 1)
    if zero or not np.array_equal(warm0, want0) or np.any(
            warm0[moved] == old_h[moved]):
        raise AssertionError("warm pagerank: the warm vector is not the "
                             "old true ranks over the new out-degrees")
    del warm0, want0, true0, old_h
    (stored, piters), counts = counted(lambda: incremental_pagerank(
        pg_new, old_pr, g.out_degrees, ni, tol=tol))
    check_launches("warm pagerank", counts, {"gather_segment_sum": piters})
    for name, n in counts.items():
        totals[name] += n
    scratch, fcounts = counted(lambda: pg_new.run(ni))
    check_launches("from-scratch pagerank", fcounts,
                   {"gather_segment_sum": ni})
    deg = new_g.out_degrees
    got = true_ranks(stored, deg)
    want = true_ranks(scratch.cpu().numpy(), deg)
    if got.shape != (new_g.nv,) or not np.isfinite(got).all():
        raise AssertionError("warm pagerank: bad output")
    atol = PR_WARM_ATOL_NV / new_g.nv
    np.testing.assert_allclose(got, want, rtol=PR_WARM_RTOL, atol=atol,
                               err_msg="warm pagerank")
    pr_err = float(np.max(np.abs(got - want)))
    runs["pagerank"] = {"iters": piters, "scratch_iters": ni}
    log(f"[incremental] warm pagerank: the warm vector equals the old true "
        f"ranks over the new out-degrees bitwise ({int(moved.sum())} "
        f"vertices' degrees moved); {piters} iterations (tol {tol}, ni "
        f"{ni}) from a flat run({ni}) on version 0; true ranks within "
        f"rtol={PR_WARM_RTOL}, atol={atol:.3e} of run({ni}) on version 1 "
        f"(max abs err {pr_err:.3e}, median rank "
        f"{float(np.median(want)):.3e}); launches K8 "
        f"{counts['gather_segment_sum']}")

    # -- 6j. timing --------------------------------------------------------------
    log("[time] incremental host steps (s): " + ", ".join(
        f"{k}={v:.3f}" for k, v in host.items()))
    def warm_runs(inc, run):
        """Three host-clock runs of ``run``; with each its host split."""
        secs, split = [], []
        for _ in range(3):
            secs.append(host_seconds(run))
            split.append(dict(inc.host_seconds))
        med = {k: float(np.median([d[k] for d in split])) * 1e3
               for k in split[0]}
        device = float(np.median([t - sum(d.values())
                                  for t, d in zip(secs, split)])) * 1e3
        return (f"{_med_ms(secs)} ms (median of 3: {_ms_list(secs)}; "
                f"invalidation {med['invalidation']:.3f}, upload "
                f"{med['upload']:.3f}, the rest {device:.3f})")

    for app in ("sssp", "cc"):
        r = runs[app]
        ex, inc = r["ex"], r["inc"]
        inc.warmup(**r["kw"])
        warm = warm_runs(inc, lambda: inc.run(
            r["old"], removed=r["rem"], inserted=r["ins"], **r["kw"]))
        scratch = [host_seconds(lambda: ex.run(**r["kw"])) for _ in range(3)]
        log(f"[time] incremental {app}: warm run {warm}, {r['iters']} "
            f"iterations; from scratch {_med_ms(scratch)} ms (median of 3: "
            f"{_ms_list(scratch)}), {r['scratch_iters']} iterations; reset "
            f"{r['info']['reset']}, frontier {r['info']['frontier']}, "
            f"touched_frac {r['info']['touched_frac']:.6f}")
    minc.multi.warmup(start=roots[0])
    warm = warm_runs(minc, lambda: minc.run_multi(
        roots, cols, removed=removed, inserted=inserted))
    scratch = [host_seconds(lambda: mx.run(roots)) for _ in range(3)]
    r = runs["multi"]
    log(f"[time] incremental multi-source sssp k={len(roots)}: warm run "
        f"{warm}, {r['iters']} iterations; from scratch {_med_ms(scratch)} "
        f"ms ({_ms_list(scratch)}), {r['scratch_iters']} iterations; reset "
        f"{r['info']['reset']}, frontier {r['info']['frontier']}, "
        f"touched_frac {r['info']['touched_frac']:.6f}")
    pg_new.warmup()
    warm = [host_seconds(lambda: incremental_pagerank(
        pg_new, old_pr, g.out_degrees, ni, tol=tol)) for _ in range(3)]
    scratch = [host_seconds(lambda: pg_new.run(ni)) for _ in range(3)]
    # The iterations alone, from a state on the card (K8 and the apply
    # take the same time whatever the values).
    v0 = pg_new.init_values()
    dev_iters = {n: [host_seconds(lambda: pg_new.run(n, vals=v0))
                     for _ in range(3)]
                 for n in (runs["pagerank"]["iters"], ni)}
    log(f"[time] incremental pagerank: warm run {_med_ms(warm)} ms (median "
        f"of 3: {_ms_list(warm)}), {runs['pagerank']['iters']} iterations; "
        f"from scratch {_med_ms(scratch)} ms ({_ms_list(scratch)}), {ni} "
        "iterations; the iterations alone from a state on the card: "
        + ", ".join(f"{n} in {_med_ms(v)} ms" for n, v in dev_iters.items()))
    del v0
    log("[incremental] launches of the warm runs: " + ", ".join(
        f"{k}={totals[k]}" for k in INC_KERNELS))
    log(f"[incremental] peak device memory of phases 3j-6j "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name in INC_KERNELS:
        if totals[name] <= 0:
            raise AssertionError(f"{name} never ran on the incremental path")
    return totals


def _med_ms(secs) -> str:
    return f"{float(np.median(secs)) * 1e3:.3f}"


def _ms_list(secs) -> list:
    return [round(x * 1e3, 3) for x in secs]


# -- 3k and 4k-6k: the sharded executors over a torch.distributed mesh ------

MESH_GROUP = "3k one-rank NCCL"
RANKS_GROUP = "4k-6k two gloo ranks"
RANKS = 2
RANK_TIMEOUT_S = 600
# label -> (executor kind, graph key, LUX_EXCHANGE); each label's LocalMesh
# run is phase 5e's, 5f's, 5g's or 5h's, kept under held["mesh"][label].
# The tiled run takes phase 3's plan, not a layout (graph key None).
MESH_RUNS = {
    "tiled pagerank full": ("tiled", None, "full"),
    "pull pagerank full": ("pull", "rmat", "full"),
    "pull pagerank compact": ("pull", "rmat", "compact"),
    "push sssp full": ("push", "rmat", "full"),
    "push sssp compact": ("push", "rmat", "compact"),
    "push cc": ("push", "closure", None),
    "push multi full": ("push multi", "rmat", "full"),
    "gas bfs frontier": ("gas", "rmat", "frontier"),
    "gas multi compact": ("gas multi", "rmat", "compact"),
}
# The paths the two ranks run (4k-6k), each against group 3k's run.
RANK_RUNS = ("pull pagerank compact", "tiled pagerank full",
             "push sssp full", "gas bfs frontier")


def _mesh_executor(label, graph, sg, mesh, plan=None):
    """The executor of a group 3k or 4k-6k run over ``mesh``, built
    under its ``LUX_EXCHANGE``."""
    from lux_tpu_torch.engine.gas_sharded import (
        ShardedAdaptiveExecutor,
        ShardedMultiSourceGasExecutor,
    )
    from lux_tpu_torch.engine.pull_sharded import ShardedPullExecutor
    from lux_tpu_torch.engine.push_sharded import (
        ShardedMultiSourcePushExecutor,
        ShardedPushExecutor,
    )
    from lux_tpu_torch.engine.tiled_sharded import ShardedTiledExecutor
    from lux_tpu_torch.models import (
        BFS,
        SSSP,
        ConnectedComponents,
        PageRank,
    )

    kind, _, mode = MESH_RUNS[label]
    flag = os.environ.get("LUX_EXCHANGE")
    if mode is None:
        os.environ.pop("LUX_EXCHANGE", None)
    else:
        os.environ["LUX_EXCHANGE"] = mode
    try:
        if kind == "tiled":
            ex = ShardedTiledExecutor(graph, PageRank(), mesh=mesh, plan=plan)
        elif kind == "pull":
            ex = ShardedPullExecutor(graph, PageRank(), mesh=mesh, sg=sg)
        elif kind == "push":
            prog = SSSP() if "sssp" in label else ConnectedComponents()
            ex = ShardedPushExecutor(graph, prog, mesh=mesh, sg=sg)
        elif kind == "push multi":
            ex = ShardedMultiSourcePushExecutor(graph, SSSP(), MULTI_LANES,
                                                mesh=mesh, sg=sg)
        elif kind == "gas":
            ex = ShardedAdaptiveExecutor(graph, BFS(), mesh=mesh, sg=sg)
        else:
            ex = ShardedMultiSourceGasExecutor(graph, BFS(), MULTI_LANES,
                                               mesh=mesh, sg=sg)
    finally:
        if flag is None:
            os.environ.pop("LUX_EXCHANGE", None)
        else:
            os.environ["LUX_EXCHANGE"] = flag
    if ex.exchange_mode != (mode or "full"):
        raise AssertionError(f"{label}: resolved {ex.exchange_mode}")
    return ex


def _mesh_run(label, ex, roots=None):
    """One run of a group 3k or 4k-6k executor, as its phase 5 run was
    made: (values gathered on the host, what its ledgers say, the
    launches it should make on this process, the call that is timed:
    PageRank's ``run(ITERS)`` from initial values on the card, the
    other programs' ``run`` from their host ``init_state``, as phases
    6e-6h time them)."""
    kind = MESH_RUNS[label][0]
    if kind in ("tiled", "pull"):
        # Timed from a state on the card, as phases 6e and 6g time them.
        vals = ex.init_values()

        def call():
            return ex.run(ITERS, vals=vals)
        out = call()
        k1 = sum(1 for p in getattr(ex, "_parts", ())
                 for lev in getattr(p, "levels", ()) if lev.items.n_items)
        want = ({"strip_spmv": k1 * ITERS,
                 "tail_gather_sum": len(ex._parts) * ITERS}
                if kind == "tiled" else
                {"gather_segment_sum": len(ex._parts) * ITERS})
        return ex.gather_values(out), {}, want, call
    if kind in ("push multi", "gas multi"):
        def call():
            return ex.run(roots)
        st, iters = call()
        return (ex.gather_values(st), {"iters": iters},
                {"gas_pull_acc": len(ex._parts) * iters}, call)
    kw = {} if "cc" in label else {"start": 0}

    def call():
        return ex.run(**kw)
    st, iters = call()
    if kind == "push":
        with_edges = sum(1 for pt in ex._parts if pt.col_src.numel())
        want = {"segment_minmax_relax":
                with_edges * (iters - ex.sparse_iters),
                "frontier_queue": sum(k6 for k6, _ in ex.queue_log),
                "queue_relax_scatter": sum(k7 for _, k7 in ex.queue_log)}
        return (ex.gather_values(st), {"iters": iters,
                                       "sparse": ex.sparse_iters,
                                       "log": list(ex.branch_log)},
                want, call)
    log_ = ex.direction_log
    want = {"gas_pull_acc": len(ex._parts) * sum(1 for e in log_
                                                 if e[0] == 0),
            "frontier_queue": sum(k6 for k6, _ in ex.queue_log),
            "gas_push_acc": sum(k11 for _, k11 in ex.queue_log)}
    return (ex.gather_values(st), {"iters": iters,
                                   "log": [e[:4] for e in log_],
                                   "down": ex.exchange_downgrades},
            want, call)


def _collectives_alone(label, ex, dev) -> dict:
    """PageRank's collectives alone over its mesh: the exchange (an
    all-to-all for compact, an all-gather for full) and, tiled, the strip
    merge (the reduce-scatter): what -> (ms, median of 10 host-clock
    calls after one, bytes staged a call)."""
    vals = ex.init_values()
    fns = {"exchange": lambda: ex._exchange(vals)}
    if label.startswith("tiled"):
        partials = ex._partials(ex._exchange(vals))
        fns["strip merge"] = lambda: ex._merge(partials)
    clock = host_seconds if dev.type == "cuda" else _host_clock
    out = {}
    for what, fn in fns.items():
        clock(fn)
        before = getattr(ex.mesh, "staged_bytes", 0)
        secs = [clock(fn) for _ in range(10)]
        out[what] = (float(np.median(secs)) * 1e3,
                     (getattr(ex.mesh, "staged_bytes", 0) - before) / 10)
    return out


def _warm_kw(label, roots=None) -> dict:
    """``warmup``'s arguments for a group 3k or 4k-6k run."""
    if roots:
        return {"start": roots[0]}
    return {"start": 0} if "sssp" in label or "bfs" in label else {}


def _held_equal(label, got, ledgers, want, what) -> None:
    """Raise unless a run's values are ``want``'s bitwise and its
    ledgers equal ``want``'s."""
    if got.dtype != want["values"].dtype or not np.array_equal(
            got, want["values"]):
        raise AssertionError(f"{label}: values differ from {what}")
    for key, v in ledgers.items():
        if v != want[key]:
            raise AssertionError(f"{label}: {key} {v}, {what} {want[key]}")


def _mesh_init(dev):
    """Group 3k's process group: ``initialize(backend="nccl",
    world_size=1, rank=0)`` in this process (gloo when rehearsed on the
    CPU), then ``make_global_mesh(SHARDED_PARTS)``."""
    from lux_tpu_torch.parallel.multihost import initialize, make_global_mesh

    t = time.perf_counter()
    initialize(backend="nccl" if dev.type == "cuda" else "gloo",
               world_size=1, rank=0)
    mesh = make_global_mesh(SHARDED_PARTS, device=dev)
    log(f"[mesh] {mesh} in {time.perf_counter() - t:.1f} s")
    return mesh


def _mesh_phases(runs, mesh, held, dev) -> dict:
    """Group 3k: each of ``runs`` (label -> (graph, layout or plan,
    roots)) over the one-rank ``mesh`` of ``_mesh_init``, built on the
    layouts and plan phases 3e-3h used, held bitwise against its
    LocalMesh run (``held["mesh"]``) with equal iterations and ledgers,
    its launches checked, then timed (median of 3 after ``warmup``, host
    clock) beside the LocalMesh time. Keeps each run's values and
    ledgers under ``held["3k"]`` for group 4k-6k; returns the launch
    counts of the held runs, summed."""
    import torch

    from lux_tpu_torch.ops import _cuda

    totals = dict.fromkeys(_cuda.LAUNCHES, 0)
    for label, (graph, layout, roots) in runs.items():
        t = time.perf_counter()
        plan = layout if label.startswith("tiled") else None
        ex = _mesh_executor(label, graph, None if plan else layout, mesh,
                            plan)
        torch.cuda.synchronize()
        built = time.perf_counter() - t
        _cuda.reset_launches()
        got, ledgers, want_launches, call = _mesh_run(label, ex, roots)
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        ref = held["mesh"][label]
        _held_equal(label, got, ledgers, ref, "its LocalMesh run")
        check_launches(f"3k {label}", counts, want_launches)
        for name, n in counts.items():
            totals[name] += n
        held.setdefault("3k", {})[label] = {"values": got, **ledgers}
        ex.warmup(**_warm_kw(label, roots))
        secs = [host_seconds(call) for _ in range(3)]
        ms = float(np.median(secs)) * 1e3
        per = ("ms/iteration" if "pagerank" in label else "ms to fixpoint")
        if per == "ms/iteration":
            ms /= ITERS
        held["3k"][label]["ms"] = ms
        if "pagerank" in label:
            alone = _collectives_alone(label, ex, dev)
            held["3k"][label]["alone"] = alone
            log(f"[mesh] 3k {label} collectives alone (median of 10, host "
                "clock): " + ", ".join(f"{k} {v[0]:.4f} ms"
                                       for k, v in alone.items()))
        log(f"[mesh] 3k {label} (built in {built:.1f} s): bitwise equal to "
            f"its LocalMesh run{'' if not ledgers else ', ledgers equal'} "
            f"({', '.join(f'{k}={v}' for k, v in ledgers.items() if k != 'log')}"
            f"); launches {({k: v for k, v in counts.items() if v})}; "
            f"{ms:.3f} {per} (median of 3 after warmup: "
            f"{[round(x * 1e3, 3) for x in secs]} ms) against LocalMesh "
            f"{ref['ms']:.3f}; exchange_bytes_per_iter "
            f"{ex.exchange_bytes_per_iter()}")
        del ex, got
        torch.cuda.empty_cache()
    return totals


def _rank_phases(work, graph_path, plan_path, held, smi) -> None:
    """Group 4k-6k: ``RANKS`` processes of this script on the one card
    (``--mesh-rank``), started as ``torchrun`` starts them (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``), so a bare ``initialize()`` picks
    gloo. Each rank reads ``graph_path`` and ``plan_path``, builds its
    parts' layout and runs ``RANK_RUNS`` (``_rank_main``). Every rank's
    values, iterations and ledgers are held bitwise against group 3k's;
    their times and staged bytes are logged beside 3k's and the
    LocalMesh's. A rank that fails or outlasts ``RANK_TIMEOUT_S`` fails
    the group, and no rank outlives it."""
    import pickle
    import socket

    import torch

    torch.cuda.empty_cache()
    work.mkdir(parents=True, exist_ok=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = {k: v for k, v in os.environ.items() if k != "LUX_EXCHANGE"}
    base.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                WORLD_SIZE=str(RANKS), LOCAL_WORLD_SIZE=str(RANKS))
    procs, logs = [], []
    for r in range(RANKS):
        logs.append(open(work / f"rank{r}.log", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-rank",
             str(work), str(graph_path), str(plan_path)],
            env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=logs[-1], stderr=subprocess.STDOUT))
    deadline = time.perf_counter() + RANK_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        for line in (work / f"rank{r}.log").read_text().splitlines():
            log(line if line.startswith("[rank") else f"[rank {r}] {line}")
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of {RANKS} exited "
                                 f"{p.returncode}")
    got = []
    for r in range(RANKS):
        with open(work / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    for label in RANK_RUNS:
        want = held["3k"][label]
        for r, res in enumerate(got):
            run = res[label]
            _held_equal(f"rank {r} {label}", run["values"],
                        {k: v for k, v in run.items()
                         if k in ("iters", "sparse", "log", "down")},
                        want, "group 3k's run")
        run = got[0][label]
        per = "ms/iteration" if "pagerank" in label else "ms to fixpoint"
        log(f"[ranks] {label}: both ranks bitwise equal to group 3k's run "
            f"with its iterations and ledgers; {per} rank 0 "
            f"{run['ms']:.3f}, rank 1 {got[1][label]['ms']:.3f} against "
            f"one rank (NCCL) {want['ms']:.3f} and LocalMesh "
            f"{held['mesh'][label]['ms']:.3f}; staged through pinned host "
            f"buffers {run['staged'] / run['calls']:.0f} B a run "
            f"({run['staged_iter']:.0f} B an iteration) by rank 0 against "
            f"{run['bytes']} B exchange_bytes_per_iter; on {smi}")
        for what, (ms_, staged) in run.get("alone", {}).items():
            log(f"[ranks] {label} {what} alone: {ms_:.4f} ms over two gloo "
                f"ranks ({staged:.0f} B staged a call by rank 0) against "
                f"{want['alone'][what][0]:.4f} ms over one NCCL rank "
                "(median of 10, host clock)")
    shutil.rmtree(work)


def _rank_main(work, graph_path, plan_path) -> int:
    """One rank of group 4k-6k (``--mesh-rank``): a bare ``initialize()``
    from the launcher's environment, ``make_global_mesh(SHARDED_PARTS)``
    on the card (``LUX_PLATFORM=cpu`` for the CPU), the layout of its
    parts from the files (each host step's seconds logged), then each of
    ``RANK_RUNS`` with its launches checked and its time (median of 3
    after ``warmup``, host clock) and staged bytes taken; what it got is
    pickled to ``<work>/rank<r>.pkl``."""
    import pickle

    import torch
    import torch.distributed as dist

    from lux_tpu_torch.graph import read_lux
    from lux_tpu_torch.ops import _cuda
    from lux_tpu_torch.ops.tiled_spmv import load_plan
    from lux_tpu_torch.parallel.multihost import initialize, make_global_mesh
    from lux_tpu_torch.parallel.shard import ShardedGraph
    from lux_tpu_torch.utils.platform import platform_device

    t0 = time.perf_counter()
    dev = platform_device()
    clock = host_seconds if dev.type == "cuda" else _host_clock
    initialize()
    mesh = make_global_mesh(SHARDED_PARTS, device=dev)
    rank = mesh.rank

    def say(msg):
        log(f"[rank {rank}] {msg}")

    say(f"{mesh} in {time.perf_counter() - t0:.1f} s after start")
    host = {}

    def step(name, fn):
        t = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        host[name] = time.perf_counter() - t
        return out

    g = step("read", lambda: read_lux(str(graph_path)))
    sg = step("layout", lambda: ShardedGraph.build(g, SHARDED_PARTS))
    step("compact plan", sg.exchange_plan)
    step("push CSR", sg.build_push_csr)
    plan = step("plan load", lambda: load_plan(str(plan_path)))
    exs = {}
    for label in RANK_RUNS:
        exs[label] = step(f"{label} executor", lambda: _mesh_executor(
            label, g, sg, mesh, plan))
    say("host seconds of the layout of parts "
        f"{list(mesh.local_parts)}: " + ", ".join(
            f"{k} {v:.2f}" for k, v in host.items()))
    out = {}
    for label, ex in exs.items():
        _cuda.reset_launches()
        got, ledgers, want_launches, call = _mesh_run(label, ex)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        if dev.type == "cuda":
            check_launches(f"rank {rank} {label}", counts, want_launches)
        ex.warmup(**_warm_kw(label))
        before = mesh.staged_bytes
        secs = [clock(call) for _ in range(3)]
        staged = mesh.staged_bytes - before
        iters = ledgers.get("iters", ITERS)
        ms = float(np.median(secs)) * 1e3
        if "pagerank" in label:
            ms /= ITERS
        out[label] = {"values": got, **ledgers, "ms": ms, "staged": staged,
                      "calls": 3, "staged_iter": staged / (3 * iters),
                      "bytes": ex.exchange_bytes_per_iter(),
                      "launches": counts}
        if "pagerank" in label:
            out[label]["alone"] = _collectives_alone(label, ex, dev)
            say(f"{label} collectives alone (median of 10, host clock): "
                + ", ".join(f"{k} {v[0]:.4f} ms, {v[1]:.0f} B staged"
                            for k, v in out[label]["alone"].items()))
        say(f"{label}: {iters} iterations; launches "
            f"{ {k: v for k, v in counts.items() if v} }; "
            f"{ms:.3f} {'ms/iteration' if 'pagerank' in label else 'ms'} "
            f"(median of 3: {[round(x * 1e3, 3) for x in secs]} ms); "
            f"staged {staged / 3:.0f} B a run")
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()
    say(f"done in {time.perf_counter() - t0:.1f} s")
    return 0


def _host_clock(fn) -> float:
    t = time.perf_counter()
    fn()
    return time.perf_counter() - t


# -- 3l-6l: telemetry (obs/) on the card -------------------------------------

TELEMETRY_GROUP = "3l-6l telemetry"
# K1's two kernels and K2's row pass over a gather, as torch.profiler
# names them.
KERNEL_NAMES = {
    "K1": lambda n: "cell_items_kernel" in n or "cell_rows_kernel" in n,
    "K2": lambda n: "row_sum_kernel<" in n and "Gather" in n,
}


def _kernels_among(rep, labels=("K1", "K2")) -> None:
    """Raise unless each of ``labels`` names a kernel among the report's
    top ops."""
    names = [t["op"] for t in rep["top_ops"]]
    for label in labels:
        if not any(KERNEL_NAMES[label](n) for n in names):
            raise AssertionError(f"profile.v1: no {label} kernel among "
                                 f"the top ops {names}")


@contextlib.contextmanager
def _knobs(**env):
    """The LUX_* telemetry knobs ``env`` set and the obs package
    re-reading them; unset and re-read after."""
    from lux_tpu_torch import obs

    old = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    obs.reconfigure()
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        obs.reconfigure()


def _counted_run(fn):
    """(fn(), its launches), the counts set to 0 just before."""
    import torch

    from lux_tpu_torch.ops import _cuda

    _cuda.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(_cuda.LAUNCHES)


def _add(totals, counts) -> None:
    for name, n in counts.items():
        totals[name] = totals.get(name, 0) + n


def _top_kernels(rep, n: int = 4) -> str:
    return "; ".join(f"{t['op'][:64]} {t['total_us']:.0f} us x{t['count']} "
                     f"[{t.get('tag') or '-'}]" for t in rep["top_ops"][:n])


def _telemetry_tiled(held, work) -> dict:
    """Phase 3l on phase 3's lane-select executor: ``run(10)`` with
    telemetry off and on (bitwise equal, equal launches, two flush
    windows), the cost of telemetry by CUDA events, the report's HBM
    rate against the card's row, and a capture of 3 iterations
    (``profile.v1``: K1 and K2 among the top kernels, the device idle
    share, steps per second against the recorder's). Returns the
    launches of its counted runs."""
    import torch

    from lux_tpu_torch.obs import prof, report

    ex, want = held["telemetry"].pop("tiled")
    vals = ex.init_values()
    metrics, trace = work / "tiled_metrics.jsonl", work / "tiled_trace.jsonl"
    totals = {}
    off, c_off = _counted_run(lambda: ex.run(ITERS, vals=vals))
    with _knobs(LUX_METRICS=metrics, LUX_TRACE=trace):
        on, c_on = _counted_run(lambda: ex.run(ITERS, vals=vals))
    check_equal("tiled run(10): telemetry on vs off", on, off)
    check_launches("tiled run(10), telemetry off", c_off, want)
    check_launches("tiled run(10), telemetry on", c_on, want)
    _add(totals, c_off)
    _add(totals, c_on)
    rec = report.read_last(str(metrics))
    spans = sorted({it["flush_span"] for it in rec["iterations"]})
    if rec["num_iters"] != ITERS or spans != [1, 2]:
        raise AssertionError(f"tiled record: {rec['num_iters']} iterations "
                             f"in flush windows {spans}, expected 2")
    events = [json.loads(ln) for ln in trace.read_text().splitlines()]
    flushes = sum(1 for e in events
                  if e.get("name") == "tiled.flush" and e.get("ph") == "B")
    if flushes != 2:
        raise AssertionError(f"tiled trace: {flushes} flush spans")
    roof = rec["roofline"]
    if roof["device_kind"] != torch.cuda.get_device_name():
        raise AssertionError(f"roofline priced {roof['device_kind']}")
    log(f"[telemetry] tiled run({ITERS}): on equals off bitwise, launches "
        f"equal; 2 flush windows; compile {rec['compile_s']:.4f} s "
        f"execute {rec['execute_s'] * 1e3:.3f} ms (host clock after the "
        f"window's wait); roofline on {roof['device_kind']}: "
        f"{roof.get('hbm_gbps', 0):.1f} GB/s of the byte model, hbm_frac "
        f"{roof.get('hbm_frac')} (peak "
        f"{report.device_profile()['hbm_peak_gbps']} GB/s, capacity "
        f"{roof.get('hbm_capacity_bytes')} B)")
    ms_off = cuda_ms(lambda: ex.run(ITERS, vals=vals), 3) / ITERS
    with _knobs(LUX_METRICS=metrics, LUX_TRACE=trace):
        ms_on = cuda_ms(lambda: ex.run(ITERS, vals=vals), 3) / ITERS
    log(f"[telemetry] tiled ms/iteration by CUDA events (mean of 3 "
        f"run({ITERS})): off {ms_off:.4f}, on {ms_on:.4f} "
        f"(+{(ms_on / ms_off - 1) * 100:.1f}%)")
    # A capture of 3 iterations, the recorder on.
    metrics3 = work / "tiled3.jsonl"
    with _knobs(LUX_METRICS=metrics3):
        (out, rep), c3 = _counted_run(lambda: prof.profile_window(
            lambda: ex.run(3, vals=vals), dirname=str(work / "prof_tiled"),
            steps=3,
            iterlog_summary=lambda: report.read_last(str(metrics3))))
    check_launches("tiled run(3) in a capture", c3,
                   {k: n * 3 // ITERS for k, n in want.items()})
    _add(totals, c3)
    _kernels_among(rep)
    (dev_rep,) = rep["devices"].values()
    st = rep["steps"]
    rate, il_rate = st["steps_per_s"], st["iterlog"]["steps_per_s"]
    if not (1 / 3 <= rate / il_rate <= 3):
        raise AssertionError(f"profile.v1 {rate:.1f} steps/s against the "
                             f"recorder's {il_rate:.1f}")
    log(f"[telemetry] capture of tiled run(3): {dev_rep['device']}, busy "
        f"{dev_rep['busy_us']:.0f} us over a {dev_rep['span_us']:.0f} us "
        f"span, idle share {dev_rep['idle_frac']:.3f}; {rate:.1f} steps/s "
        f"on the device span, {il_rate:.1f} by the recorder; top: "
        f"{_top_kernels(rep)}")
    return totals


def _telemetry_sharded(held, work) -> dict:
    """Phase 4l on phase 3e's compact sharded PageRank (P = 4): ``run(3)``
    under ``LUX_ENGOBS=1`` inside a capture, bitwise equal to the plain
    run, with exchange- and compute-tagged device time; its realized
    hidden share (0 on one stream). Returns the launches."""
    from lux_tpu_torch.obs import prof, report

    ex = held["telemetry"].pop("pull_sharded")
    vals = ex.init_values()
    plain, c_plain = _counted_run(lambda: ex.run(3, vals=vals))
    warm = getattr(ex, "_phases_warm", False)
    metrics = work / "sharded.jsonl"
    with _knobs(LUX_ENGOBS=1, LUX_METRICS=metrics):
        (out, rep), counts = _counted_run(lambda: prof.profile_window(
            lambda: ex.run(3, vals=vals), dirname=str(work / "prof_sharded"),
            steps=3, iterlog_summary=lambda: report.read_last(str(metrics))))
    check_equal("sharded pull run(3): phase-fenced vs plain", out, plain)
    p = ex.num_parts
    check_launches("sharded pull run(3)", c_plain,
                   {"gather_segment_sum": p * 3})
    check_launches("sharded pull run(3), phase-fenced", counts,
                   {"gather_segment_sum": p * (3 if warm else 4)})
    (dev_rep,) = rep["devices"].values()
    if not (dev_rep["exchange_us"] > 0 and dev_rep["compute_us"] > 0):
        raise AssertionError(f"profile.v1: exchange {dev_rep['exchange_us']}"
                             f" us, compute {dev_rep['compute_us']} us")
    rec = report.read_last(str(metrics))
    totals = {}
    _add(totals, c_plain)
    _add(totals, counts)
    log(f"[telemetry] sharded pull ({ex.exchange_mode}, P={p}) run(3) "
        f"phase-fenced in a capture: equals the plain run bitwise; device "
        f"exchange {dev_rep['exchange_us']:.0f} us, compute "
        f"{dev_rep['compute_us']:.0f} us, overlap "
        f"{dev_rep['overlap_us']:.0f} us, realized_hidden_frac "
        f"{rep['realized_hidden_frac']}, idle share "
        f"{dev_rep['idle_frac']:.3f}; the recorder's split: exchange_frac "
        f"{rec['phases']['exchange_frac']:.3f}, budget "
        f"{rec['phases'].get('exchange_hidden_frac')}; tags {rep['tags']}")
    return totals


def _telemetry_fixpoints(push_ctx, gas_ctx, work) -> dict:
    """Phase 5l: SSSP (phase 3b's executor) and BFS (phase 3d's) with a
    live recorder: values, iterations, sparse iterations and push/pull
    counts equal phases 5b and 5d's, each record's frontiers the
    counters the runs read, launches by the ledgers. Returns the
    launches."""
    from lux_tpu_torch.obs import report

    totals = {}
    for app, ex, ctx in (("sssp", push_ctx["sssp_ex"], push_ctx["sssp"]),
                         ("bfs", gas_ctx["bfs"].pop("ex"), gas_ctx["bfs"])):
        metrics = work / f"{app}.jsonl"
        with _knobs(LUX_METRICS=metrics):
            (st, iters), counts = _counted_run(lambda: ex.run(start=0))
        vals = ex.values(st)
        if iters != ctx["iters"] or not np.array_equal(vals, ctx["oracle"]):
            raise AssertionError(f"{app} with a recorder: {iters} "
                                 "iterations or its values differ")
        rec = report.read_last(str(metrics))
        branches = [it["branch"] for it in rec["iterations"]]
        fronts = [it["frontier"] for it in rec["iterations"]]
        if app == "sssp":
            log_ = ex.branch_log
            got = (branches.count("sparse"), branches.count("dense"))
            want = (ctx["sparse_iters"], iters - ctx["sparse_iters"])
            dense = sum(1 for b, _, _ in log_ if b == 0)
            check_launches(f"{app} with a recorder", counts, {
                "segment_minmax_relax": dense,
                "frontier_queue": sum(1 for b, c, _ in log_
                                      if b > 0 and c > 0),
                "queue_relax_scatter": sum(1 for b, c, e in log_
                                           if b > 0 and c > 0 and e > 0)})
        else:
            log_ = ex.direction_log
            got = (branches.count("push"), branches.count("pull"))
            want = (ctx["push_iters"], ctx["pull_iters"])
            check_launches(f"{app} with a recorder", counts,
                           _gas_expected(log_))
        # Iteration i left the frontier iteration i + 1 started from.
        if got != want or fronts[:-1] != [e[1] for e in log_[1:]] \
                or fronts[-1] != 0 or rec["num_iters"] != iters:
            raise AssertionError(f"{app} record: branches {got}, expected "
                                 f"{want}; frontiers {fronts}")
        _add(totals, counts)
        log(f"[telemetry] {app} with a recorder: {iters} iterations, "
            f"branches {branches} equal phase 5b/5d's ledger, frontiers "
            f"{fronts}; execute {rec['execute_s'] * 1e3:.3f} ms over "
            f"{max(it['flush_span'] for it in rec['iterations'])} flush "
            f"window(s), compile {rec['compile_s']:.3f} s")
    return totals


def _telemetry_cli(work, device_line: str, saved: dict) -> None:
    """Phase 6l: two CLI runs on phase 3i's files, each checkpoint
    bitwise equal to group 4i-6i's run without the flags: BFS with
    ``-metrics -trace`` (its record splits the one timed run into the
    warm-up's compile seconds and the execute seconds of its
    iterations), then tiled PageRank with ``-profile``, read by
    ``python -m lux_tpu_torch.tools.prof_summary``."""
    from lux_tpu_torch.obs import report

    g_lux = work / "g.lux"
    metrics, trace = work / "bfs_cli.jsonl", work / "bfs_cli_trace.jsonl"
    out, ck = _cli_run(work, device_line, "bfs telemetry", "bfs", "-file",
                       g_lux, "-start", 0, "-metrics", metrics, "-trace",
                       trace)
    want = saved["bfs"]
    if not np.array_equal(ck["values"], want["values"]) \
            or ck["iteration"] != want["iteration"]:
        raise AssertionError("cli bfs -metrics -trace: checkpoint differs")
    rec = report.read_last(str(metrics))
    elapsed = float(_cli_line(out, "ELAPSED TIME").split("=")[1].split()[0])
    r = subprocess.run([sys.executable, str(Path(__file__).parent / "tools"
                                            / "trace_summary.py"),
                        str(trace)], capture_output=True, text=True)
    if r.returncode != 0 or "gas.flush" not in r.stdout:
        raise AssertionError(f"trace_summary: {r.returncode} {r.stderr}")
    its = rec["iterations"]
    log(f"[telemetry] cli bfs -metrics -trace: checkpoint equals 4i-6i's "
        f"bitwise; ELAPSED TIME {elapsed * 1e3:.3f} ms = the recorder's "
        f"execute {rec['execute_s'] * 1e3:.3f} ms over {rec['num_iters']} "
        f"iterations ({rec['execute_s'] / rec['num_iters'] * 1e3:.3f} ms "
        f"each, flush windows {sorted({i['flush_span'] for i in its})}) + "
        f"{(elapsed - rec['execute_s']) * 1e3:.3f} ms outside it "
        f"(init_state, the run's set-up and finish); the warm-up's compile "
        f"{rec['compile_s']:.3f} s is outside ELAPSED TIME; branches "
        f"{[i.get('branch') for i in its]}; trace_summary reads the trace")
    prof_dir = work / "prof_cli"
    out, ck = _cli_run(work, device_line, "tiled pagerank profile",
                       "pagerank", "-file", g_lux, "-ni", ITERS, "-profile",
                       prof_dir)
    want = saved["tiled pagerank"]
    if not np.array_equal(ck["values"], want["values"]):
        raise AssertionError("cli pagerank -profile: checkpoint differs")
    r = subprocess.run([sys.executable, "-m",
                        "lux_tpu_torch.tools.prof_summary", str(prof_dir),
                        "--json"], capture_output=True, text=True,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    if r.returncode != 0:
        raise AssertionError(f"prof_summary: {r.stderr[-2000:]}")
    rep = json.loads(r.stdout)
    _kernels_among(rep)
    (dev_rep,) = rep["devices"].values()
    log(f"[telemetry] cli pagerank -profile: checkpoint equals 4i-6i's "
        f"bitwise; prof_summary: idle share {dev_rep['idle_frac']:.3f} "
        f"over a {dev_rep['span_us']:.0f} us device span; top: "
        f"{_top_kernels(rep)}")


# -- 3i-6i: the app CLIs, each a subprocess on the card ----------------------

CLI_TIMEOUT_S = 400
CLI_WORKERS = 3      # CLI subprocesses at a time in group 4i-6i


def _cli_files(work, graphs: dict, plan=None):
    """Phase 3i: each of ``graphs`` (name -> graph) written as
    ``<work>/<name>.lux`` and, with ``plan``, that plan saved where the
    tiled CLI looks for ``g.lux``'s (its default ``-levels`` and
    ``-tile-mb``), so the CLI loads it instead of planning again; returns
    the plan's path (group 4k-6k's ranks load it too)."""
    from lux_tpu_torch.graph import write_lux
    from lux_tpu_torch.models.cli import (
        _parse_levels,
        build_parser,
        plan_cache_path,
    )
    from lux_tpu_torch.ops.tiled_spmv import save_plan

    work.mkdir(parents=True, exist_ok=True)
    for name, graph in graphs.items():
        t = time.perf_counter()
        write_lux(str(work / f"{name}.lux"), graph)
        log(f"[cli] wrote {name}.lux (nv={graph.nv} ne={graph.ne}, "
            f"{(work / f'{name}.lux').stat().st_size} B) in "
            f"{time.perf_counter() - t:.1f} s")
    if plan is not None:
        args = build_parser("pagerank", push=False).parse_args(
            ["-file", str(work / "g.lux"), "-ni", "1"])
        path = plan_cache_path(args, _parse_levels(args.levels))
        t = time.perf_counter()
        save_plan(path, plan)
        log(f"[cli] phase 3's plan saved at the CLI's cache key "
            f"{os.path.basename(path)} in {time.perf_counter() - t:.1f} s "
            f"({plan.strip_bytes} B of strips); free disk "
            f"{shutil.disk_usage(work).free / 2**30:.1f} GiB")
        return path
    return None


def _native_io(work, g) -> None:
    """Phase 3i, the native host paths (``native/``) the CLIs, the
    sessions and the push CSRs go through: ``g.lux`` read natively and
    with numpy, and ``g``'s CSR built natively and with numpy, each pair
    bitwise equal, their seconds logged."""
    from lux_tpu_torch.graph.format import read_lux
    from lux_tpu_torch.native import io as native_io

    path = str(work / "g.lux")
    t = time.perf_counter()
    got = native_io.read_lux(path)
    native_s = time.perf_counter() - t
    t = time.perf_counter()
    want = read_lux(path)
    numpy_s = time.perf_counter() - t
    for name in ("row_ptr", "col_src"):
        a, b = getattr(got, name), getattr(want, name)
        if a.dtype != b.dtype or a.tobytes() != b.tobytes():
            raise AssertionError(f"native read: {name} differs from numpy's")
    del got, want
    t = time.perf_counter()
    got = g._csr_native()
    native_csr_s = time.perf_counter() - t
    t = time.perf_counter()
    want = g._csr_numpy()
    numpy_csr_s = time.perf_counter() - t
    if got is None:
        raise AssertionError("native CSR: the library did not run")
    for name in ("row_ptr", "col_dst"):
        a, b = getattr(got, name), getattr(want, name)
        if a.dtype != b.dtype or a.tobytes() != b.tobytes():
            raise AssertionError(f"native CSR: {name} differs from numpy's")
    log(f"[cli] native io: g.lux ({os.path.getsize(path)} B) read in "
        f"{native_s:.2f} s native, {numpy_s:.2f} s numpy; CSR of {g.ne} "
        f"edges built in {native_csr_s:.2f} s native, {numpy_csr_s:.2f} s "
        f"numpy; each pair bitwise equal")


def _cli_run(work, device_line: str, label: str, app: str, *argv):
    """``python -m lux_tpu_torch.models.<app> <argv> -save`` in a
    subprocess; raises unless it exits 0 and says it ran on the card.
    Returns (stdout, its checkpoint as a dict of arrays)."""
    ck = work / f"{label.replace(' ', '_')}.npz"
    cmd = [sys.executable, "-m", f"lux_tpu_torch.models.{app}",
           *(str(a) for a in argv), "-save", str(ck)]
    t = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True,
                       cwd=os.path.dirname(os.path.abspath(__file__)),
                       timeout=CLI_TIMEOUT_S)
    wall = time.perf_counter() - t
    if r.returncode != 0:
        raise AssertionError(
            f"cli {label}: {' '.join(cmd[2:])} exited {r.returncode}\n"
            f"{r.stdout[-3000:]}\n{r.stderr[-6000:]}")
    if device_line not in r.stderr:
        raise AssertionError(f"cli {label}: no '{device_line}' line; "
                             f"stderr:\n{r.stderr[-3000:]}")
    said = [ln for ln in r.stdout.splitlines()
            if ln.startswith(("ELAPSED TIME", "GTEPS", "iterations", "[",
                              "memory advisory"))]
    notes = [ln.split(": ", 1)[1] for ln in r.stderr.splitlines()
             if ln.split(": ", 1)[-1].startswith(
                 ("torch device:", "hybrid plan:", "loaded "))]
    log(f"[cli] {label}: {' '.join(cmd[2:-2])}: exit 0 in {wall:.1f} s "
        f"wall; {'; '.join(said)}; {'; '.join(notes)}")
    with np.load(ck) as z:
        return r.stdout, {k: z[k] for k in z.files}


def _cli_line(out: str, prefix: str) -> str:
    got = [ln for ln in out.splitlines() if ln.startswith(prefix)]
    if len(got) != 1:
        raise AssertionError(f"{len(got)} '{prefix}' lines in\n{out}")
    return got[0]


def _cli_phases(work, device_line: str, held: dict, push: dict,
                gas: dict) -> dict:
    """Phases 4i-6i: every app CLI on the files of phase 3i, each held
    against the in-process phase that ran its path: tiled, flat and
    sharded tiled PageRank against phases 5, 5c and 5g's ``run(10)``
    (rtol=5e-5, atol=1e-9), CF against 5c's ``run(5)`` (rtol=1e-4,
    atol=1e-7), SSSP (one device and 4 parts), CC, BFS and DeltaSSSP
    bitwise against 5b's and 5d's fixpoints with their iteration counts,
    and SSSP saved after 2 iterations and resumed bitwise against the
    uninterrupted run. The runs go ``CLI_WORKERS`` at a time (the resumed
    run after its first part), so their start-ups overlap; their wall
    seconds, ELAPSED TIME and GTEPS lines are logged beside the
    in-process times of phases 6-6h. Returns the checkpoints of tiled
    PageRank and BFS (group 3l-6l holds its runs against them)."""
    t_phase = time.perf_counter()
    g_lux, gu_lux, gw_lux, gc_lux = (work / f"{n}.lux"
                                     for n in ("g", "gu", "gw", "gc"))

    def run(label, app, *argv):
        return _cli_run(work, device_line, label, app, *argv)

    def close(label, got, want, rtol, atol, in_process):
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"cli {label}: {got.shape} {got.dtype}, "
                                 f"expected {want.shape} {want.dtype}")
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=f"cli {label}")
        err = float(np.max(np.abs(got.astype(np.float64) - want)))
        log(f"[cli] {label}: values within rtol={rtol}, atol={atol} of "
            f"{in_process} (max abs err {err:.3e})")

    def exact(label, out, saved, want, iters, in_process, ran=None):
        """Values bitwise ``want``, the checkpoint at iteration ``iters``
        with an empty frontier, and ``ran`` (default ``iters``)
        iterations said."""
        ran = iters if ran is None else ran
        if saved["values"].dtype != want.dtype or not np.array_equal(
                saved["values"], want):
            raise AssertionError(f"cli {label}: values differ from "
                                 f"{in_process}")
        if _cli_line(out, "iterations") != f"iterations = {ran}":
            raise AssertionError(f"cli {label}: {_cli_line(out, 'iter')}, "
                                 f"expected {ran}")
        if saved["iteration"] != iters or saved["frontier"].any():
            raise AssertionError(f"cli {label}: checkpoint at iteration "
                                 f"{saved['iteration']} with a frontier")
        log(f"[cli] {label}: values bitwise equal to {in_process}, "
            f"{iters} iterations")

    first = 2
    fix = (("sssp", "sssp", g_lux, push["sssp"], "5b 6b", ("-start", 0)),
           ("sharded sssp", "sssp", g_lux, push["sssp"], "5b 6f",
            ("-start", 0, "-parts", SHARDED_PARTS)),
           ("cc", "components", gu_lux, push["cc"], "5b 6b", ()),
           ("bfs", "bfs", g_lux, gas["bfs"], "5d 6d", ("-start", 0)),
           ("sssp_delta", "sssp_delta", gw_lux, gas["sssp_delta"], "5d 6d",
            ("-start", 0)))
    jobs = {
        "tiled pagerank": ("pagerank", "-file", g_lux, "-ni", ITERS,
                           "-check"),
        "sharded tiled pagerank": ("pagerank", "-file", g_lux, "-ni", ITERS,
                                   "-parts", SHARDED_PARTS),
        # The host f64 oracle over 100 M ratings costs minutes: no -check.
        "cf": ("colfilter", "-file", gc_lux, "-ni", CF_ITERS),
        "flat pagerank": ("pagerank", "-file", g_lux, "-ni", ITERS,
                          "-layout", "flat"),
    }
    for label, app, path, _, _, argv in fix:
        check = () if label == "sharded sssp" else ("-check",)
        jobs[label] = (app, "-file", path, *argv, *check)

    def sssp_resumed():
        """SSSP saved after 2 iterations, then resumed to its fixpoint."""
        part = run("sssp first 2", "sssp", "-file", g_lux, "-start", 0,
                   "-ni", first)
        return part, run("sssp resumed", "sssp", "-file", g_lux, "-start",
                         0, "-resume", work / "sssp_first_2.npz", "-check")

    with ThreadPoolExecutor(CLI_WORKERS) as pool:
        chained = pool.submit(sssp_resumed)
        futs = {label: pool.submit(run, label, *job)
                for label, job in jobs.items()}
        results = {label: f.result() for label, f in futs.items()}
        (_, part), resumed = chained.result()
    log(f"[cli] {len(results) + 2} runs, {CLI_WORKERS} at a time, in "
        f"{time.perf_counter() - t_phase:.1f} s")

    # Pull: PageRank in the three layouts, CF.
    out, saved = results["tiled pagerank"]
    _cli_line(out, "[PASS]")
    close("tiled pagerank", saved["values"], held["pagerank"]["values"],
          RTOL, ATOL, f"phase 5's run({ITERS})")
    out, saved = results["flat pagerank"]
    close("flat pagerank", saved["values"], held["flat"]["values"],
          RTOL, ATOL, f"phase 5c's run({ITERS})")
    out, saved = results["sharded tiled pagerank"]
    close("sharded tiled pagerank", saved["values"],
          held["sharded tiled"]["values"], RTOL, ATOL,
          f"phase 5g's full-mode run({ITERS})")
    log(f"[cli] in-process ms/iteration (CUDA events): tiled "
        f"{held['pagerank']['ms']:.3f} (phase 6), flat "
        f"{held['flat']['ms']:.3f} (6c), sharded tiled "
        f"{held['sharded tiled']['ms']:.3f} (6g)")
    out, saved = results["cf"]
    close("cf", saved["values"], held["cf"]["values"], CF_RTOL, CF_ATOL,
          f"phase 5c's run({CF_ITERS})")
    log(f"[cli] cf ran without -check (its host f64 oracle over the "
        f"ratings graph costs minutes); in-process "
        f"{held['cf']['ms']:.3f} ms/iteration (6c)")

    # Push and GAS: to fixpoint, bitwise.
    for label, app, path, want, phases, argv in fix:
        out, saved = results[label]
        if label != "sharded sssp":
            _cli_line(out, "[PASS]")
        held_in, ms_in = phases.split()
        exact(label, out, saved, want["oracle"], want["iters"],
              f"phase {held_in}'s fixpoint")
        in_ms = (held["sharded sssp"] if ms_in == "6f" else want)["ms"]
        log(f"[cli] {label}: in-process {in_ms:.3f} ms to fixpoint "
            f"(phase {ms_in})")

    # SSSP saved after 2 iterations, then resumed to its fixpoint.
    total = push["sssp"]["iters"]
    if part["iteration"] != first or not part["frontier"].any():
        raise AssertionError("cli sssp first 2: checkpoint at iteration "
                             f"{part['iteration']}, frontier "
                             f"{int(part['frontier'].sum())}")
    out, saved = resumed
    _cli_line(out, "[PASS]")
    exact("sssp resumed", out, saved, push["sssp"]["oracle"], total,
          "phase 5b's fixpoint", ran=total - first)
    log(f"[cli] sssp resumed: {first} + {total - first} iterations = the "
        f"uninterrupted run's {total}")
    log(f"[cli] phases 4i-6i took {time.perf_counter() - t_phase:.1f} s")
    return {"tiled pagerank": results["tiled pagerank"][1],
            "bfs": results["bfs"][1]}


# -- 3n-6n: the auto-tuner (tune/) on the card --------------------------------

TUNE_GROUP = "3n-6n tuner"
# 4n's search settings, logged: 12 of the 30 candidates (the tuner's
# default is 16; 12 keeps the script inside its 1,050 s budget), seeded,
# and 2 rungs.
TUNE_SHARDED_CANDIDATES = 12
TUNE_SHARDED_RUNGS = 2
TUNE_REPS = 3            # 6n: median of this many runs after warmup


@contextlib.contextmanager
def _counted_probes(runs: list):
    """Count each tuner probe's recorded run: every executor the probes
    build (``analysis/ir.py::build_executor``) has its ``run`` wrapped,
    the counts set to 0 just before and read just after. A single-device
    GAS probe's counts are checked against its direction log, as phase
    5d checks; a sharded probe runs phase-fenced (``LUX_ENGOBS=1``),
    leaves no log and its counts include ``warmup_phases``, so they are
    summed only (6n checks the sharded runs against their logs)."""
    from lux_tpu_torch.analysis import ir

    real = ir.build_executor

    def spy(kind, graph, program, **kw):
        ex = real(kind, graph, program, **kw)
        run = ex.run

        def counted(*a, **k):
            out, counts = _counted_run(lambda: run(*a, **k))
            if not kind.endswith("sharded"):
                check_launches(f"tune probe {len(runs)} ({kind})", counts,
                               _gas_expected(ex.direction_log))
            runs.append((kind, counts))
            return out

        ex.run = counted
        return ex

    ir.build_executor = spy
    try:
        yield
    finally:
        ir.build_executor = real


def _tune_log(label: str, art: dict) -> None:
    """Each probe of a search (rung, candidate, score, phase medians,
    switches, downgrades, build and run seconds) and the winner."""
    for r in art["score_table"]:
        d = r["detail"]
        log(f"[tune] {label} rung {r['rung']} candidate "
            f"{r['candidate_index']} {r['config']}: score "
            f"{r['score'] * 1e3:.4f} ms/iteration over {r['iters']} "
            f"iterations (medians: exchange {d['exchange_s_med'] * 1e3:.4f},"
            f" compute {d['compute_s_med'] * 1e3:.4f}, iteration "
            f"{d['t_iter_s_med'] * 1e3:.4f} ms; {d['direction_switches']} "
            f"switches, {d['exchange_downgrades']} downgrades); build "
            f"{d['build_s']:.2f} s, run {d['run_s']:.2f} s")
    t = art["tuner"]
    defaults = [r["score"] for r in art["score_table"]
                if r["candidate_index"] == 0]
    log(f"[tune] {label}: {len(art['score_table'])} probes of "
        f"{t['candidates']} candidates ({t['rungs']} rungs, eta {t['eta']},"
        f" {t['probe_iters']} iterations at rung 0, seed {t['seed']}) in "
        f"{t['search_s']:.1f} s; winner candidate {t['winner_index']} "
        f"{art['config']} at {art['score'] * 1e3:.4f} ms/iteration "
        f"(the defaults' last {defaults[-1] * 1e3:.4f}); {art['id']}")


def _check_artifact(label: str, art: dict, kind: str) -> None:
    """What holds whatever the timings: candidate 0 is the defaults and
    was probed first, the winner is the last rung's argmin (score, then
    index: LUX503) and the artifact checks with 0 findings."""
    from lux_tpu_torch.analysis import tuneck
    from lux_tpu_torch.tune import space

    rows = art["score_table"]
    if (rows[0]["candidate_index"], rows[0]["config"]) != (
            0, space.default_candidate(kind)):
        raise AssertionError(f"tune {label}: candidate 0 is {rows[0]}")
    last = max(r["rung"] for r in rows)
    best = min((r for r in rows if r["rung"] == last),
               key=lambda r: (r["score"], r["candidate_index"]))
    if best["config"] != art["config"] or best["score"] != art["score"]:
        raise AssertionError(f"tune {label}: winner {art['config']} is not "
                             f"the last rung's argmin {best['config']}")
    res = tuneck.verify_artifact(art)
    if res.findings or res.error:
        raise AssertionError(f"tune {label}: tuneck {res.findings} "
                             f"{res.error}")


def _tune_bfs(label, make, gas: dict, sharded: bool, dev) -> dict:
    """6n: one BFS executor from ``make()``: ``warmup``, a run to
    fixpoint with its launches checked against its direction log and its
    values, parents and iterations against phase 5d's, then the median
    of ``TUNE_REPS`` host-clock runs."""
    ex = make()
    ex.warmup(start=0)
    (st, iters), counts = _counted_run(lambda: ex.run(start=0))
    want = (_gas_sharded_expected(ex) if sharded
            else _gas_expected(ex.direction_log))
    check_launches(f"tune {label}", counts, want)
    vals = ex.gather_values(st) if sharded else ex.values(st)
    if not np.array_equal(vals, gas["bfs"]["oracle"]) \
            or iters != gas["bfs"]["iters"]:
        raise AssertionError(f"tune {label}: differs from phase 5d's BFS")
    if not np.array_equal(ex.finalize(st)["parent"], gas["bfs"]["parent"]):
        raise AssertionError(f"tune {label}: parents differ from 5d's")
    del st
    secs = sorted(host_seconds(lambda: ex.run(start=0))
                  for _ in range(TUNE_REPS))
    return {"ex": ex, "vals": vals, "counts": counts,
            "ms": secs[TUNE_REPS // 2] * 1e3,
            "log": [e[:4] for e in ex.direction_log]}


def _tune_phases(work, g, gas: dict, dev, smi: str) -> dict:
    """Group 3n-6n's search and timing. 3n: ``tune()`` for BFS (kind
    ``gas``) with real probes and the tuner's defaults on the weighted
    twin read back natively from ``gw.lux`` (the graph 5m's session
    serves; BFS reads no weights, so its answers are phase 5d's). 4n:
    ``tune()`` for BFS (kind ``gas_sharded``) over 4 parts of a
    ``LocalMesh`` on ``g`` (the graph 6m's session serves), every probe
    on one shared partition; then ``python -m
    lux_tpu_torch.tools.luxlint --tune`` over the store: 0 findings, rc
    0. 6n: the tuned and the default BFS executors of both searches to
    fixpoint, bitwise equal, medians of 3 after ``warmup``. Arms
    ``LUX_TUNE_DIR`` at the store for the sessions of 5n and 6m; returns
    their context and the group's launches."""
    import torch

    from lux_tpu_torch.engine.gas import AdaptiveExecutor
    from lux_tpu_torch.engine.gas_sharded import ShardedAdaptiveExecutor
    from lux_tpu_torch.models import BFS
    from lux_tpu_torch.native import io as native_io
    from lux_tpu_torch.parallel.mesh import make_mesh
    from lux_tpu_torch.parallel.shard import ShardedGraph
    from lux_tpu_torch.tune import tune, tune_cache
    from lux_tpu_torch.utils import flags
    from lux_tpu_torch.utils.checkpoint import fingerprint_hex

    store = work / "tune"
    shutil.rmtree(store, ignore_errors=True)
    os.environ["LUX_TUNE_DIR"] = str(store)
    tune_cache().clear()
    runs = []

    # -- 3n. BFS on one device, the tuner's defaults ---------------------------
    t = time.perf_counter()
    gw = native_io.read_lux(str(work / "gw.lux"))
    fp_w = fingerprint_hex(gw)
    log(f"[tune] 3n: gw.lux read back (native) and fingerprinted in "
        f"{time.perf_counter() - t:.1f} s")
    with _counted_probes(runs):
        single = tune(gw, BFS(), "gas", program_name="bfs",
                      graph_fingerprint=fp_w, mesh_shape="1",
                      init_kw={"start": 0}, build_kw={"device": dev})
    _tune_log("3n gas", single)
    _check_artifact("3n gas", single, "gas")
    tune_cache().put(single)

    # -- 4n. BFS over 4 parts of a LocalMesh -----------------------------------
    t = time.perf_counter()
    fp = fingerprint_hex(g)
    mesh = make_mesh(SHARDED_PARTS, dev)
    sg = ShardedGraph.build(g, SHARDED_PARTS)
    sg.exchange_plan()
    log(f"[tune] 4n: g fingerprinted, its {SHARDED_PARTS}-part layout and "
        f"compact plan built once for every probe in "
        f"{time.perf_counter() - t:.1f} s; LUX_TUNE_MAX_CANDIDATES="
        f"{TUNE_SHARDED_CANDIDATES}, LUX_TUNE_RUNGS={TUNE_SHARDED_RUNGS}")
    with flags.overrides({"LUX_TUNE_MAX_CANDIDATES": TUNE_SHARDED_CANDIDATES,
                          "LUX_TUNE_RUNGS": TUNE_SHARDED_RUNGS}), \
            _counted_probes(runs):
        sharded = tune(g, BFS(), "gas_sharded", program_name="bfs",
                       graph_fingerprint=fp, mesh_shape=str(SHARDED_PARTS),
                       init_kw={"start": 0},
                       build_kw={"mesh": mesh, "sg": sg})
    _tune_log("4n gas_sharded", sharded)
    _check_artifact("4n gas_sharded", sharded, "gas_sharded")
    tune_cache().put(sharded)
    t = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "lux_tpu_torch.tools.luxlint", "--tune",
         str(store)], capture_output=True, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)), timeout=120)
    summary = json.loads(r.stdout.rsplit("LUXLINT ", 1)[1])
    if r.returncode != 0 or summary["findings"] or summary["files"] != 2:
        raise AssertionError(f"luxlint --tune: rc {r.returncode}\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-2000:]}")
    log(f"[tune] 4n: python -m lux_tpu_torch.tools.luxlint --tune over the "
        f"store: rc 0, {summary['files']} artifacts, 0 findings in "
        f"{time.perf_counter() - t:.1f} s")
    totals = {}
    for kind, counts in runs:
        _add(totals, counts)
        if kind.endswith("sharded"):
            totals["gas_push_acc[sharded]"] = totals.get(
                "gas_push_acc[sharded]", 0) + counts["gas_push_acc"]
    log(f"[tune] 3n-4n: {len(runs)} probe runs, launches "
        f"{ {k: v for k, v in totals.items() if v} }; every single-device "
        "probe's equal to its direction log")
    for name in GAS_KERNELS:
        if totals.get(name, 0) <= 0:
            raise AssertionError(f"tune: {name} never ran in 3n-4n")

    # -- 6n. tuned against default, to fixpoint ---------------------------------
    for label, art, sharded_run, make in (
            ("gas", single, False,
             lambda: AdaptiveExecutor(gw, BFS(), device=dev)),
            ("gas_sharded", sharded, True,
             lambda: ShardedAdaptiveExecutor(g, BFS(), mesh=mesh, sg=sg))):
        with flags.overrides(art["config"]):
            tuned = _tune_bfs(f"{label} tuned", make, gas, sharded_run, dev)
        default = _tune_bfs(f"{label} default", make, gas, sharded_run, dev)
        ex, cfg = tuned["ex"], art["config"]
        if "LUX_GAS_DENSITY_HI" in cfg and (
                ex.hi_count != max(1, math.ceil(
                    float(cfg["LUX_GAS_DENSITY_HI"]) * g.nv))
                or ex.lo_count != max(0, math.ceil(
                    float(cfg["LUX_GAS_DENSITY_LO"]) * g.nv))):
            raise AssertionError(f"tune {label}: thresholds {ex.hi_count}/"
                                 f"{ex.lo_count} are not {cfg}'s")
        if "LUX_EXCHANGE" in cfg and ex.exchange_mode != cfg["LUX_EXCHANGE"]:
            raise AssertionError(f"tune {label}: exchange {ex.exchange_mode},"
                                 f" tuned {cfg['LUX_EXCHANGE']}")
        if not np.array_equal(tuned["vals"], default["vals"]):
            raise AssertionError(f"tune {label}: tuned differs from default")
        for run in (tuned, default):
            _add(totals, run["counts"])
            if sharded_run:
                totals["gas_push_acc[sharded]"] = totals.get(
                    "gas_push_acc[sharded]", 0) + run["counts"]["gas_push_acc"]
        log(f"[time] tune 6n {label}: BFS from 0 to fixpoint, tuned {cfg} "
            f"{tuned['ms']:.3f} ms against default {default['ms']:.3f} ms "
            f"(median of {TUNE_REPS} after warmup, host clock; "
            f"{gas['bfs']['iters']} iterations, values and parents bitwise "
            f"phase 5d's; ledgers tuned {tuned['log']}, default "
            f"{default['log']}); the search took "
            f"{art['tuner']['search_s']:.1f} s ({smi})")
        del tuned, default, ex
        torch.cuda.empty_cache()
    del sg, mesh
    torch.cuda.empty_cache()
    log(f"[tune] 3n-6n: launches of the probes and 6n's runs "
        f"{ {k: v for k, v in totals.items() if v} }")
    return {"gw": gw, "single": single, "sharded": sharded,
            "launches": totals}


# -- 3m-6m: serving (serve/) on the card --------------------------------------

SERVE_GROUP = "3m-6m serving"
SERVE_ROOTS = 64         # concurrent SSSP queries over HTTP (phase 4m)
SERVE_CLIENTS = 8        # client threads through the hot swap (phase 5m)
SERVE_SWAP_ROOTS = 32    # the roots they cycle through
SERVE_MESH_ROOTS = 16    # of phase 4m's roots, asked again of phase 6m's mesh
SERVE_MESH_PARTS = 4
SERVE_SAMPLE = 1 << 16   # served PageRank ranks held against the f64 oracle
SERVE_TIMEOUT_S = 600
# A batch of SERVE_ROOTS concurrent queries is formed within this window.
SERVE_WINDOW_MS = 20.0
# Kernels each in-process session must launch: flat PageRank (K8), the
# SSSP lanes (K10), dense and sparse SSSP (K5, K6); over the mesh the
# sharded tiled PageRank (K1, K2).
SERVE_SWAP_KERNELS = ("gather_segment_sum", "gas_pull_acc",
                      "segment_minmax_relax", "frontier_queue")
SERVE_MESH_KERNELS = ("strip_spmv", "tail_gather_sum", "gas_pull_acc",
                      "segment_minmax_relax")


def _post(base: str, payload: dict, timeout: float = SERVE_TIMEOUT_S):
    """(response JSON, seconds) of one POST /query."""
    import urllib.request

    req = urllib.request.Request(base + "/query",
                                 json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        out = json.loads(resp.read())
    return out, time.perf_counter() - t0


def _get(base: str, path: str):
    import urllib.request

    with urllib.request.urlopen(base + path, timeout=60) as resp:
        body = resp.read().decode()
    return body if path == "/metrics" else json.loads(body)


def _quantiles(secs) -> str:
    xs = np.asarray(secs) * 1e3
    return (f"p50 {np.percentile(xs, 50):.1f} ms, p99 "
            f"{np.percentile(xs, 99):.1f} ms over {len(xs)}")


def _serve_roots(g, n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    has_out = np.flatnonzero(g.out_degrees > 0)
    return [0] + sorted(int(r) for r in rng.choice(has_out, n - 1,
                                                   replace=False))


def _compiles(prom: str) -> dict:
    """Phase -> summed ``lux_xla_compiles_total`` of a /metrics page."""
    out = {}
    for line in prom.splitlines():
        if line.startswith("lux_xla_compiles_total{"):
            phase = line.split('phase="', 1)[1].split('"', 1)[0]
            out[phase] = out.get(phase, 0) + float(line.rsplit(" ", 1)[1])
    return out


def _serve_http(work, device_line: str, g, push: dict, gas: dict, oracle,
                held: dict, dev, smi: str) -> dict:
    """Phases 3m-4m: ``python -m lux_tpu_torch.serve.http -file g.lux
    -port 0`` as a subprocess on phase 3i's files (its tiled PageRank
    loads phase 3's plan from the CLI's cache key), then over HTTP:
    PageRank (``ni`` 10) held against phase 5's f64 oracle at
    ``SERVE_SAMPLE`` vertices and its digest against phase 5's run; 64
    concurrent SSSP roots, each bitwise (SHA-256 of the answer) a
    ``PushExecutor`` run from that root, with batches of more than 4
    lanes; CC, BFS, label propagation and k-core (the served default k =
    2, whose engine warmup built) bitwise against in-process runs (BFS
    and label propagation: phase 5d's); /metrics
    with zero serve-phase compiles, /stats with no pool build after
    warmup, /statusz. Returns the answers' digests (phase 6m holds the
    serving mesh against them)."""
    import re

    import torch

    from lux_tpu_torch.engine.gas import AdaptiveExecutor
    from lux_tpu_torch.engine.push import PushExecutor
    from lux_tpu_torch.models import ConnectedComponents, KCore
    from lux_tpu_torch.serve.http import digest

    # -- 3m. what the server must answer, then the server -------------------
    t = time.perf_counter()
    roots = _serve_roots(g, SERVE_ROOTS, SEED)
    sssp = push["sssp_ex"]
    want = {("sssp", r): digest(sssp.values(sssp.run(start=r)[0]))
            for r in roots}
    cc = PushExecutor(g, ConnectedComponents(), device=dev)
    want[("components",)] = digest(cc.values(cc.run()[0]))
    kc = AdaptiveExecutor(g, KCore(k=2), device=dev)
    want[("kcore", 2)] = digest(kc.values(kc.run()[0]))
    del cc, kc
    torch.cuda.empty_cache()
    want[("bfs", 0)] = digest(gas["bfs"]["oracle"])
    want[("labelprop",)] = digest(gas["labelprop"]["oracle"])
    log(f"[serve] in-process answers: {SERVE_ROOTS} SSSP roots (phase 3b's "
        f"executor), CC and k-core (k = 2) on g in "
        f"{time.perf_counter() - t:.1f} s")

    errlog = work / "serve_http.log"
    cmd = [sys.executable, "-m", "lux_tpu_torch.serve.http", "-file",
           str(work / "g.lux"), "-port", "0", "-window-ms",
           str(SERVE_WINDOW_MS), "-max-queue", "256", "-pagerank-iters",
           str(ITERS)]
    t0 = time.perf_counter()
    with open(errlog, "w") as err:
        proc = subprocess.Popen(
            cmd, stdout=subprocess.DEVNULL, stderr=err,
            cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        base = None
        while base is None:
            if proc.poll() is not None:
                raise AssertionError(
                    f"serve: {' '.join(cmd[2:])} exited {proc.returncode}"
                    f"\n{errlog.read_text()[-6000:]}")
            if time.perf_counter() - t0 > SERVE_TIMEOUT_S:
                raise AssertionError("serve: no 'serving ... on http' line "
                                     f"in {SERVE_TIMEOUT_S} s")
            m = re.search(r"on http://([\d.]+):(\d+)", errlog.read_text())
            if m:
                base = f"http://{m.group(1)}:{m.group(2)}"
            else:
                time.sleep(0.2)
        up_s = time.perf_counter() - t0
        text = errlog.read_text()
        if device_line not in text:
            raise AssertionError(f"serve: no '{device_line}' line:\n"
                                 f"{text[-3000:]}")
        health = _get(base, "/healthz")
        if not health["ok"] or health["nv"] != g.nv:
            raise AssertionError(f"serve: /healthz {health}")
        warm = re.findall(r"warmup (.+?): ([\d.]+)s", text)
        log(f"[serve] 3m: server up and warm in {up_s:.1f} s ({base}); "
            f"/healthz device {health['device']}, {health['engines']} "
            "engines; warmup s per engine: " + ", ".join(
                f"{k} {v}" for k, v in warm))
        for line in text.splitlines():
            if "hybrid plan" in line or line.split(": ", 1)[-1].startswith(
                    "loaded "):
                log(f"[serve] 3m: server: {line.split(': ', 1)[-1]}")
        pool0 = _get(base, "/stats")["pool"]

        # -- 4m. queries over HTTP ------------------------------------------
        lat = {}
        t = time.perf_counter()
        with ThreadPoolExecutor(SERVE_ROOTS) as pool:
            futs = {r: pool.submit(_post, base, {"app": "sssp", "start": r,
                                                 "digest": True})
                    for r in roots}
            got = {r: f.result() for r, f in futs.items()}
        wall = time.perf_counter() - t
        bad = [r for r in roots if got[r][0]["sha256"] != want[("sssp", r)]]
        if bad:
            raise AssertionError(f"serve: SSSP roots {bad[:8]} differ from "
                                 "their PushExecutor runs")
        lat["sssp"] = [s for _, s in got.values()]
        hist = _get(base, "/statusz")["batch_size"]
        wide = sum(b["count"] for b in hist["buckets"]
                   if b["le"] == "+Inf" or b["le"] > 4)
        if wide == 0:
            raise AssertionError(f"serve: no SSSP batch of more than 4 "
                                 f"lanes: {hist}")
        log(f"[serve] 4m: {SERVE_ROOTS} concurrent SSSP roots bitwise equal "
            f"to PushExecutor runs, in {wall:.2f} s: "
            f"{SERVE_ROOTS / wall:.1f} queries/s; latency "
            f"{_quantiles(lat['sssp'])}; batch sizes "
            f"{ {b['le']: b['count'] for b in hist['buckets'] if b['count']} }"
            f" ({smi})")

        sample = np.random.default_rng(SEED).choice(
            g.nv, min(SERVE_SAMPLE, g.nv), replace=False)
        out, lat["pagerank"] = _post(base, {"app": "pagerank", "ni": ITERS,
                                            "digest": True})
        part, _ = _post(base, {"app": "pagerank", "ni": ITERS,
                               "targets": sample.tolist()})
        np.testing.assert_allclose(np.asarray(part["values"], np.float64),
                                   oracle[sample], rtol=RTOL, atol=ATOL,
                                   err_msg="served pagerank vs f64 oracle")
        same = out["sha256"] == digest(held["pagerank"]["values"])
        want[("pagerank", ITERS)] = out["sha256"]
        log(f"[serve] 4m: pagerank ni={ITERS} within rtol={RTOL}, "
            f"atol={ATOL} of the f64 oracle at {len(sample)} vertices; "
            f"{'bitwise equal to' if same else 'not bitwise'} phase 5's "
            f"run({ITERS}); {lat['pagerank'] * 1e3:.1f} ms")
        for app, body, key, extra in (
                ("components", {}, ("components",), None),
                ("bfs", {"start": 0}, ("bfs", 0), "parent"),
                ("labelprop", {}, ("labelprop",), None),
                ("kcore", {"k": 2}, ("kcore", 2), None)):
            out, lat[app] = _post(base, {"app": app, "digest": True, **body})
            if out["sha256"] != want[key]:
                raise AssertionError(f"serve: {app} differs from its "
                                     "in-process run")
            if extra and out[extra + "_sha256"] != digest(
                    gas["bfs"]["parent"]):
                raise AssertionError(f"serve: {app} {extra} differs")
            if app in gas and out["iters"] != gas[app]["iters"]:
                raise AssertionError(f"serve: {app} took {out['iters']} "
                                     f"iterations, 5d {gas[app]['iters']}")
            log(f"[serve] 4m: {app} {body or ''} bitwise equal to the "
                f"in-process run in {out['iters']} iterations; "
                f"{lat[app] * 1e3:.1f} ms")

        prom = _get(base, "/metrics")
        comp = _compiles(prom)
        stats = _get(base, "/stats")
        sz = _get(base, "/statusz")
        if comp.get("serve", 0) != 0 or sz["counters"]["recompiles"] != 0:
            raise AssertionError(f"serve: compiles after warmup {comp}")
        if stats["pool"]["misses"] != pool0["misses"]:
            raise AssertionError(f"serve: pool built {stats['pool']['misses']}"
                                 f" engines, {pool0['misses']} at warmup")
        _check_gas_audit("4m (the HTTP server)", sz, stats["pool"], 0)
        win = sz["windows"][sorted(sz["windows"], key=lambda w: float(
            w.rstrip("s")))[-1]]
        log(f"[serve] 4m: /metrics compiles {comp} (the kernel library's "
            f"load at warmup); /stats pool {stats['pool']['engines']} "
            f"engines, {stats['pool']['misses']} builds, "
            f"{stats['pool']['hits']} hits; /statusz audits "
            f"{ {k: v['status'] for k, v in sz['audits'].items()} }")
        log("[serve] 4m: client latency per app: " + "; ".join(
            f"{app} " + (_quantiles(v) if isinstance(v, list)
                         else f"{v * 1e3:.1f} ms (one miss)")
            for app, v in lat.items()))
        log("[serve] 4m: /statusz window " + json.dumps(
            {app: {k: round(v * 1e3, 1) for k, v in q.items()
                   if k.startswith("p")} for app, q in win.items()})
            + " (ms)")
        mem = {k: v / 2**30 for k, v in sz["memory"].items()
               if k in ("device_peak_bytes", "hbm_capacity_bytes") and v}
        log(f"[serve] 4m: server device memory (GiB) {mem} ({smi})")
    finally:
        proc.send_signal(2)   # SIGINT: serve_forever ends, the session closes
        try:
            proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    if proc.returncode not in (0, -2):
        raise AssertionError(f"serve: exited {proc.returncode}:\n"
                             f"{errlog.read_text()[-3000:]}")
    return {"roots": roots, "digests": want}


def _check_gas_audit(label, statusz: dict, pool: dict, findings0) -> None:
    """The serving pool's program-algebra audit (``analysis/gasck.py``)
    ran on every build with no finding beyond ``findings0`` (its
    counter is process-wide), and ``/statusz``'s capability matrix came
    from the gascap.v1 artifact."""
    from lux_tpu_torch.serve.pool import GAS_AUDIT_STATUS

    audit, progs = statusz["audits"]["gasck"], statusz["programs"]
    if (audit["status"] != GAS_AUDIT_STATUS
            or audit["audited_builds"] != pool["misses"]
            or audit["findings"] != findings0
            or progs["gas_findings"] != findings0
            or progs["source"] != "artifact"):
        raise AssertionError(f"serve {label}: gasck audit {audit}, "
                             f"programs {progs}, {pool['misses']} builds")
    log(f"[serve] {label}: the pool's gasck audit ran on all "
        f"{audit['audited_builds']} builds, 0 findings; /statusz programs "
        f"from the artifact {progs['artifact_id']}")


def _serve_logs():
    """A handler collecting the ``lux_tpu_torch.serve`` log lines."""
    import logging

    class Keep(logging.Handler):
        def __init__(self):
            super().__init__()
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage())

    h = Keep()
    logging.getLogger("lux_tpu_torch.serve").addHandler(h)
    return h


def _weighted_edit_batch(graph):
    """``_edit_batch``'s 1% batch with insert weights drawn as the R-MAT
    generator draws its own: 1..100 from a generator of their own."""
    ed = _edit_batch(graph)
    w = np.random.default_rng(EDIT_SEED + 1).integers(
        1, 101, size=len(ed.ins_src), dtype=np.int32)
    return dataclasses.replace(ed, ins_w=w)


def _lane_digests(graph, roots, dev) -> dict:
    """root -> digest of its SSSP column from a fresh 8-lane
    ``MultiSourcePushExecutor`` (``len(roots)`` a multiple of 8)."""
    import torch

    from lux_tpu_torch.engine.push import MultiSourcePushExecutor
    from lux_tpu_torch.models import SSSP
    from lux_tpu_torch.serve.http import digest

    mx = MultiSourcePushExecutor(graph, SSSP(), k=8, device=dev)
    out = {}
    for i in range(0, len(roots), 8):
        st, _ = mx.run(roots[i:i + 8])
        for j, r in enumerate(roots[i:i + 8]):
            out[r] = digest(mx.values_for(st, j))
    del mx, st
    torch.cuda.empty_cache()
    return out


def _fallback_counts() -> dict:
    """app -> this process's ``lux_tune_fallback_total{app}``."""
    from lux_tpu_torch.obs import metrics

    return {m["labels"]["app"]: m["value"] for m in metrics.snapshot()
            if m["name"] == "lux_tune_fallback_total"}


def _serve_swap(work, dev, gas: dict, oracle, held: dict, smi: str,
                tuned: dict) -> dict:
    """Phase 5m: an in-process ``Session`` on the weighted twin read back
    from ``gw.lux`` (phase 3n's read; in memory, so PageRank takes the
    flat K8 path; DeltaSSSP served), held against phases 5c and 5d; then
    ``apply_edits`` of the 1% batch while ``SERVE_CLIENTS`` threads query
    SSSP over ``SERVE_SWAP_ROOTS`` roots: each answer bitwise version N's
    (a fresh 8-lane executor on N) until the flip and N+1's after it,
    none of N after a thread saw N+1; CC after the swap equal to a
    from-scratch run; no pool build and no compile on the serving path.
    With it, phase 5n: ``LUX_TUNE_DIR`` armed at 3n-4n's store, the BFS
    engine built under 3n's winner (its thresholds), ``tuned_for`` its
    id, every other app a counted fallback, BFS from 0 bitwise phase
    5d's; the swap evicts the tuned config and version N+1's BFS is a
    counted fallback. Returns the session's launches."""
    import threading

    import torch

    from lux_tpu_torch.obs import metrics
    from lux_tpu_torch.ops import _cuda
    from lux_tpu_torch.serve import ServeConfig, Session
    from lux_tpu_torch.serve.http import digest

    t = time.perf_counter()
    gw = tuned["gw"]
    edits = _weighted_edit_batch(gw)
    roots = _serve_roots(gw, SERVE_SWAP_ROOTS, SEED + 1)
    want = {0: _lane_digests(gw, roots, dev)}
    log(f"[serve] 5m: the 1% batch ({len(edits.ins_src)}"
        f" inserts, {len(edits.del_src)} deletes) and version N's "
        f"{SERVE_SWAP_ROOTS} SSSP answers in {time.perf_counter() - t:.1f} s")

    logs = _serve_logs()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    gas0 = metrics.counter("lux_gas_findings_total").value
    t = time.perf_counter()
    s = Session(gw, ServeConfig(max_batch=8, window_s=0.005, max_queue=256,
                                pagerank_iters=ITERS), device=dev)
    try:
        warm_s = time.perf_counter() - t
        log(f"[serve] 5m: session on gw warm in {warm_s:.1f} s; " + ", ".join(
            ln.replace("warmup ", "") for ln in logs.lines
            if ln.startswith("warmup ")))
        misses0 = s.pool.stats()["misses"]
        _tuned_session(s, tuned["single"], gas, warm_s)
        lat = {}
        t = time.perf_counter()
        pr = s.query("pagerank", ni=ITERS, timeout=SERVE_TIMEOUT_S)
        lat["pagerank"] = time.perf_counter() - t
        np.testing.assert_allclose(pr["values"], oracle, rtol=RTOL,
                                   atol=ATOL, err_msg="served flat pagerank")
        same = np.array_equal(pr["values"], held["flat"]["values"])
        t = time.perf_counter()
        ds = s.query("sssp_delta", start=0, timeout=SERVE_TIMEOUT_S)
        lat["sssp_delta"] = time.perf_counter() - t
        if not np.array_equal(ds["values"], gas["sssp_delta"]["oracle"]) \
                or ds["iters"] != gas["sssp_delta"]["iters"]:
            raise AssertionError("serve: sssp_delta differs from phase 5d")
        t = time.perf_counter()
        s.query("components", timeout=SERVE_TIMEOUT_S)
        lat["components"] = time.perf_counter() - t
        log(f"[serve] 5m: flat pagerank (K8) within rtol={RTOL}, atol={ATOL}"
            f" of the f64 oracle, {'bitwise equal to' if same else 'not '}"
            f" phase 5c's run({ITERS}); sssp_delta from 0 bitwise phase "
            f"5d's in {ds['iters']} iterations; latency (ms) " + ", ".join(
                f"{k} {v * 1e3:.1f}" for k, v in lat.items()))

        records, errors = [], []
        stop = threading.Event()

        def client(c):
            i = c
            while not stop.is_set():
                r = roots[i % len(roots)]
                v0 = s.version
                t0 = time.perf_counter()
                try:
                    vals = s.query("sssp", start=r,
                                   timeout=SERVE_TIMEOUT_S)["values"]
                except Exception as e:   # any failure fails the phase
                    errors.append(repr(e))
                    return
                records.append((c, r, v0, digest(vals), s.version,
                                time.perf_counter() - t0))
                i += SERVE_CLIENTS

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(SERVE_CLIENTS)]
        for th in threads:
            th.start()
        time.sleep(1.0)
        summary = s.apply_edits(edits)
        time.sleep(1.0)
        stop.set()
        for th in threads:
            th.join(SERVE_TIMEOUT_S)
        if errors:
            raise AssertionError(f"serve: queries failed in the swap: "
                                 f"{errors[:3]}")
        cc = s.query("components", timeout=SERVE_TIMEOUT_S)
        for r in roots[:8]:
            s.query("sssp", start=r, timeout=SERVE_TIMEOUT_S)
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        st = s.pool.stats()
        if st["recompiles"] != 0:
            raise AssertionError(f"serve: recompiles {st}")
        falls = _fallback_counts()
        if (summary["tunes_evicted"] < 1 or s.tuned_for("bfs") is not None
                or falls.get("bfs") != 1
                or "bfs" not in s.statusz()["tune"]["fallbacks"]):
            raise AssertionError(f"tune 5n: after the swap {summary} "
                                 f"{falls} {s.statusz()['tune']}")
        log(f"[tune] 5n: the swap evicted {summary['tunes_evicted']} tuned "
            f"configs; version {summary['version']}'s BFS serves under the "
            f"defaults, a counted fallback (lux_tune_fallback_total "
            f"{{app=bfs}} {falls['bfs']})")
        log(f"[serve] 5m: swap v0 -> v{summary['version']}: apply "
            f"{summary['apply_s']:.2f} s, warm {summary['warm_s']:.2f} s, "
            f"refresh {summary['refresh_s']:.2f} s "
            f"({summary['refreshed']}), flip + drain "
            f"{summary['flip_s']:.2f} s, total {summary['swap_s']:.2f} s; "
            f"evicted {summary['evicted']}, retired {summary['retired']}; "
            f"pool {misses0} builds at warmup, {st['misses']} after "
            f"(version N+1's warm), recompiles 0 ({smi})")
        # CC is refreshed when it is still cached at the swap (the
        # clients' answers, 4 bytes a vertex each, may have pushed it out
        # of the 64 MiB cache); either way it equals a from-scratch run.
        scratch = s._components_engine()
        if not np.array_equal(cc["values"],
                              scratch.values(scratch.run()[0])):
            raise AssertionError("serve: CC after the swap differs from a "
                                 "from-scratch run")
        misses1 = s.pool.stats()["misses"]
        _check_gas_audit("5m (the swap session)", s.statusz(),
                         s.pool.stats(), gas0)
        new_g = s.graph
    finally:
        s.close()
    if misses1 != st["misses"]:
        raise AssertionError("serve: a pool build after the swap")
    want[1] = _lane_digests(new_g, roots, dev)
    seen, by_version = {}, {0: 0, 1: 0}
    for c, r, v0, d, v1, _ in records:
        match = [v for v in (0, 1) if d == want[v][r]]
        if (not match or (v1 == 0 and 0 not in match)
                or (v0 == 1 and 1 not in match)
                or max(match) < seen.get(c, 0)):
            raise AssertionError(f"serve: client {c} root {r} (version "
                                 f"{v0}..{v1}) answered {match}")
        seen[c] = max(seen.get(c, 0), min(match))
        by_version[min(match)] += 1
    log(f"[serve] 5m: {len(records)} queries from {SERVE_CLIENTS} clients "
        f"through the swap, each bitwise its version's ({by_version[0]} "
        f"of N, {by_version[1]} of N+1); latency "
        f"{_quantiles([x[-1] for x in records])}; CC after the swap "
        f"({'refreshed' if cc.get('incremental') else 'recomputed'}) equals "
        f"a from-scratch run; peak device memory {peak / 2**30:.2f} GiB; "
        f"launches { {k: v for k, v in counts.items() if v} }")
    for name in SERVE_SWAP_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"serve: {name} never ran in phase 5m")
    del gw, new_g
    torch.cuda.empty_cache()
    return counts


def _tuned_session(s, art: dict, gas: dict, warm_s: float) -> None:
    """Phase 5n in 5m's session: BFS served under ``art``'s config (its
    engine's thresholds), every other app a counted fallback, BFS from 0
    bitwise phase 5d's with its parents, no build for it after warmup."""
    cfg = art["config"]
    misses = s.pool.stats()["misses"]
    if s.tuned_for("bfs") != {"id": art["id"], "score": art["score"]}:
        raise AssertionError(f"tune 5n: tuned_for {s.tuned_for('bfs')}")
    ex = s._gas_single("bfs")
    nv = s.graph.nv
    hi = max(1, math.ceil(float(cfg["LUX_GAS_DENSITY_HI"]) * nv))
    lo = max(0, math.ceil(float(cfg["LUX_GAS_DENSITY_LO"]) * nv))
    if (ex.hi_count, ex.lo_count) != (hi, lo):
        raise AssertionError(f"tune 5n: engine thresholds {ex.hi_count}/"
                             f"{ex.lo_count}, the artifact's {hi}/{lo}")
    tb = s.statusz()["tune"]
    falls = _fallback_counts()
    others = set(s.APPS) - {"bfs"}
    if (not tb["armed"] or tb["artifacts"]["bfs"]["id"] != art["id"]
            or set(tb["fallbacks"]) != others
            or falls != dict.fromkeys(others, 1)):
        raise AssertionError(f"tune 5n: {tb} {falls}")
    t = time.perf_counter()
    out = s.query("bfs", start=0, timeout=SERVE_TIMEOUT_S)
    took = time.perf_counter() - t
    if not np.array_equal(out["values"], gas["bfs"]["oracle"]) \
            or not np.array_equal(out["parent"], gas["bfs"]["parent"]):
        raise AssertionError("tune 5n: tuned BFS differs from phase 5d's")
    if s.pool.stats()["misses"] != misses:
        raise AssertionError("tune 5n: a pool build after warmup")
    log(f"[tune] 5n: the session (warm in {warm_s:.1f} s) serves bfs "
        f"under {art['id']} {cfg} (engine thresholds {hi}/{lo}); "
        f"{len(others)} apps counted fallbacks; BFS from 0 in "
        f"{took * 1e3:.1f} ms, {out['iters']} iterations, depths and parents "
        f"bitwise phase 5d's (and 6n's default-config run); no build after "
        f"warmup")


def _serve_mesh(work, dev, http: dict, oracle, smi: str,
                tuned: dict) -> dict:
    """Phase 6m: an in-process ``Session`` on ``g.lux`` with
    ``LUX_SERVE_MESH=4``: every engine sharded over 4 parts of a
    ``LocalMesh`` (PageRank the sharded tiled engine on phase 3's plan),
    each answer bitwise phase 4m's (PageRank within rtol, atol of the f64
    oracle), mesh keys on every pool entry, no build and no compile on
    the serving path; with ``LUX_TUNE_DIR`` armed, its BFS engine built
    under phase 4n's winner (its exchange mode and thresholds). Returns
    its launches."""
    import torch

    from lux_tpu_torch.ops import _cuda
    from lux_tpu_torch.serve import ServeConfig, Session
    from lux_tpu_torch.serve.http import digest

    logs = _serve_logs()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t = time.perf_counter()
    with _knobs(LUX_SERVE_MESH=SERVE_MESH_PARTS):
        s = Session(str(work / "g.lux"), ServeConfig(
            max_batch=8, window_s=SERVE_WINDOW_MS / 1e3, max_queue=256,
            pagerank_iters=ITERS), device=dev)
    try:
        warm_s = time.perf_counter() - t
        if s.meshspec.num_parts != SERVE_MESH_PARTS or not all(
                k[-1] == (SERVE_MESH_PARTS,) for k in s.pool.keys()):
            raise AssertionError(f"serve mesh: keys {s.pool.keys()}")
        if s.stats()["mesh"]["fallbacks"]:
            raise AssertionError(f"serve mesh: {s.stats()['mesh']}")
        art, bfs = tuned["sharded"], s._gas_single("bfs")
        cfg = art["config"]
        if (s.tuned_for("bfs") or {}).get("id") != art["id"] \
                or bfs.exchange_mode != cfg["LUX_EXCHANGE"] \
                or bfs.hi_count != max(1, math.ceil(
                    float(cfg["LUX_GAS_DENSITY_HI"]) * bfs.graph.nv)):
            raise AssertionError(f"serve mesh: bfs {bfs.exchange_mode} "
                                 f"{bfs.hi_count} under {s.tuned_for('bfs')}")
        log(f"[tune] 6m: the {SERVE_MESH_PARTS}-part session's BFS engine "
            f"is built under 4n's {art['id']} {cfg} (exchange "
            f"{bfs.exchange_mode}, hi/lo counts {bfs.hi_count}/"
            f"{bfs.lo_count})")
        log(f"[serve] 6m: {SERVE_MESH_PARTS}-part session warm in "
            f"{warm_s:.1f} s; " + ", ".join(
                ln.replace("warmup ", "") for ln in logs.lines
                if ln.startswith("warmup ")))
        misses0 = s.pool.stats()["misses"]
        want = http["digests"]
        t = time.perf_counter()
        roots = http["roots"][:SERVE_MESH_ROOTS]
        futs = [s.submit("sssp", start=r) for r in roots]
        for r, f in zip(roots, futs):
            if digest(f.result(SERVE_TIMEOUT_S)["values"]) \
                    != want[("sssp", r)]:
                raise AssertionError(f"serve mesh: sssp root {r} differs")
        lat = {"sssp": time.perf_counter() - t}
        for app, kw, key in (("components", {}, ("components",)),
                             ("bfs", {"start": 0}, ("bfs", 0)),
                             ("labelprop", {}, ("labelprop",)),
                             ("kcore", {"k": 2}, ("kcore", 2))):
            t = time.perf_counter()
            out = s.query(app, timeout=SERVE_TIMEOUT_S, **kw)
            lat[app] = time.perf_counter() - t
            if digest(out["values"]) != want[key]:
                raise AssertionError(f"serve mesh: {app} differs from 4m")
        t = time.perf_counter()
        pr = s.query("pagerank", ni=ITERS, timeout=SERVE_TIMEOUT_S)
        lat["pagerank"] = time.perf_counter() - t
        np.testing.assert_allclose(pr["values"], oracle, rtol=RTOL,
                                   atol=ATOL, err_msg="mesh pagerank")
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        st = s.pool.stats()
        if st["misses"] != misses0 or st["recompiles"] != 0:
            raise AssertionError(f"serve mesh: pool {st}")
        same = digest(pr["values"]) == want[("pagerank", ITERS)]
        log(f"[serve] 6m: {SERVE_MESH_ROOTS} SSSP roots, CC, BFS, label "
            f"propagation and k-core bitwise phase 4m's; sharded tiled "
            f"pagerank within rtol={RTOL}, atol={ATOL} of the f64 oracle "
            f"({'bitwise' if same else 'not bitwise'} 4m's); latency (ms) "
            + ", ".join(
                f"{k} {v * 1e3:.1f}" for k, v in lat.items())
            + f"; exchange bytes/iteration {s.mesh_exchange_bytes()}; peak "
            f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
            f"GiB; launches { {k: v for k, v in counts.items() if v} } "
            f"({smi})")
        _pool_exchange_audit(s)
        _pool_ir_audit(s)
    finally:
        s.close()
    for name in SERVE_MESH_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"serve mesh: {name} never ran")
    torch.cuda.empty_cache()
    return counts


def _pool_exchange_audit(s) -> None:
    """Group 2q in 6m's session: the pool's exchange-plan audit
    (``analysis/exchck.py``) read every build that carries a compact
    plan, with 0 findings. The session's engines exchange in full (4n's
    winner included, when it is full), so one compact sharded tiled
    PageRank engine on the session's own hybrid plan joins its pool and
    must audit clean too."""
    from lux_tpu_torch.engine.tiled_sharded import ShardedTiledExecutor
    from lux_tpu_torch.models.pagerank import PageRank

    pool = s.pool
    before = pool.audits()["exchck"]
    snap = s.store.current()
    plan = s._pagerank_engine(snap).plan    # the session's, a pool hit
    t = time.perf_counter()
    with _knobs(LUX_EXCHANGE="compact"):
        ex = pool.get(("smoke", "pagerank", "compact", snap.fingerprint),
                      lambda: ShardedTiledExecutor(
                          snap.graph, PageRank(), mesh=s.meshspec.mesh,
                          plan=plan))
    took = time.perf_counter() - t
    if ex._xplan is None:
        raise AssertionError("6m: the compact engine resolved full")
    with pool._lock:
        compact = sum(getattr(e, "_xplan", None) is not None
                      for e in pool._engines.values())
    a = pool.audits()["exchck"]
    if (not a["requested"] or a["audited_builds"] != compact
            or a["findings"] != before["findings"]
            or pool.stats()["exch_findings"] != a["findings"]):
        raise AssertionError(f"6m: exchange audit {before} -> {a}, "
                             f"{compact} compact builds")
    log(f"[lint] 6m: the pool's exchange audit read {a['audited_builds']} "
        f"compact build(s) of {len(pool)} (the session's "
        f"{before['audited_builds']} and a compact sharded tiled PageRank "
        f"engine on the session's plan, built, warmed and audited in "
        f"{took:.1f} s), 0 findings; audits.exchck {a['status']!r}")


def _pool_ir_audit(s) -> None:
    """Group 2r in 6m's session: the pool's LUX104 donation audit
    (``analysis/ir.py::audit_engine``) read the declaration of every
    build with a ``trace_step`` (every engine of the port has one) and
    ran the step of each that donates, with 0 findings. Each served
    engine's declaration is then held against one run of its step on
    the card: the args whose storage an output reuses are exactly the
    donated ones. Logs the seconds of the pool's declaration reads, of
    the example states they no longer build, and of the steps."""
    import torch

    from lux_tpu_torch.analysis import ir, trace
    from lux_tpu_torch.serve.pool import engine_stream

    pool = s.pool
    with pool._lock:
        engines = [(k, e) for k, e in pool._engines.items()
                   if hasattr(e, "trace_step")]
    a = pool.audits()["ir"]
    if (not a["requested"] or not engines
            or a["audited_builds"] + a["undonated_builds"] != len(engines)
            or a["findings"] or pool.stats()["ir_findings"]):
        raise AssertionError(f"6m: IR audit {a}, {len(engines)} builds "
                             "with a trace_step")
    read_s = args_s = step_s = 0.0
    for key, e in engines:
        t = time.perf_counter()
        target = ir.engine_target(e, f"pool@{key}")
        read_s += time.perf_counter() - t
        with engine_stream(getattr(e, "device", None)):
            t = time.perf_counter()
            args = target.example_args()     # built for this run alone
            torch.cuda.synchronize()
            args_s += time.perf_counter() - t
            t = time.perf_counter()
            run = trace.bare_call(target.call, args)
            torch.cuda.synchronize()
            step_s += time.perf_counter() - t
        outs = {r.lid for r in run.out_leaves if isinstance(r, trace.Ref)}
        reused = {i for i, lids in enumerate(run.arg_lids)
                  if lids and lids <= outs}
        if reused != set(target.donate):
            raise AssertionError(f"6m: {target.name} declares donate="
                                 f"{target.donate}, its step reuses "
                                 f"args {sorted(reused)}")
        del target, args, run
    log(f"[trace] 6m: the pool's LUX104 audit read the declaration of "
        f"{len(engines)} build(s) of {len(pool)} ({a['undonated_builds']} "
        f"donate nothing: no state built, no step run; "
        f"{a['audited_builds']} steps run), 0 findings; each declaration "
        f"exact against its step on the card; seconds over the "
        f"{len(engines)}: declarations {read_s:.4f}, the example states "
        f"an audit that runs steps builds {args_s:.4f}, their steps "
        f"{step_s:.4f}; audits.ir {a['status']!r}")

if __name__ == "__main__":
    sys.exit(main())
