"""lux_tpu_torch — the PyTorch/CUDA port of ``lux_tpu``, for one NVIDIA H100.

The JAX package ``lux_tpu`` stays the reference; this package mirrors its
module paths so each counterpart is easy to find, and imports ``torch``
and numpy only — never JAX and nothing of ``lux_tpu`` (its numpy-only
host code is copied here, and tests hold the copies byte-identical).

Ported so far: the tiled pull executor (``engine.tiled``) with PageRank,
the graph core (``graph``), the hybrid strip/tail plan, the grouped
merge-network tail, the single-device push engine
(``engine.push.PushExecutor``) with SSSP and Connected Components, the
flat pull engine (``engine.pull.PullExecutor``) with Collaborative
Filtering and flat PageRank, and the direction-adaptive GAS engine
(``engine.gas.AdaptiveExecutor``, ``MultiSourceGasExecutor``) with BFS,
DeltaSSSP, label propagation and k-core, the multi-source push engine
(``engine.push.MultiSourcePushExecutor``), and the sharded pull and push
engines (``engine.pull_sharded.ShardedPullExecutor`` with PageRank and
CF; ``engine.push_sharded.ShardedPushExecutor`` and
``ShardedMultiSourcePushExecutor`` with SSSP and CC) over the P parts of
an edge-balanced partition, and the sharded tiled engine
(``engine.tiled_sharded.ShardedTiledExecutor``, tiled PageRank over the
P parts of a snake-dealt block partition), on one device
(``parallel.mesh.LocalMesh``); and the H100 gather probes
(``probes``), the counterparts of the TPU probes under ``tools/``.
Device work runs in
hand-written CUDA kernels under ``csrc/`` (built at first use, see
:mod:`lux_tpu_torch.ops._cuda`); each kernel has a plain-PyTorch version
beside its wrapper, which runs only for tensors on the CPU.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without an explicit device they raise.

Layout:
    lux_tpu_torch.graph   — .lux format, Graph data model, generators,
                            edge-balanced partition, exchange plan
    lux_tpu_torch.ops     — plans, kernel wrappers and their plain versions
    lux_tpu_torch.parallel — sharded layout, the parts axis (LocalMesh)
    lux_tpu_torch.engine  — vertex-program base classes, tiled, push,
                            multi-source push, flat pull, GAS, sharded
                            pull, sharded push and sharded tiled
                            executors, result checker
    lux_tpu_torch.probes  — the gather probes (P2-P7) and their kernels
    lux_tpu_torch.models  — the eight programs and their registry, the
                            app CLIs
    lux_tpu_torch.obs     — telemetry: run recorder, report, ledger,
                            flight recorder, engobs, profiler captures
    lux_tpu_torch.serve   — serving: the warm-engine Session, its pool,
                            batcher, cache, breaker, cost accounts,
                            serving mesh and HTTP front end
    lux_tpu_torch.analysis — the lint tiers (AST, threads, grouped-tail
                            and exchange plans, tune artifacts, program
                            contracts), the recompile sentinel and
                            HostTransferGuard, build_executor
    lux_tpu_torch.tune    — the auto-tuner: knob space, probes, search,
                            tuneconf.v1 artifacts and their cache
    lux_tpu_torch.native  — the C++ .lux reader, converter and CSR build
                            (g++ on first use), numpy as the fallback
    lux_tpu_torch.tools   — the converter, prof_summary and luxlint
    lux_tpu_torch.utils   — flags, device resolution, loggers
"""

__version__ = "0.1.0"
