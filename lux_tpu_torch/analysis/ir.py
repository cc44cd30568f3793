"""The executor registry of the IR tier, the counterpart of
``lux_tpu/analysis/ir.py::build_executor``.

``lux_tpu``'s IR tier traces every registered program on every capable
executor kind and runs its jaxpr rules (LUX101-105) over the traces.
That tier waits for the lint tiers (ROADMAP A16), which will extend this
module with a torch mechanism in place of jaxpr liveness. What is here
already is the one piece other modules use: :func:`build_executor`, one
executor of any kind in ``models.ENGINE_KINDS``, which the tuner's
probes build under their flag overlays (``tune/probe.py``).
"""

from __future__ import annotations

__all__ = ["build_executor"]


def build_executor(kind: str, graph, program, **kw):
    """One executor of the given kind over (graph, program) — the same
    constructions the CLIs and serving use, defaults throughout. ``kw``
    goes to the constructor: ``device`` for every kind (``cuda`` unless
    named); ``mesh`` and a prebuilt partition ``sg`` for the sharded
    kinds (``tiled_sharded`` takes a ``plan`` instead of an ``sg``).
    The multi-source kinds take K = 4 lanes, as ``lux_tpu``'s."""
    if kind == "pull":
        from lux_tpu_torch.engine.pull import PullExecutor
        return PullExecutor(graph, program, **kw)
    if kind == "tiled":
        from lux_tpu_torch.engine.tiled import TiledPullExecutor
        return TiledPullExecutor(graph, program, **kw)
    if kind == "push":
        from lux_tpu_torch.engine.push import PushExecutor
        return PushExecutor(graph, program, **kw)
    if kind == "push_multi":
        from lux_tpu_torch.engine.push import MultiSourcePushExecutor
        return MultiSourcePushExecutor(graph, program, k=4, **kw)
    if kind == "push_incremental":
        from lux_tpu_torch.engine.incremental import IncrementalExecutor
        return IncrementalExecutor(graph, program, **kw)
    if kind == "pull_sharded":
        from lux_tpu_torch.engine.pull_sharded import ShardedPullExecutor
        return ShardedPullExecutor(graph, program, **kw)
    if kind == "tiled_sharded":
        from lux_tpu_torch.engine.tiled_sharded import ShardedTiledExecutor
        return ShardedTiledExecutor(graph, program, **kw)
    if kind == "push_sharded":
        from lux_tpu_torch.engine.push_sharded import ShardedPushExecutor
        return ShardedPushExecutor(graph, program, **kw)
    if kind == "push_multi_sharded":
        from lux_tpu_torch.engine.push_sharded import (
            ShardedMultiSourcePushExecutor)
        return ShardedMultiSourcePushExecutor(graph, program, k=4, **kw)
    if kind == "gas":
        from lux_tpu_torch.engine.gas import AdaptiveExecutor, as_gas
        return AdaptiveExecutor(graph, as_gas(program), **kw)
    if kind == "gas_multi":
        from lux_tpu_torch.engine.gas import MultiSourceGasExecutor
        return MultiSourceGasExecutor(graph, program, k=4, **kw)
    if kind == "gas_sharded":
        from lux_tpu_torch.engine.gas_sharded import ShardedAdaptiveExecutor
        return ShardedAdaptiveExecutor(graph, program, **kw)
    if kind == "gas_multi_sharded":
        from lux_tpu_torch.engine.gas_sharded import (
            ShardedMultiSourceGasExecutor)
        return ShardedMultiSourceGasExecutor(graph, program, k=4, **kw)
    raise ValueError(f"unknown executor kind {kind!r}")
