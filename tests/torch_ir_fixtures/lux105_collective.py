"""Seeded LUX105 violations, both directions: an all-gather in a trace
declared single-shard (dead cross-device traffic), and a trace declared
sharded that never communicates (stale neighbor values forever).

The port's counterpart of ``tests/ir_fixtures/lux105_collective.py``.
Loaded by ``python -m lux_tpu_torch.tools.luxlint --ir <this file>``
(on the card, or on the CPU with ``LUX_PLATFORM=cpu``); the CLI must
exit 1.
"""

import torch

from lux_tpu_torch.parallel.mesh import LocalMesh
from lux_tpu_torch.utils.platform import platform_device

DEV = platform_device()
MESH = LocalMesh(4, DEV)


def _step_with_gather(vals):
    # expect: LUX105 (collective in a single-shard trace)
    return MESH.all_gather(vals).view(vals.shape) * 1.0


def _step_without_exchange(vals):
    # expect: LUX105 (sharded trace with no collective)
    return vals * 0.85 + 0.15


TRACES = [
    {
        "name": "fixture@lux105-single-shard-gather",
        "call": _step_with_gather,
        "args": (torch.zeros(4, 16, device=DEV),),
        "carry": (0,),
        "sharded": False,
    },
    {
        "name": "fixture@lux105-sharded-no-collective",
        "call": _step_without_exchange,
        "args": (torch.zeros(64, device=DEV),),
        "carry": (0,),
        "sharded": True,
    },
]
