"""Seeded LUX705 violation: a full-exchange step whose traced
all-gather stages a real buffer, but whose ``exchange_bytes`` claim
(the figure ``exchange_bytes_per_iter()`` would report to serving and
the exchange gate) matches none of the collectives the step performs.
The peak the walk prices and the claim observability reports have
diverged — one of them is lying.

The port's counterpart of
``tests/mem_fixtures/lux705_divergent_exchange_claim.py``. Loaded by
``python -m lux_tpu_torch.tools.luxlint --memory <this file>`` (on the
card, or on the CPU with ``LUX_PLATFORM=cpu``); the CLI must exit 1 with
exactly LUX705.
"""

import torch

from lux_tpu_torch.parallel.mesh import LocalMesh
from lux_tpu_torch.utils.platform import platform_device

DEV = platform_device()
MESH = LocalMesh(8, DEV)


def _step(vals):
    got = MESH.all_gather(vals)
    return torch.minimum(vals, got.view(8, 16).amin(dim=0))


TARGETS = {
    "fixture@lux705": {
        "call": _step,
        "args": (torch.zeros(8, 16, device=DEV),),
        "carry": (0,),
        "sharded": True,
        "exchange_mode": "full",
        # expect: LUX705 -- the traced all-gather moves 8*7*16*4 bytes
        "exchange_bytes": 12345,
        "num_parts": 8,
        "nv": 16,
        "ne": 16,
    },
}
