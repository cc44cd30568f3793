"""Seeded LUX405 violation: a compact-mode min-combiner step that pads
the exchanged candidates with 0.0 instead of the min identity (+inf).
Every padded slot would then win the minimum and overwrite a real
distance with zero. The step keeps an honest local/remote merge so the
overlap proof (LUX404) stays green — only the annihilator check fires.

The port's counterpart of ``tests/exch_fixtures/lux405_sentinel.py``.
Loaded by ``python -m lux_tpu_torch.tools.luxlint --exchange <this
file>`` (on the card, or on the CPU with ``LUX_PLATFORM=cpu``); must
exit 1 with exactly LUX405.
"""

import torch

from lux_tpu_torch.parallel.mesh import LocalMesh
from lux_tpu_torch.utils.platform import platform_device

DEV = platform_device()
MESH = LocalMesh(4, DEV)
N = 64
OWN = torch.arange(N, device=DEV)
REMOTE = torch.arange(N, 2 * N, device=DEV)


def _step_zero_pad(vals):
    got = MESH.all_to_all(vals).reshape(-1)
    # expect: LUX405 (pad constant 0.0; the min identity is +inf)
    table = vals.new_zeros(vals.numel())
    table.index_copy_(0, REMOTE, got[N:2 * N])
    table.index_copy_(0, OWN, vals.reshape(-1)[:N] * 0.5)
    return torch.minimum(table.view(vals.shape), vals)


TRACES = [
    {
        "name": "fixture@lux405-zero-pad-min",
        "call": _step_zero_pad,
        "args": (torch.zeros(4, N, device=DEV),),
        "carry": (0,),
        "sharded": True,
        "exchange_mode": "compact",
        "combiner": "min",
        "value_dtype": "float32",
        "num_parts": 4,
    },
]
