"""Seeded LUX406 violation: the step's one all-gather moves
P*(P-1)*n*4 = 4*3*64*4 = 3072 bytes per iteration, but the executor
metadata claims 1024 — the kind of silent drift that makes every
downstream bandwidth model (ledger, bench gate, perf sheet) wrong while
results stay bit-correct.

The port's counterpart of ``tests/exch_fixtures/lux406_bytes.py``.
Loaded by ``python -m lux_tpu_torch.tools.luxlint --exchange <this
file>`` (on the card, or on the CPU with ``LUX_PLATFORM=cpu``); must
exit 1 with exactly LUX406.
"""

import torch

from lux_tpu_torch.parallel.mesh import LocalMesh
from lux_tpu_torch.utils.platform import platform_device

DEV = platform_device()
MESH = LocalMesh(4, DEV)
N = 64
OWN = torch.arange(N, device=DEV)
REMOTE = torch.arange(N, 2 * N, device=DEV)


def _step_honest_overlap(vals):
    tbl = MESH.all_gather(vals)
    merged = vals.new_zeros(vals.numel())
    merged.index_copy_(0, REMOTE, tbl[N:2 * N] + 1.0)
    merged.index_copy_(0, OWN, vals.reshape(-1)[:N] * 0.5)
    return merged.view(vals.shape)


TRACES = [
    {
        "name": "fixture@lux406-understated-bytes",
        "call": _step_honest_overlap,
        "args": (torch.zeros(4, N, device=DEV),),
        "carry": (0,),
        "sharded": True,
        "exchange_mode": "compact",
        # expect: LUX406 (the trace's collective moves 3072 B/iter)
        "exchange_bytes": 1024,
        "num_parts": 4,
    },
]
