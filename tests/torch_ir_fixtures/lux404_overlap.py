"""Seeded LUX404 violation: a compact-mode step whose "local" side is
read from the gathered table — every write of the local/remote merge
then transitively consumes the collective's result, so nothing is left
to overlap with the wire time. This is exactly the regression the
overlap proof exists to catch (the real engines write each receiver's
own span from its own shard, ``parallel/mesh.py::CompactExchange``).

The port's counterpart of ``tests/exch_fixtures/lux404_overlap.py``.
Loaded by ``python -m lux_tpu_torch.tools.luxlint --exchange <this
file>`` (on the card, or on the CPU with ``LUX_PLATFORM=cpu``); must
exit 1 with exactly LUX404.
"""

import torch

from lux_tpu_torch.parallel.mesh import LocalMesh
from lux_tpu_torch.utils.platform import platform_device

DEV = platform_device()
MESH = LocalMesh(4, DEV)
N = 64
OWN = torch.arange(N, device=DEV)
REMOTE = torch.arange(N, 2 * N, device=DEV)


def _step_gathered_first(vals):
    tbl = MESH.all_gather(vals)
    # expect: LUX404 (the "local" side is computed FROM the gathered
    # table, so the merge depends on the collective on every data side)
    local = tbl[:N] * 0.5
    remote = tbl[N:2 * N] + 1.0
    merged = vals.new_zeros(vals.numel())
    merged.index_copy_(0, REMOTE, remote)
    merged.index_copy_(0, OWN, local)
    return merged.view(vals.shape)


TRACES = [
    {
        "name": "fixture@lux404-local-reads-gathered",
        "call": _step_gathered_first,
        "args": (torch.zeros(4, N, device=DEV),),
        "carry": (0,),
        "sharded": True,
        "exchange_mode": "compact",
        "num_parts": 4,
    },
]
