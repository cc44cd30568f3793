"""Seeded LUX103 violation: an (n,) x (n,) outer product materializes
an (n, n) intermediate — n times the step's inputs, the O(nnz)
broadcast class of bugs.

The port's counterpart of ``tests/ir_fixtures/lux103_blowup.py``.
Loaded by ``python -m lux_tpu_torch.tools.luxlint --ir <this file>``
(on the card, or on the CPU with ``LUX_PLATFORM=cpu``); the CLI must
exit 1.
"""

import torch

from lux_tpu_torch.utils.platform import platform_device

DEV = platform_device()


def _step(vals):
    # expect: LUX103
    pairwise = torch.outer(vals, vals)     # (512, 512) from two (512,)
    return pairwise.sum(dim=1)


TRACES = [{
    "name": "fixture@lux103",
    "call": _step,
    "args": (torch.zeros(512, device=DEV),),
    "carry": (0,),
    "sharded": False,
}]
