"""Seeded LUX703 violation: an honest step over 4096-vertex float32
state (~16 KiB live) against a declared device capacity of 1 KiB. The
derived model predicts a peak that cannot fit, and the budget rule
fails closed here — offline — instead of running the card out of
memory.

The port's counterpart of ``tests/mem_fixtures/lux703_overcommit.py``.
Loaded by ``python -m lux_tpu_torch.tools.luxlint --memory <this file>``
(on the card, or on the CPU with ``LUX_PLATFORM=cpu``); the CLI must
exit 1 with exactly LUX703.
"""

import torch

from lux_tpu_torch.utils.platform import platform_device

DEV = platform_device()


def _step(vals):
    return torch.minimum(vals, vals.flip(0))


# expect: LUX703
CAPACITY_BYTES = 1024

TARGETS = {
    "fixture@lux703": {
        "call": _step,
        "args": (torch.zeros(4096, device=DEV),),
        "carry": (0,),
        "sharded": False,
        "nv": 4096,
        "ne": 4096,
    },
}
