"""Seeded LUX702 violation: the trace spec declares the carry donated,
but the step writes its result into a new tensor — no output reuses the
donated storage, so both copies of the carry stay live and the declared
donation buys nothing. LUX104 would call this "audited"; the memory tier
prices it into the peak.

The port's counterpart of ``tests/mem_fixtures/lux702_unhonored_donation.py``.
Loaded by ``python -m lux_tpu_torch.tools.luxlint --memory <this file>``
(on the card, or on the CPU with ``LUX_PLATFORM=cpu``); the CLI must
exit 1 with exactly LUX702.
"""

import torch

from lux_tpu_torch.utils.platform import platform_device

DEV = platform_device()


def _step(vals, deg):
    return torch.minimum(vals, vals.flip(0) + deg)


TARGETS = {
    "fixture@lux702": {
        "call": _step,
        "args": (torch.zeros(64, device=DEV), torch.ones(64, device=DEV)),
        # expect: LUX702 -- donation declared, the step writes a new tensor
        "donate": (0,),
        "carry": (0,),
        "sharded": False,
        "nv": 64,
        "ne": 64,
    },
}
