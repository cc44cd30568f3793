"""Seeded LUX104 violation: the arg is declared donated but the step
only returns a scalar reduction — no output reuses the donated storage,
so the donation buys nothing.

The port's counterpart of ``tests/ir_fixtures/lux104_donation.py``.
Loaded by ``python -m lux_tpu_torch.tools.luxlint --ir <this file>``
(on the card, or on the CPU with ``LUX_PLATFORM=cpu``); the CLI must
exit 1.
"""

import torch

from lux_tpu_torch.utils.platform import platform_device

DEV = platform_device()


def _step(vals):
    return vals.sum()


# expect: LUX104
TRACES = [{
    "name": "fixture@lux104",
    "call": _step,
    "args": (torch.zeros(64, device=DEV),),
    "donate": (0,),
    "carry": (),
    "sharded": False,
}]
