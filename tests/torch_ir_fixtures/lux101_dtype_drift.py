"""Seeded LUX101 violation: the iteration carry enters as float32 and
leaves as bfloat16 — every iteration converts the carry.

The port's counterpart of ``tests/ir_fixtures/lux101_dtype_drift.py``.
Loaded by ``python -m lux_tpu_torch.tools.luxlint --ir <this file>``
(on the card, or on the CPU with ``LUX_PLATFORM=cpu``); the CLI must
exit 1.
"""

import torch

from lux_tpu_torch.utils.platform import platform_device

DEV = platform_device()


def _step(vals, deg):
    # expect: LUX101
    return (vals / deg).to(torch.bfloat16)


TRACES = [{
    "name": "fixture@lux101",
    "call": _step,
    "args": (torch.zeros(64, device=DEV), torch.ones(64, device=DEV)),
    "carry": (0,),
    "sharded": False,
}]
