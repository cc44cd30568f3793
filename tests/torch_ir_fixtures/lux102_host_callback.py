"""Seeded LUX102 violation: the step sends its values to the host,
computes there and sends the result back — a hidden
device->host->device round trip per iteration.

The port's counterpart of ``tests/ir_fixtures/lux102_host_callback.py``.
Loaded by ``python -m lux_tpu_torch.tools.luxlint --ir <this file>``
(on the card, or on the CPU with ``LUX_PLATFORM=cpu``); the CLI must
exit 1.
"""

import numpy as np
import torch

from lux_tpu_torch.utils.platform import platform_device

DEV = platform_device()


def _host_degree(vals):
    return np.asarray(vals) * 2


def _step(vals):
    # expect: LUX102
    doubled = torch.from_numpy(_host_degree(vals.cpu().numpy()))
    return doubled.to(vals.device) + 1.0


TRACES = [{
    "name": "fixture@lux102",
    "call": _step,
    "args": (torch.zeros(64, device=DEV),),
    "carry": (0,),
    "sharded": False,
}]
