"""Seeded LUX704 violation: a claimed closed-form footprint model that
prices the whole engine at one byte. The traced peak is ~KiBs, so the
formula serving would trust under-estimates the footprint — admission
would over-pack the card and the out-of-memory error arrives at run
time instead of in verify.

The port's counterpart of ``tests/mem_fixtures/lux704_dishonest_model.py``.
Loaded by ``python -m lux_tpu_torch.tools.luxlint --memory <this file>``
(on the card, or on the CPU with ``LUX_PLATFORM=cpu``); the CLI must
exit 1 with exactly LUX704.
"""

import torch

from lux_tpu_torch.utils.platform import platform_device

DEV = platform_device()


def _step(vals, deg):
    return torch.minimum(vals, vals.flip(0) + deg)


TARGETS = {
    "fixture@lux704": {
        "call": _step,
        "args": (torch.zeros(256, device=DEV), torch.ones(256, device=DEV)),
        "carry": (0,),
        "sharded": False,
        "nv": 256,
        "ne": 256,
    },
}

# expect: LUX704 -- one byte covers nothing
MODELS = {
    "fixture@lux704": {
        "per_vertex_bytes": 0.0,
        "per_edge_bytes": 0.0,
        "fixed_bytes": 1,
    },
}
