"""Seeded LUX706 violation: the committed memcap.v1 stand-in carries
an admission formula calibrated against some long-gone build — it
predicts one byte where a fresh trace peaks at ~KiBs. Serving would
admit engines against the stale footprint; the drift rule demands the
artifact be regenerated instead.

The port's counterpart of ``tests/mem_fixtures/lux706_stale_committed.py``.
Loaded by ``python -m lux_tpu_torch.tools.luxlint --memory <this file>``
(on the card, or on the CPU with ``LUX_PLATFORM=cpu``); the CLI must
exit 1 with exactly LUX706.
"""

import torch

from lux_tpu_torch.utils.platform import platform_device

DEV = platform_device()


def _step(vals, deg):
    return torch.minimum(vals, vals.flip(0) + deg)


TARGETS = {
    "fixture@lux706": {
        "call": _step,
        "args": (torch.zeros(256, device=DEV), torch.ones(256, device=DEV)),
        "carry": (0,),
        "sharded": False,
        "nv": 256,
        "ne": 256,
    },
}

# expect: LUX706 -- a formula from a build that no longer exists
COMMITTED = {
    "schema": "memcap.v1",
    "targets": {
        "fixture@lux706": {
            "k": 1,
            "model": {
                "per_vertex_bytes": 0.0,
                "per_edge_bytes": 0.0,
                "fixed_bytes": 1,
            },
        },
    },
}
