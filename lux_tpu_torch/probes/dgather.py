"""Probe P2 on the H100: the rate of ``take_along_axis`` within (S, 128)
blocks, along lanes (axis 1) and across rows (axis 0).

The counterpart of ``tools/probe_dgather.py`` (``make_ta``, body
``kernel_ta``): the same shapes, the same numpy draws (seed 0) and the
same lines, each the mean of 10 calls of the ``block_take`` kernel
(CUDA events) and the ns per element. Runs on the card unless
``device`` names another; ``name ...`` keeps only the lines whose first
word is given (here all lines are ``ta``)::

    python -m lux_tpu_torch.probes.dgather [ta]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from lux_tpu_torch.probes.gather import block_take, mean_ms, report
from lux_tpu_torch.utils.platform import resolve_device

# (S, L, axis, reps): a (reps * S, L) array gathered in (S, L) blocks.
SHAPES = (
    (8, 128, 1, 1), (8, 128, 0, 1),
    (512, 128, 1, 1), (512, 128, 0, 1),
    (4096, 128, 1, 16), (4096, 128, 0, 16),
    (8192, 128, 0, 32),
)


def main(argv=None, device=None) -> int:
    only = set(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    for S, L, axis, reps in SHAPES:
        n_el = reps * S * L
        x = rng.standard_normal((reps * S, L), dtype=np.float32)
        hi = S if axis == 0 else L
        idx = rng.integers(0, hi, (reps * S, L), dtype=np.int32)
        name = f"ta axis={axis} ({S},{L})x{reps}"
        if only and name.split()[0] not in only:
            continue
        xt = torch.from_numpy(x).to(dev)
        it = torch.from_numpy(idx).to(dev)
        report(name, mean_ms(lambda: block_take(xt, it, axis, S), dev), n_el)
    return 0


if __name__ == "__main__":
    sys.exit(main())
