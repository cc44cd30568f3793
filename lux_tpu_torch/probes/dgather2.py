"""Probes P3-P6 on the H100, and the row gathers beside them.

The counterpart of ``tools/probe_dgather2.py``: the same shapes, numpy
draws (seed 0) and lines, each the mean of 10 calls (CUDA events) and
the ns per item:

- lane gather (axis 1) within (4096, 128) blocks of a (262144, 128) f32
  array, with an int32 index (P3, ``k_lane``) and an int8 one (P4,
  ``k_lane8``): the ``block_take`` kernel;
- row gather (axis 0) within (8, 128) blocks (P5, ``k_sub``), and the
  same with an int8 index, the fourth form of ``block_take``, which the
  TPU probe did not run;
- one level of a 4-candidate merge network (P6, ``k_merge``):
  ``out[i, j] = cand[i, s[i, j], l[i, j]]`` over (65536, 4, 128)
  candidates, the ``merge4`` kernel;
- 300,000 rows gathered from a 151 MB table and summed, whole and in 4
  segments: plain PyTorch, as the TPU probe left them to XLA.

Runs on the card unless ``device`` names another; ``name ...`` keeps only
the lines whose first word is given::

    python -m lux_tpu_torch.probes.dgather2 [lane-gather merge-level ...]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from lux_tpu_torch.probes.gather import block_take, mean_ms, merge4, report
from lux_tpu_torch.utils.platform import resolve_device

S, NB = 4096, 64          # (S, 128) blocks, NB of them: 33.5 M elements
R = 65536                 # merge output rows; cand is (R, 4, 128)
TABLE_ROWS, TR = 294912, 300_000
WIDTH = 44


def segmented_row_sum(table, ridx, nseg: int = 4):
    """Σ table[ridx] over ``nseg`` row slices of the table, each gather
    clipped to its slice and masked (the TPU probe's segmented form)."""
    seg = table.shape[0] // nseg
    out = table.new_zeros(table.shape[1])
    for s_ in range(nseg):
        sl = table[s_ * seg:(s_ + 1) * seg]
        loc = (ridx - s_ * seg).clamp(0, seg - 1)
        mask = (ridx >= s_ * seg) & (ridx < (s_ + 1) * seg)
        out = out + torch.where(mask[:, None], sl[loc], 0.0).sum(0)
    return out


def main(argv=None, device=None) -> int:
    only = set(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    put = lambda a: torch.from_numpy(a).to(dev)

    def probe(name, fn, per):
        if not only or name.split()[0] in only:
            report(name, mean_ms(fn, dev), per, WIDTH)

    m = S * NB * 128
    x = put(rng.standard_normal((S * NB, 128), dtype=np.float32))
    li32 = rng.integers(0, 128, (S * NB, 128), dtype=np.int32)
    li32, li8 = put(li32), put(li32.astype(np.int8))
    probe("lane-gather 33.5M i32", lambda: block_take(x, li32, 1, S), m)
    probe("lane-gather 33.5M i8-idx", lambda: block_take(x, li8, 1, S), m)
    si32 = rng.integers(0, 8, (S * NB, 128), dtype=np.int32)
    si32, si8 = put(si32), put(si32.astype(np.int8))
    probe("sublane-gather(8) 33.5M", lambda: block_take(x, si32, 0, 8), m)
    probe("sublane-gather(8) 33.5M i8-idx",
          lambda: block_take(x, si8, 0, 8), m)
    del x, li32, li8, si32, si8

    cand = put(rng.standard_normal((R, 4, 128), dtype=np.float32))
    lm = put(rng.integers(0, 128, (R, 128), dtype=np.int32))
    sm = put(rng.integers(0, 4, (R, 128), dtype=np.int32))
    probe(f"merge-level {R * 128 / 1e6:.1f}M out (4-cand)",
          lambda: merge4(cand, lm, sm), R * 128)
    del cand, lm, sm

    big = put(rng.standard_normal((TABLE_ROWS, 128), dtype=np.float32))
    ridx = put(rng.integers(0, TABLE_ROWS, TR, dtype=np.int32)).long()
    probe("row-gather 300K from 150MB", lambda: big[ridx].sum(0), TR)
    probe("row-gather 300K segmented(4x)",
          lambda: segmented_row_sum(big, ridx), TR)
    return 0


if __name__ == "__main__":
    sys.exit(main())
