"""Probe P7 on the H100: one 2-candidate merge level over 8-row windows.

The counterpart of ``tools/probe_merge_kernel.py`` (``make_merge``, body
``k_merge``): output block g (16 rows) reads the (8, 128) windows of one
stream at block offsets ``aoff[g]`` and ``boff[g]``, each row repeated
twice, and takes lane ``idx & 127`` of the A window where ``idx >= 0``,
else of the B window. On the H100 that is one launch of K3
(``csrc/level_apply.cu``) with the offsets expanded to one input row per
output row (:func:`~lux_tpu_torch.probes.gather.merge_level`).

As the TPU probe: first a tiny case (G = 4) against the probe's own numpy
loop, then the rate at G = 2**17 (2 M output rows), three lines, each
the mean of 10 calls (CUDA events) and the ns per slot. Runs on the
card unless ``device`` names another::

    python -m lux_tpu_torch.probes.merge_kernel
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from lux_tpu_torch.probes.gather import mean_ms, merge_level
from lux_tpu_torch.utils.platform import resolve_device

G_TINY, R_TINY = 4, 64
G_RATE = 1 << 17


def numpy_merge(stream, aoff, boff, idx):
    """The TPU probe's correctness loop, element by element."""
    g_n = aoff.shape[0]
    want = np.empty((16 * g_n, 128), np.float32)
    for g in range(g_n):
        aw = stream[8 * aoff[g]:8 * aoff[g] + 8]
        bw = stream[8 * boff[g]:8 * boff[g] + 8]
        for i in range(16):
            for j in range(128):
                v = int(idx[16 * g + i, j])
                want[16 * g + i, j] = (aw if v >= 0 else bw)[i // 2, v & 127]
    return want


def main(argv=None, device=None) -> int:
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    put = lambda a: torch.from_numpy(a).to(dev)

    stream = rng.standard_normal((R_TINY, 128), dtype=np.float32)
    aoff = rng.integers(0, R_TINY // 8 - 1, G_TINY).astype(np.int32)
    boff = rng.integers(0, R_TINY // 8 - 1, G_TINY).astype(np.int32)
    idx = rng.integers(-128, 128, (G_TINY * 16, 128)).astype(np.int8)
    got = merge_level(put(stream), put(aoff), put(boff), put(idx))
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  numpy_merge(stream, aoff, boff, idx))
    print("merge kernel CORRECT on tiny case", flush=True)

    g_n = G_RATE
    r_in = g_n * 8 + 8
    stream_b = put(rng.standard_normal((r_in, 128), dtype=np.float32))
    aoff_b = put(rng.integers(0, r_in // 8 - 1, g_n, dtype=np.int64)
                 .astype(np.int32))
    boff_b = put(rng.integers(0, r_in // 8 - 1, g_n, dtype=np.int64)
                 .astype(np.int32))
    idx_b = put(rng.integers(-128, 128, (g_n * 16, 128)).astype(np.int8))
    m = g_n * 16 * 128
    for _ in range(3):
        ms = mean_ms(lambda: merge_level(stream_b, aoff_b, boff_b, idx_b),
                     dev)
        print(f"merge level {m / 1e6:.0f}M slots: {ms:.2f} ms "
              f"({ms / 1e3 / m * 1e9:.3f} ns/slot)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
