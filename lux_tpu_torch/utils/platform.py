"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another. Without a card and without an explicit device this
    raises — an entry point never carries on quietly on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: lux_tpu_torch runs on the GPU by default; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return torch.device("cuda")
