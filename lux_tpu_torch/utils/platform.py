"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch

from lux_tpu_torch.utils import flags


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


def platform_device() -> torch.device:
    """The device a CLI runs on, from ``LUX_PLATFORM``: ``cpu`` is the
    CPU (the kernels' plain versions); unset or ``cuda`` is the card.
    Unlike ``lux_tpu``'s ``ensure_backend`` there is no fallback: without
    a card the CLI exits with a message."""
    forced = flags.get("LUX_PLATFORM")
    if forced == "cpu":
        return torch.device("cpu")
    if forced not in (None, "", "cuda"):
        raise SystemExit(
            f"error: LUX_PLATFORM={forced!r}: lux_tpu_torch runs on 'cpu' "
            "or on the card ('cuda', the default)")
    try:
        return resolve_device()
    except RuntimeError as e:
        raise SystemExit(
            f"error: {e}; set LUX_PLATFORM=cpu to run on the CPU") from None
