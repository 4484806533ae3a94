"""Where an entry point runs: on the card unless the caller names
another device."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: ray_tpu_torch runs on the card; pass "
            "device='cpu' to run the plain versions of its kernels")
    return dev
