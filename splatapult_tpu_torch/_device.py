"""Device resolution shared by every entry point that creates tensors."""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """-> torch.device; raises when a CUDA device is asked for and none exists.

    The package runs on the GPU unless the caller names the CPU explicitly:
    there is no silent fallback, so a missing card is an error here rather
    than a slow run somewhere else.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' explicitly to run "
            "the plain PyTorch path on the host")
    return dev
