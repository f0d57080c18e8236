"""Where the port's public constructors put their tensors."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises for CUDA when no card is visible
    (the port never moves a CUDA request to the CPU by itself)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was asked for and none is visible; "
            "pass device='cpu' to run on the CPU"
        )
    return device
