"""Device resolution for the port's tensor-creating entry points.

``device=None`` means the card. Without a card the caller must ask for the CPU
explicitly: nothing falls back to it quietly.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and none exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
