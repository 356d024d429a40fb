"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card
    raises instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but no CUDA device is available; pass "
            f"device='cpu' to run the plain PyTorch path on the CPU")
    return dev


def fence(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (the round-timing fence)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
