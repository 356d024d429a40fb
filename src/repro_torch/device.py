"""Device resolution, host-to-device copies and seeded generators shared by
the port's entry points."""
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


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A small host tensor (cohort ids, masks, offset tables) on ``device``
    without waiting for the card: the copy goes through pinned memory and
    is queued on the current stream."""
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def mix_seed(*parts: int) -> int:
    """One 62-bit seed from a tuple of integers, so that nearby tuples
    (seed, client, step) seed unrelated streams."""
    s = 0x9E3779B97F4A7C15
    for p in parts:
        s = (s * 1_000_003 + int(p) + 1) % (1 << 62)
    return s


def generator(device, *parts: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``mix_seed(*parts)``."""
    g = torch.Generator(device=device)
    g.manual_seed(mix_seed(*parts))
    return g
