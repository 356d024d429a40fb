"""Plain PyTorch versions of the update kernels: the CPU path, and the
oracle the CUDA kernels are held against. Math in f32, cast to the output's
dtype, in the same order of operations as the kernels."""
from __future__ import annotations

import torch


def storm_update_ref(g_new: torch.Tensor, g_old: torch.Tensor,
                     est: torch.Tensor, beta) -> torch.Tensor:
    """STORM (Eqs. 10-11): est' = g_new + (1-beta) * (est - g_old)."""
    out = g_new.float() + (1.0 - beta) * (est.float() - g_old.float())
    return out.to(est.dtype)


def adafbio_update_ref(p: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                       lr_eta, rho) -> torch.Tensor:
    """Fused adaptive step (Eq. 14): p' = p - lr_eta * w / (sqrt(a) + rho).
    ``a`` broadcasts against ``p`` (one row shared by every client row)."""
    upd = w.float() / (torch.sqrt(a.float()) + rho)
    return (p.float() - lr_eta * upd).to(p.dtype)
