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


def _per_element(scale: torch.Tensor, offsets: torch.Tensor,
                 n: int) -> torch.Tensor:
    """The ``[M, L]`` per-(row, segment) scales spread over the ``[M, n]``
    elements: segment s spans columns ``offsets[s]:offsets[s+1]``."""
    lengths = offsets[1:] - offsets[:-1]
    return torch.repeat_interleave(scale.float(), lengths, dim=1,
                                   output_size=n)


def quantize_stoch_ref(x: torch.Tensor, u: torch.Tensor, scale: torch.Tensor,
                       offsets: torch.Tensor, qmax: int) -> torch.Tensor:
    """Stochastic uniform quantization of ``[M, n]`` rows cut into segments
    at ``offsets`` ([L+1] int64, 0 to n), one scale per (row, segment)
    (``scale`` [M, L]): q = clip(floor(x / scale + u), ±qmax) as int8, with
    ``u`` uniform[0, 1) noise. It divides by the scale, as the 1-D oracle
    does: multiplying by the reciprocal moves levels at rounding
    boundaries."""
    s = _per_element(scale, offsets, x.shape[1])
    q = torch.floor(x.float() / s + u.float())
    return torch.clamp(q, -qmax, qmax).to(torch.int8)


def dequantize_ref(q: torch.Tensor, scale: torch.Tensor,
                   offsets: torch.Tensor) -> torch.Tensor:
    """x = q * scale back to f32, per (row, segment) as in
    :func:`quantize_stoch_ref`."""
    return q.float() * _per_element(scale, offsets, q.shape[1])
