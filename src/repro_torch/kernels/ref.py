"""Plain PyTorch versions of the port's kernels: the CPU path, and the
oracle the CUDA kernels are held against. Math in f32, cast to the output's
dtype, in the same order of operations as the kernels."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def storm_update_ref(g_new: torch.Tensor, g_old: torch.Tensor,
                     est: torch.Tensor, beta) -> torch.Tensor:
    """STORM (Eqs. 10-11): est' = g_new + (1-beta) * (est - g_old)."""
    out = g_new.float() + (1.0 - beta) * (est.float() - g_old.float())
    return out.to(est.dtype)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, as the kernels' __fsqrt_rn and
    XLA compute it. PyTorch's CUDA sqrt is; its CPU kernel misses by one ulp
    on some inputs, so on the CPU the root goes through f64 (rounding that
    back to f32 is exact: 53 >= 2 * 24 + 2 bits)."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def adafbio_update_ref(p: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                       lr_eta, rho) -> torch.Tensor:
    """Fused adaptive step (Eq. 14): p' = p - lr_eta * w / (sqrt(a) + rho).
    ``a`` broadcasts against ``p``: one ``[n]`` row shared by every client
    row, or ``[M, n]``, a row per client row."""
    upd = w.float() / (sqrt_rn(a.float()) + rho)
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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """Forward GQA attention, all in f32. q: [B,H,Sq,D]; k,v: [B,KV,Sk,D]
    (unexpanded: q head h reads kv head h // (H/KV)); positions count from
    0 in both. Returns [B,H,Sq,D] in q's dtype."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    q5 = q.reshape(b, kv, h // kv, sq, d).float() * d ** -0.5
    logits = torch.einsum("bkgqd,bksd->bkgqs", q5, k.float())
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        m &= kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    p = torch.softmax(torch.where(m, logits, NEG_INF), dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(b, h, sq, d).to(q.dtype)


def quant_decode_ref(q: torch.Tensor, k8: torch.Tensor, k_scale: torch.Tensor,
                     v8: torch.Tensor, v_scale: torch.Tensor,
                     pos) -> torch.Tensor:
    """One-token GQA attention over an int8 cache, all in f32. q: [B,H,Dh];
    k8/v8: [B,KV,S,Dh] int8; scales [B,KV,S] f32; ``pos`` the valid length,
    a scalar or ``[B]`` per row (the JAX oracle takes only a scalar).
    Returns [B,H,Dh] in q's dtype."""
    b, h, dh = q.shape
    kv, smax = k8.shape[1], k8.shape[2]
    kf = k8.float() * k_scale[..., None]
    vf = v8.float() * v_scale[..., None]
    q4 = q.reshape(b, kv, h // kv, dh).float() * dh ** -0.5
    logits = torch.einsum("bkgd,bksd->bkgs", q4, kf)
    slots = torch.arange(smax, device=q.device)
    pos = torch.as_tensor(pos, device=q.device)
    valid = slots < pos if pos.dim() == 0 else slots[None] < pos[:, None]
    valid = valid.reshape(-1, 1, 1, smax)
    p = torch.softmax(torch.where(valid, logits, NEG_INF), dim=-1)
    o = torch.einsum("bkgs,bksd->bkgd", p, vf)
    return o.reshape(b, h, dh).to(q.dtype)


def mamba_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor,
                   h0: Optional[torch.Tensor] = None):
    """Selective scan (mamba1 core), one step at a time, all in f32:
    h_t = exp(dt_t A) * h_{t-1} + (dt_t x_t) B_t and y_t = h_t . C_t.
    x, dt: [B,S,Di]; A: [Di,N]; Bm, Cm: [B,S,N]; h0: [B,Di,N] or None
    (zeros). Returns (y [B,S,Di] in x's dtype, h_last [B,Di,N] f32)."""
    b, s, di = x.shape
    xf, dtf = x.float(), dt.float()
    Bf, Cf, Af = Bm.float(), Cm.float(), A.float()
    h = (torch.zeros((b, di, Af.shape[-1]), dtype=torch.float32,
                     device=x.device) if h0 is None else h0.float())
    ys = []
    for t in range(s):
        a = torch.exp(dtf[:, t, :, None] * Af)                 # [B,Di,N]
        bx = (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        h = a * h + bx
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), h
