"""Attention primitives: GQA/MQA/MHA with RoPE and an optional sliding
window; the full path, the chunked (flash-style) path and the one-token
decode path against a cache. Plain PyTorch, with the JAX package's dtype
discipline (``src/repro/models/attention.py``): operands stay in the input
dtype and products accumulate in f32 (here: f32 operands, which hold every
product of two bf16 values exactly), and probabilities are cast to
``v.dtype`` before the PV product.

GQA is computed in grouped form (q as ``[B,S,KV,G,Dh]`` against unexpanded
K/V), so repeated K/V heads are never materialized. The hand-written CUDA
kernels that take these paths' place on the serve path live in
``repro_torch.kernels`` (``flash_attention``, ``quant_decode``).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def rope_tables(pos: torch.Tensor, dh: int, theta: float):
    """(cos, sin) of RoPE's angles at ``pos`` ([..., S] integers), shaped
    [..., S, 1, Dh/2] to broadcast over heads. A forward computes them once
    and every layer reuses them (the values ``rope`` computes per call)."""
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=pos.device) / half)
    ang = pos.to(torch.float32)[..., None] * freqs          # [..., S, half]
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: [..., S, H, Dh] rotated by :func:`rope_tables`' angles, in f32,
    cast back to x's dtype."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, Dh]; pos: [..., S] integer positions."""
    return apply_rope(x, *rope_tables(pos, x.shape[-1], theta))


def _grouped(q: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """[B,S,H,Dh] -> [B,S,KV,G,Dh]."""
    b, s, h, dh = q.shape
    return q.reshape(b, s, kv_heads, h // kv_heads, dh)


def _scaled(q: torch.Tensor, dh: int) -> torch.Tensor:
    """q * dh^-0.5 in q's dtype (the scale rounded to it first). The scale
    is a fill on q's device, not a copy from the host, which would wait
    for the card."""
    return q * torch.full((), dh ** -0.5, dtype=q.dtype, device=q.device)


def _mask(sq: int, sk: int, causal: bool, window: Optional[int], device,
          q_offset=0, k_offset=0) -> torch.Tensor:
    qpos = torch.arange(sq, device=device) + q_offset
    kpos = torch.arange(sk, device=device) + k_offset
    m = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        m &= kpos[None, :] > qpos[:, None] - window
    return m


def attend_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool = True, window: Optional[int] = None,
                q_offset: int = 0) -> torch.Tensor:
    """Plain softmax attention. q: [B,Sq,H,Dh]; k,v: [B,Sk,KV,Dh]."""
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    q5 = _scaled(_grouped(q, kv), dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", q5.float(), k.float())
    m = _mask(sq, sk, causal, window, q.device, q_offset)
    # in place: under autograd the masked scores are not kept beside the
    # unmasked ones (the training forward keeps a layer's scores)
    logits = logits.masked_fill_(~m, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, sq, h, dh).to(q.dtype)


def attend_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, window: Optional[int] = None,
                 chunk: int = 1024) -> torch.Tensor:
    """Chunked (flash-style) attention over KV blocks: O(Sq*chunk) live
    scores. Forward only."""
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if sk <= chunk:
        return attend_full(q, k, v, causal=causal, window=window)
    assert sk % chunk == 0, (sk, chunk)
    g = h // kv
    q5 = _scaled(_grouped(q, kv), dh).float()
    qpos = torch.arange(sq, device=q.device)
    m = torch.full((b, kv, g, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, kv, g, sq), device=q.device)
    acc = torch.zeros((b, kv, g, sq, dh), device=q.device)
    for idx in range(sk // chunk):
        kb = k[:, idx * chunk:(idx + 1) * chunk]
        vb = v[:, idx * chunk:(idx + 1) * chunk]
        kpos = idx * chunk + torch.arange(chunk, device=q.device)
        logits = torch.einsum("bqkgd,bskd->bkgqs", q5, kb.float())
        msk = torch.ones((sq, chunk), dtype=torch.bool, device=q.device)
        if causal:
            msk &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            msk &= kpos[None, :] > qpos[:, None] - window
        logits = torch.where(msk, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p.to(vb.dtype).float(), vb.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh)
    return out.to(q.dtype)


def valid_slots(pos, smax: int, device) -> torch.Tensor:
    """The cache slots below ``pos`` (a scalar, or ``[B]`` per row), shaped
    to broadcast against ``[B,KV,G,1,Smax]`` scores."""
    slots = torch.arange(smax, device=device)
    pos = torch.as_tensor(pos, device=device)
    if pos.dim() == 0:
        return (slots < torch.clamp(pos, max=smax))[None, None, None, None]
    valid = slots[None, :] < torch.clamp(pos, max=smax)[:, None]
    return valid[:, None, None, None, :]


def attend_decode(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, *, pos, ring: bool = False
                  ) -> torch.Tensor:
    """One-token attention against a cache.

    q: [B,1,H,Dh]; k_cache/v_cache: [B,Smax,KV,Dh]; pos: count of valid
    tokens *including* the current one, a scalar shared by every row or a
    ``[B]`` tensor of per-row positions (continuous batching). With
    ``ring=True`` the cache is a ring buffer (sliding window); positions
    were RoPE'd at write time, so slot order is irrelevant."""
    b, smax, kv, dh = k_cache.shape
    h = q.shape[2]
    q5 = _scaled(_grouped(q, kv), dh).to(k_cache.dtype)
    logits = torch.einsum("bqkgd,bskd->bkgqs", q5.float(), k_cache.float())
    logits = torch.where(valid_slots(pos, smax, q.device), logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, 1, h, dh).to(q.dtype)
