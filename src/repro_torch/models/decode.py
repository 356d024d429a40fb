"""Serving paths of the dense family: prefill (build the cache) and the
one-token decode against it (``src/repro/models/decode.py``).

Cache layout (the leading dim walks the layers):
  {"k", "v": [L,B,W,KV,Dh]}   W = window (ring) or max_len
  with ``quant=True`` the K/V levels are int8 and
  {"k_scale", "v_scale": [L,B,W,KV]} f32 hold one scale per (token, head).

``pos`` is the number of tokens already in the cache; RoPE uses absolute
positions, so ring buffers (sliding window) stay correct without rotation.

The JAX functions return a new cache; these write into the cache they are
given, layer slice by layer slice, and return it: a serve pool at full
width holds hundreds of megabytes per layer, and a copy per tick would
move more bytes than the attention reads. Prefill's self-attention goes
through the ``flash_attention`` kernel, the int8 decode's attention
through ``quant_decode_attention`` (``ModelCtx.attn`` picks the path).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ref as kref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.quant_decode import (quant_decode_attention,
                                              quantize_kv)
from repro_torch.models import attention as attn_lib
from repro_torch.models.model import (ModelCtx, check_family, embed_tokens,
                                      head_logits, layer, mlp_block,
                                      out_proj, qkv, rmsnorm)
from repro_torch.models.params import TensorSpec, torch_dtype


# ------------------------------------------------------------------ cache

def cache_spec(cfg: ArchConfig, batch: int, max_len: int,
               window: Optional[int] = None, dtype=torch.bfloat16,
               quant: bool = False
               ) -> Tuple[Dict[str, TensorSpec], Dict[str, Any]]:
    """(TensorSpec tree, logical-axes tree) of the cache. ``quant=True``:
    int8 K/V with per-(token, head) f32 scales, half the bytes of a bf16
    cache."""
    check_family(cfg)
    dtype = torch_dtype(dtype)
    w = min(window or max_len, max_len)
    kvs = (cfg.n_layers, batch, w, cfg.n_kv_heads, cfg.resolved_head_dim)
    kv_dtype = torch.int8 if quant else dtype
    kv_ax = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
    spec = {"k": TensorSpec(kvs, kv_dtype), "v": TensorSpec(kvs, kv_dtype)}
    axes = {"k": kv_ax, "v": kv_ax}
    if quant:
        spec["k_scale"] = TensorSpec(kvs[:-1], torch.float32)
        spec["v_scale"] = TensorSpec(kvs[:-1], torch.float32)
        axes["k_scale"] = axes["v_scale"] = kv_ax[:-1]
    return spec, axes


def zeros(spec: Dict[str, TensorSpec], device) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for k, s in spec.items()}


def init_cache(cfg, batch, max_len, window=None, dtype=torch.bfloat16,
               quant=False, device="cuda"):
    spec, _ = cache_spec(cfg, batch, max_len, window, dtype, quant)
    return zeros(spec, device)


# ------------------------------------------------------------------ helpers

class _Step:
    """What every layer of one decode step shares: the tokens' positions
    (0-d or ``[B]``) and the valid lengths, their RoPE tables, and the
    (row, slot) each row writes. Computed once per step, not once per layer."""

    def __init__(self, cfg, pos: torch.Tensor, b: int, w: int, window):
        self.window = window
        self.valid = pos + 1        # the cached tokens, this one included
        posv = pos[:, None] if pos.dim() == 1 else pos.reshape(1, 1)
        self.rope = attn_lib.rope_tables(posv, cfg.resolved_head_dim,
                                         cfg.rope_theta)
        slot = pos % w if window else torch.clamp(pos, max=w - 1)
        self.index = (torch.arange(b, device=pos.device),
                      slot.expand(b).long())


def _write(buf: torch.Tensor, val: torch.Tensor, index) -> None:
    """Scatter one token per row: ``buf[b, slot[b]] = val[b, 0]``
    (buf [B,W,...], val [B,1,...], index = (rows, slot))."""
    buf[index] = val[:, 0].to(buf.dtype)


def _attn_decode_block(cfg, p, h, ck, cv, step: _Step, scales=None,
                       attn="kernel"):
    """One-token self-attention against one layer's cache slice. h: [B,1,d];
    ck/cv: [B,W,KV,Dh] (and ``scales`` = (k_scale, v_scale) [B,W,KV] when
    the cache is int8), written in place at each row's slot."""
    valid, window, slot = step.valid, step.window, step.index
    hn = rmsnorm(h, p["ln_attn"], cfg.norm_eps)
    q, k, v = qkv(cfg, p, hn)
    q = attn_lib.apply_rope(q, *step.rope)
    k = attn_lib.apply_rope(k, *step.rope)
    if scales is None:
        _write(ck, k, slot)
        _write(cv, v, slot)
        o = attn_lib.attend_decode(q, ck, cv, pos=valid,
                                   ring=window is not None)
        return h + out_proj(o, p["wo"])
    ks, vs = scales
    k8, ksc = quantize_kv(k)
    v8, vsc = quantize_kv(v)
    for buf, val in ((ck, k8), (cv, v8), (ks, ksc), (vs, vsc)):
        _write(buf, val, slot)
    if attn == "reference" or window is not None:
        # the reference's path: dequantize this layer's slice to the model
        # dtype, then the plain decode attention
        kd = (ck.float() * ks[..., None]).to(k.dtype)
        vd = (cv.float() * vs[..., None]).to(v.dtype)
        o = attn_lib.attend_decode(q, kd, vd, pos=valid,
                                   ring=window is not None)
    else:
        # [B,W,KV,Dh] viewed as [B,KV,W,Dh]: the kernel reads the strides
        fn = (kref.quant_decode_ref if attn == "plain"
              else quant_decode_attention)
        o = fn(q[:, 0], ck.transpose(1, 2), ks.transpose(1, 2),
               cv.transpose(1, 2), vs.transpose(1, 2), valid)[:, None]
    return h + out_proj(o, p["wo"])


def _fill_ring(k_seq: torch.Tensor, w: int, window) -> torch.Tensor:
    """[B,S,KV,Dh] -> ring buffer [B,w,KV,Dh] holding the last w positions
    at slot = pos % w (window) or the first w positions (full cache)."""
    s = k_seq.shape[1]
    if not window or s <= w:
        out = k_seq.new_zeros((k_seq.shape[0], w) + k_seq.shape[2:])
        out[:, :min(s, w)] = k_seq[:, :w]
        return out
    slots = torch.arange(s - w, s, device=k_seq.device) % w
    buf = k_seq.new_zeros((k_seq.shape[0], w) + k_seq.shape[2:])
    buf[:, slots] = k_seq[:, -w:]
    return buf


def prefill_attention(q, k, v, ctx: ModelCtx) -> torch.Tensor:
    """Causal self-attention of the prompt. q: [B,S,H,Dh]; k,v: [B,S,KV,Dh];
    the kernel sees [B,heads,S,Dh] views and answers in q's layout."""
    if ctx.attn == "reference":
        if ctx.kind == "prefill" and q.shape[1] > 4096:
            return attn_lib.attend_flash(q, k, v, causal=True,
                                         window=ctx.window,
                                         chunk=ctx.attn_chunk)
        return attn_lib.attend_full(q, k, v, causal=True, window=ctx.window)
    fn = (kref.flash_attention_ref if ctx.attn == "plain"
          else flash_attention)
    o = fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
           causal=True, window=ctx.window)
    return o.transpose(1, 2)


# ------------------------------------------------------------------ prefill

def prefill(cfg: ArchConfig, params, batch, cache, ctx: ModelCtx):
    """Run the prompt and fill ``cache`` (full precision) in place. Returns
    (last-position logits [B,1,V], cache)."""
    check_family(cfg)
    xp, yp = params["x"], params["y"]
    tokens = batch["tokens"]
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    h = embed_tokens(cfg, xp, tokens, batch.get("prefix_embeds"))
    w = cache["k"].shape[2]
    tables = attn_lib.rope_tables(pos, cfg.resolved_head_dim, cfg.rope_theta)
    for i in range(cfg.n_layers):
        lp = layer(xp["layers"], i)
        hn = rmsnorm(h, lp["ln_attn"], cfg.norm_eps)
        q, k, v = qkv(cfg, lp, hn)
        q = attn_lib.apply_rope(q, *tables)
        k = attn_lib.apply_rope(k, *tables)
        o = prefill_attention(q, k, v, ctx)
        h = h + out_proj(o, lp["wo"])
        cache["k"][i].copy_(_fill_ring(k, w, ctx.window))
        cache["v"][i].copy_(_fill_ring(v, w, ctx.window))
        h = mlp_block(cfg, lp, h)
    return head_logits(cfg, yp, h[:, -1:]), cache


# ------------------------------------------------------------------ decode

def decode_step(cfg: ArchConfig, params, cache, token, pos, ctx: ModelCtx):
    """token: [B,1] integer; pos: tokens already cached, a scalar (every
    row at the same position) or a ``[B]`` tensor (continuous batching).
    Writes the token's K/V into ``cache`` in place; returns (logits
    [B,1,V], cache)."""
    check_family(cfg)
    xp, yp = params["x"], params["y"]
    pos = torch.as_tensor(pos, device=token.device)
    h = xp["embed"][token]
    quant = "k_scale" in cache
    step = _Step(cfg, pos, token.shape[0], cache["k"].shape[2], ctx.window)
    for i in range(cfg.n_layers):
        lp = layer(xp["layers"], i)
        scales = ((cache["k_scale"][i], cache["v_scale"][i]) if quant
                  else None)
        h = _attn_decode_block(cfg, lp, h, cache["k"][i], cache["v"][i],
                               step, scales=scales, attn=ctx.attn)
        h = mlp_block(cfg, lp, h)
    return head_logits(cfg, yp, h), cache
