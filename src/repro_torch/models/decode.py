"""Serving paths: prefill (build the cache) and the one-token decode
against it (``src/repro/models/decode.py``), for every family.

Cache layouts (the leading dim walks the layers):
  dense/vlm/moe : {"k", "v": [L,B,W,KV,Dh]}  W = window (ring) or max_len
                  with ``quant=True`` the K/V levels are int8 and
                  {"k_scale", "v_scale": [L,B,W,KV]} f32 hold one scale
                  per (token, head)
  ssm           : {"h": [L,B,di,N] f32, "conv": [L,B,cw-1,di]}
  hybrid        : {"h": [L,B,H,P,N] f32, "conv": [L,B,cw-1,di+2N]} and the
                  shared block's {"k", "v": [nseg,B,W,KV,Dh]} (bf16 on the
                  serve path: the family has no int8 pool)
  encdec        : the decoder's self-attention {"k", "v"} as dense/vlm/moe
                  (int8 with ``quant=True``), and the cross-attention's
                  {"ck", "cv": [L,B,Senc,KV,Dh]} in the cache's dtype,
                  never int8: built once at prefill from the encoder's
                  output over Senc = ``enc_len`` frames, then read by
                  every tick

A moe layer routes each batch row as its own group (``models/moe.py``):
a decode tick routes one token a row (capacity 4, nothing drops), a
prefill the prompt at its own length, so the capacity follows the prompt
as in the reference engine, which prefills each prompt unpadded.

``pos`` is the number of tokens already in the cache; RoPE uses absolute
positions, so ring buffers (sliding window) stay correct without rotation.
An encdec prefill runs the encoder over the request's frames first; its
three attentions (the encoder's self-attention and the cross-attention
not causal, the cross-attention's queries the prompt's and its keys the
frames) all go through the ``flash_attention`` kernel. A decode tick's
cross-attention attends over the dense cross cache with the plain
``attend_decode``, as the reference's does (no Pallas kernel there).

The JAX functions return a new cache; these write into the cache they are
given, layer slice by layer slice, and return it: a serve pool at full
width holds hundreds of megabytes per layer, and a copy per tick would
move more bytes than the attention reads. Prefill's self-attention goes
through the ``flash_attention`` kernel, the int8 decode's attention
through ``quant_decode_attention`` and the mamba1 prefill's scan through
``mamba_scan`` (``ModelCtx.attn`` picks the path).
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
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.model import (ModelCtx, check_family, cross_kv,
                                      cross_query, embed_tokens, head_logits,
                                      layer, layers, mixer_segments,
                                      mlp_block, out_proj, qkv, rmsnorm)
from repro_torch.models.params import TensorSpec, torch_dtype


# ------------------------------------------------------------------ cache

def cache_spec(cfg: ArchConfig, batch: int, max_len: int,
               window: Optional[int] = None, enc_len: int = 0,
               dtype=torch.bfloat16, quant: bool = False
               ) -> Tuple[Dict[str, TensorSpec], Dict[str, Any]]:
    """(TensorSpec tree, logical-axes tree) of the cache, in the
    reference's argument order. ``quant=True``: int8 K/V with
    per-(token, head) f32 scales, half the bytes of a bf16 cache (the
    attention families; the ssm and hybrid caches ignore it, as the
    reference's do). ``enc_len``: the encdec cross cache's frames (its
    ``ck``/``cv`` stay in ``dtype`` with ``quant`` too)."""
    check_family(cfg)
    dtype = torch_dtype(dtype)
    L = cfg.n_layers
    hd = cfg.resolved_head_dim if cfg.n_heads else 0
    w = min(window or max_len, max_len)
    kv_ax = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
    spec: Dict[str, TensorSpec] = {}
    axes: Dict[str, Any] = {}
    fam = cfg.family
    if fam in ("dense", "vlm", "moe", "encdec"):
        kvs = (L, batch, w, cfg.n_kv_heads, hd)
        kv_dtype = torch.int8 if quant else dtype
        spec["k"], spec["v"] = TensorSpec(kvs, kv_dtype), TensorSpec(
            kvs, kv_dtype)
        axes["k"] = axes["v"] = kv_ax
        if quant:
            spec["k_scale"] = TensorSpec(kvs[:-1], torch.float32)
            spec["v_scale"] = TensorSpec(kvs[:-1], torch.float32)
            axes["k_scale"] = axes["v_scale"] = kv_ax[:-1]
    if fam == "encdec":
        ckvs = (L, batch, enc_len, cfg.n_kv_heads, hd)
        spec["ck"], spec["cv"] = TensorSpec(ckvs, dtype), TensorSpec(ckvs,
                                                                     dtype)
        axes["ck"] = axes["cv"] = kv_ax
    if fam in ("ssm", "hybrid"):
        s = cfg.ssm
        di = s.expand * cfg.d_model
        if s.version == 1:
            spec["h"] = TensorSpec((L, batch, di, s.state_dim), torch.float32)
            axes["h"] = ("layers", "batch", "ssm_inner", "ssm_state")
            conv_ch = di
        else:
            nh = di // s.head_dim
            spec["h"] = TensorSpec((L, batch, nh, s.head_dim, s.state_dim),
                                   torch.float32)
            axes["h"] = ("layers", "batch", "ssm_inner", None, "ssm_state")
            conv_ch = di + 2 * s.state_dim
        spec["conv"] = TensorSpec((L, batch, s.conv_width - 1, conv_ch),
                                  dtype)
        axes["conv"] = ("layers", "batch", None, "ssm_inner")
    if fam == "hybrid":
        nseg = cfg.n_layers // cfg.shared_attn_every
        kvs = (max(nseg, 1), batch, w, cfg.n_kv_heads, hd)
        spec["k"], spec["v"] = TensorSpec(kvs, dtype), TensorSpec(kvs, dtype)
        axes["k"] = axes["v"] = kv_ax
    return spec, axes


def zeros(spec: Dict[str, TensorSpec], device) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for k, s in spec.items()}


def init_cache(cfg, batch, max_len, window=None, enc_len=0,
               dtype=torch.bfloat16, quant=False, device="cuda"):
    spec, _ = cache_spec(cfg, batch, max_len, window=window,
                         enc_len=enc_len, dtype=dtype, quant=quant)
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


def prefill_attention(q, k, v, ctx: ModelCtx, flash_past: Optional[int],
                      causal: bool = True,
                      window: Optional[int] = None) -> torch.Tensor:
    """Attention of a whole prompt (or of the encoder's frames). q:
    [B,Sq,H,Dh]; k,v: [B,Sk,KV,Dh], Sk = Sq for self-attention, the frames
    for cross-attention; the kernel sees [B,heads,S,Dh] views and answers
    in q's layout. The reference path takes ``attend_flash`` past
    ``flash_past`` keys (None: never), ``attend_full`` below."""
    if ctx.attn == "reference":
        if flash_past is not None and k.shape[1] > flash_past:
            return attn_lib.attend_flash(q, k, v, causal=causal,
                                         window=window, chunk=ctx.attn_chunk)
        return attn_lib.attend_full(q, k, v, causal=causal, window=window)
    fn = (kref.flash_attention_ref if ctx.attn == "plain"
          else flash_attention)
    o = fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
           causal=causal, window=window)
    return o.transpose(1, 2)


def encode(cfg: ArchConfig, xp, enc_embeds: torch.Tensor,
           ctx: ModelCtx) -> torch.Tensor:
    """The encdec encoder of a prefill (``models/model.encoder_forward``
    with its attention through :func:`prefill_attention`): each layer's
    self-attention over the frames, not causal, RoPE over the frame
    positions (the reference path takes ``attend_flash`` past
    ``attn_chunk`` frames), then ``ln_out``."""
    h = enc_embeds.to(xp["embed"].dtype)
    tables = attn_lib.rope_tables(
        torch.arange(h.shape[1], device=h.device), cfg.resolved_head_dim,
        cfg.rope_theta)
    for lp in layers(xp["encoder"]["layers"]):
        hn = rmsnorm(h, lp["ln_attn"], cfg.norm_eps)
        q, k, v = qkv(cfg, lp, hn)
        q = attn_lib.apply_rope(q, *tables)
        k = attn_lib.apply_rope(k, *tables)
        o = prefill_attention(q, k, v, ctx, ctx.attn_chunk, causal=False,
                              window=ctx.window)
        h = mlp_block(cfg, lp, h + out_proj(o, lp["wo"]))
    return rmsnorm(h, xp["encoder"]["ln_out"], cfg.norm_eps)


def _cross_prefill_block(cfg, p, h, enc_out, ctx: ModelCtx):
    """The prefill's cross-attention: the prompt's queries against K/V of
    the encoder's output (no RoPE, no mask; the reference path takes
    ``attend_flash`` past ``attn_chunk`` frames). Returns (h', (K, V)) for
    the cross cache."""
    k, v = cross_kv(cfg, p, enc_out)
    o = prefill_attention(cross_query(cfg, p, h), k, v, ctx, ctx.attn_chunk,
                          causal=False)
    return h + out_proj(o, p["cwo"]), (k, v)


def _cross_decode_block(cfg, p, h, ck, cv):
    """One token's cross-attention over the dense cross cache [B,Senc,KV,Dh]
    (every frame valid), through the plain ``attend_decode`` on every
    path, as the reference's."""
    o = attn_lib.attend_decode(cross_query(cfg, p, h), ck, cv,
                               pos=ck.shape[1])
    return h + out_proj(o, p["cwo"])


# ------------------------------------------------------------------ prefill

def prefill(cfg: ArchConfig, params, batch, cache, ctx: ModelCtx):
    """Run the prompt and fill ``cache`` (full precision) in place. Returns
    (last-position logits [B,1,V], cache)."""
    check_family(cfg)
    xp, yp = params["x"], params["y"]
    tokens = batch["tokens"]
    h = embed_tokens(cfg, xp, tokens, batch.get("prefix_embeds"))
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    w = cache["k"].shape[2] if "k" in cache else 0
    tables = (attn_lib.rope_tables(pos, cfg.resolved_head_dim,
                                   cfg.rope_theta) if w else None)

    def attention(p, h, flash_past):
        """The attention block of the prompt: (h', (K, V) as the cache's
        ring buffers)."""
        hn = rmsnorm(h, p["ln_attn"], cfg.norm_eps)
        q, k, v = qkv(cfg, p, hn)
        q = attn_lib.apply_rope(q, *tables)
        k = attn_lib.apply_rope(k, *tables)
        o = prefill_attention(q, k, v, ctx, flash_past, window=ctx.window)
        return h + out_proj(o, p["wo"]), (_fill_ring(k, w, ctx.window),
                                          _fill_ring(v, w, ctx.window))

    if cfg.family in ("ssm", "hybrid"):
        for seg, idx in mixer_segments(cfg):
            for i in idx:
                lp = layer(xp["layers"], i)
                hn = rmsnorm(h, lp["ln"], cfg.norm_eps)
                y, (hst, conv) = ssm_lib.mixer_seq(cfg, lp, hn,
                                                   ctx.ssm_chunk, ctx.attn)
                h = h + y
                cache["h"][i].copy_(hst)
                cache["conv"][i].copy_(conv)
            if seg is not None:
                # the shared block's reference path switches to the chunked
                # attention past attn_chunk keys, not 4096 as the dense one
                h, (k, v) = attention(xp["shared"], h, ctx.attn_chunk)
                cache["k"][seg].copy_(k)
                cache["v"][seg].copy_(v)
                h = mlp_block(cfg, xp["shared"], h)
        return head_logits(cfg, yp, h[:, -1:]), cache
    enc_out = (encode(cfg, xp, batch["enc_embeds"], ctx)
               if cfg.family == "encdec" else None)
    for i in range(cfg.n_layers):
        lp = layer(xp["layers"], i)
        h, (k, v) = attention(lp, h, 4096 if ctx.kind == "prefill" else None)
        cache["k"][i].copy_(k)
        cache["v"][i].copy_(v)
        if enc_out is not None:
            h, (ck, cv) = _cross_prefill_block(cfg, lp, h, enc_out, ctx)
            cache["ck"][i].copy_(ck)
            cache["cv"][i].copy_(cv)
        h = mlp_block(cfg, lp, h)
    return head_logits(cfg, yp, h[:, -1:]), cache


# ------------------------------------------------------------------ decode

def decode_step(cfg: ArchConfig, params, cache, token, pos, ctx: ModelCtx):
    """token: [B,1] integer; pos: tokens already cached, a scalar (every
    row at the same position) or a ``[B]`` tensor (continuous batching).
    Writes the token's K/V (or SSM state) into ``cache`` in place; returns
    (logits [B,1,V], cache)."""
    check_family(cfg)
    xp, yp = params["x"], params["y"]
    h = xp["embed"][token]
    pos = torch.as_tensor(pos, device=token.device)
    if cfg.family in ("ssm", "hybrid"):
        step = (_Step(cfg, pos, token.shape[0], cache["k"].shape[2],
                      ctx.window) if "k" in cache else None)
        for seg, idx in mixer_segments(cfg):
            for i in idx:
                lp = layer(xp["layers"], i)
                hn = rmsnorm(h, lp["ln"], cfg.norm_eps)
                y, (hst, conv) = ssm_lib.mixer_decode(cfg, lp, hn,
                                                      cache["h"][i],
                                                      cache["conv"][i])
                h = h + y
                cache["h"][i].copy_(hst)
                cache["conv"][i].copy_(conv)
            if seg is not None:
                # the shared block decodes against its bf16 cache through
                # the plain attend_decode, as in the reference
                h = _attn_decode_block(cfg, xp["shared"], h, cache["k"][seg],
                                       cache["v"][seg], step)
                h = mlp_block(cfg, xp["shared"], h)
        return head_logits(cfg, yp, h), cache
    quant = "k_scale" in cache
    step = _Step(cfg, pos, token.shape[0], cache["k"].shape[2], ctx.window)
    for i in range(cfg.n_layers):
        lp = layer(xp["layers"], i)
        scales = ((cache["k_scale"][i], cache["v_scale"][i]) if quant
                  else None)
        h = _attn_decode_block(cfg, lp, h, cache["k"][i], cache["v"][i],
                               step, scales=scales, attn=ctx.attn)
        if cfg.family == "encdec":
            h = _cross_decode_block(cfg, lp, h, cache["ck"][i],
                                    cache["cv"][i])
        h = mlp_block(cfg, lp, h)
    return head_logits(cfg, yp, h), cache
