"""The dense transformer of the serve path (the dense and vlm families,
which share one branch in the JAX package's ``src/repro/models/model.py``).

Param tree layout (the bilevel split is structural, as in the reference):
  {"x": {"embed", "layers"},            # UL variable (backbone)
   "y": {"final_norm", "head"}}         # LL variable (head)
Every leaf of ``x["layers"]`` is stacked over the layers on its first axis,
and the forward walks the layers with a Python loop over views of them.
The moe, ssm, hybrid and encdec families raise ``NotImplementedError``
naming the slice that brings them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.params import ParamSpec

DENSE_FAMILIES = ("dense", "vlm")
LATER_SLICE = {
    "moe": "the MoE slice (models/moe.py)",
    "ssm": "the SSM serving slice (models/ssm.py, kernel 6 mamba_scan)",
    "hybrid": "the SSM serving slice (models/ssm.py mamba2 + shared "
              "attention)",
    "encdec": "the LM-training slice (encoder and cross-attention)",
}


def check_family(cfg: ArchConfig) -> None:
    """Raise unless ``cfg`` is of a family the port runs so far."""
    if cfg.family in DENSE_FAMILIES:
        return
    if cfg.family in LATER_SLICE:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: it "
            f"comes with {LATER_SLICE[cfg.family]}")
    raise ValueError(f"unknown family {cfg.family!r}")


@dataclasses.dataclass(frozen=True)
class ModelCtx:
    """Per-call options (the reference's, without sharding rules).

    ``attn`` picks the serve path's attention, prefill and int8 decode
    together: "kernel" the ``flash_attention`` and ``quant_decode_attention``
    wrappers (the CUDA kernels on CUDA tensors, their plain versions on the
    CPU), "plain" the plain versions on any device, "reference" the
    reference's own paths (``attend_full``, probabilities rounded to the
    model dtype before the PV product, ``attend_flash`` past 4096 prompt
    tokens; the int8 cache dequantized to the model dtype, then
    ``attend_decode``)."""
    window: Optional[int] = None      # sliding-window attention
    kind: str = "train"               # train | prefill | decode
    attn_chunk: int = 1024
    attn: str = "kernel"


ATTN_PATHS = ("kernel", "plain", "reference")


# ------------------------------------------------------------------ specs

def _attn_specs(cfg: ArchConfig, L: int, prefix="") -> Dict[str, ParamSpec]:
    d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    ax = ("layers",) if L else ()
    shp = (L,) if L else ()
    s = {
        prefix + "ln_attn": ParamSpec(shp + (d,), ax + ("embed",),
                                      init="ones", dtype="float32"),
        prefix + "wq": ParamSpec(shp + (d, h, hd),
                                 ax + ("embed", "heads", "head_dim")),
        prefix + "wk": ParamSpec(shp + (d, kv, hd),
                                 ax + ("embed", "kv_heads", "head_dim")),
        prefix + "wv": ParamSpec(shp + (d, kv, hd),
                                 ax + ("embed", "kv_heads", "head_dim")),
        prefix + "wo": ParamSpec(shp + (h, hd, d),
                                 ax + ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        s[prefix + "bq"] = ParamSpec(shp + (h, hd), ax + ("heads", "head_dim"),
                                     init="zeros")
        s[prefix + "bk"] = ParamSpec(shp + (kv, hd),
                                     ax + ("kv_heads", "head_dim"),
                                     init="zeros")
        s[prefix + "bv"] = ParamSpec(shp + (kv, hd),
                                     ax + ("kv_heads", "head_dim"),
                                     init="zeros")
    return s


def _mlp_specs(cfg: ArchConfig, L: int, d_ff: int) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    ax = ("layers",) if L else ()
    shp = (L,) if L else ()
    return {
        "ln_mlp": ParamSpec(shp + (d,), ax + ("embed",), init="ones",
                            dtype="float32"),
        "wi": ParamSpec(shp + (d, d_ff), ax + ("embed", "mlp")),
        "wu": ParamSpec(shp + (d, d_ff), ax + ("embed", "mlp")),
        "wd": ParamSpec(shp + (d_ff, d), ax + ("mlp", "embed")),
    }


def model_specs(cfg: ArchConfig) -> Dict[str, Any]:
    check_family(cfg)
    L = cfg.n_layers
    x = {"embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab_in", "embed")),
         "layers": {**_attn_specs(cfg, L), **_mlp_specs(cfg, L, cfg.d_ff)}}
    y = {"final_norm": ParamSpec((cfg.d_model,), ("embed",), init="ones",
                                 dtype="float32"),
         "head": ParamSpec((cfg.d_model, cfg.vocab), ("embed", "vocab"))}
    return {"x": x, "y": y}


def layer(stacked: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s params: views into the stacked leaves."""
    return {k: v[i] for k, v in stacked.items()}


# ------------------------------------------------------------------ primitives

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """The statistic in f32, the multiply in ``x.dtype`` (the reference's
    order: ``x * (r.astype(x.dtype) * w.astype(x.dtype))``)."""
    xf = x.float()
    xx = (xf * xf).sum(-1, keepdim=True)
    r = torch.rsqrt(xx / x.shape[-1] + eps)
    return x * (r.to(x.dtype) * w.to(x.dtype))


def proj(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,d...->bs...")``: h [B,S,d] against w [d, ...]."""
    return (h @ w.reshape(w.shape[0], -1)).reshape(*h.shape[:-1],
                                                   *w.shape[1:])


def out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd")``: o [B,S,H,Dh] against wo [H,Dh,d]."""
    return o.reshape(*o.shape[:2], -1) @ wo.reshape(-1, wo.shape[-1])


def qkv(cfg: ArchConfig, p, hn: torch.Tensor, prefix=""):
    q = proj(hn, p[prefix + "wq"])
    k = proj(hn, p[prefix + "wk"])
    v = proj(hn, p[prefix + "wv"])
    if cfg.qkv_bias and (prefix + "bq") in p:
        q, k, v = (q + p[prefix + "bq"], k + p[prefix + "bk"],
                   v + p[prefix + "bv"])
    return q, k, v


def _attn_block(cfg: ArchConfig, p, h, ctx: ModelCtx, *, pos,
                causal=True):
    """Self-attention block of the training forward. h: [B,S,d]."""
    hn = rmsnorm(h, p["ln_attn"], cfg.norm_eps)
    q, k, v = qkv(cfg, p, hn)
    q = attn_lib.rope(q, pos, cfg.rope_theta)
    k = attn_lib.rope(k, pos, cfg.rope_theta)
    if k.shape[1] > ctx.attn_chunk:
        o = attn_lib.attend_flash(q, k, v, causal=causal, window=ctx.window,
                                  chunk=ctx.attn_chunk)
    else:
        o = attn_lib.attend_full(q, k, v, causal=causal, window=ctx.window)
    return h + out_proj(o, p["wo"])


def mlp_block(cfg: ArchConfig, p, h: torch.Tensor) -> torch.Tensor:
    hn = rmsnorm(h, p["ln_mlp"], cfg.norm_eps)
    g = hn @ p["wi"]
    u = hn @ p["wu"]
    return h + (F.silu(g) * u) @ p["wd"]


# ------------------------------------------------------------------ features

def embed_tokens(cfg: ArchConfig, xp, tokens: torch.Tensor,
                 prefix_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    h = xp["embed"][tokens]
    if prefix_embeds is not None and cfg.n_prefix_embeds:
        npfx = prefix_embeds.shape[1]
        h = torch.cat([prefix_embeds.to(h.dtype), h[:, npfx:]], dim=1)
    return h


def features(cfg: ArchConfig, xp, batch: Dict[str, torch.Tensor],
             ctx: ModelCtx) -> torch.Tensor:
    """Backbone features [B,S,d] (everything but the final norm and the LM
    head), through the plain attention paths: the training forward keeps
    them until the flash kernel has a backward."""
    check_family(cfg)
    tokens = batch["tokens"]
    h = embed_tokens(cfg, xp, tokens, batch.get("prefix_embeds"))
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    for i in range(cfg.n_layers):
        lp = layer(xp["layers"], i)
        h = _attn_block(cfg, lp, h, ctx, pos=pos)
        h = mlp_block(cfg, lp, h)
    return h


def head_logits(cfg: ArchConfig, yp, feats: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(feats, yp["final_norm"], cfg.norm_eps)
    return h @ yp["head"]


def forward(cfg: ArchConfig, params, batch, ctx: ModelCtx) -> torch.Tensor:
    return head_logits(cfg, params["y"], features(cfg, params["x"], batch,
                                                  ctx))
