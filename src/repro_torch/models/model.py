"""The unified model (``src/repro/models/model.py``) for every family of
the JAX package:
  dense/vlm : GQA attention + gated MLP (optional qkv bias / window /
              prefix fusion)
  moe       : GQA attention + top-k MoE (optional shared FFN;
              ``models/moe.py``)
  ssm       : mamba1 mixer only (``models/ssm.py``)
  hybrid    : mamba2 mixers + ONE weight-tied shared attention block every
              ``shared_attn_every`` layers
  encdec    : whisper-style encoder over stubbed frame embeddings
              (``enc_embeds``, not causal, RoPE over the frames, a final
              norm) + a decoder whose layers add cross-attention over the
              encoder's output (no norm on that side, no RoPE)

Param tree layout (the bilevel split is structural, as in the reference):
  {"x": {"embed", "layers", ["shared"], ["encoder"]},  # UL (backbone)
   "y": {"final_norm", "head"}}                        # LL (head)
Every leaf of ``x["layers"]`` (and of ``x["encoder"]["layers"]``) is
stacked over the layers on its first axis, and the forward walks the
layers with a Python loop over views of them. An encdec decoder layer's
cross-attention leaves carry the prefix ``c`` (``cln_attn``, ``cwq``,
``cwk``, ``cwv``, ``cwo``); ``x["encoder"]`` holds ``layers`` and
``ln_out``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.params import ParamSpec
from repro_torch.models.remat import remat_layer

PORTED_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")


def check_family(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` unless ``cfg`` is of a family the model
    knows."""
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")


@dataclasses.dataclass(frozen=True)
class ModelCtx:
    """Per-call options (the reference's, without sharding rules).

    ``attn`` picks the serve path's kernels, prefill and decode together:
    "kernel" the ``flash_attention``, ``quant_decode_attention`` and
    ``mamba_scan`` wrappers (the CUDA kernels on CUDA tensors, their plain
    versions on the CPU), "plain" the plain versions on any device,
    "reference" the reference's own paths (``attend_full``, probabilities
    rounded to the model dtype before the PV product, ``attend_flash`` past
    4096 prompt tokens, or past ``attn_chunk`` in the hybrid's shared
    block; the int8 cache dequantized to the model dtype, then
    ``attend_decode``; the mamba1 prefill's chunked associative scan of
    ``ssm_chunk`` steps; the encdec encoder's and cross-attention's
    ``attend_flash`` past ``attn_chunk`` keys)."""
    window: Optional[int] = None      # sliding-window attention
    kind: str = "train"               # train | prefill | decode
    attn_chunk: int = 1024
    ssm_chunk: int = 256
    attn: str = "kernel"


ATTN_PATHS = ("kernel", "plain", "reference")
# an encdec decoder layer's cross-attention K and V, projected from the
# encoder's output outside the layer (``features``), ride in its params
# under these keys in place of the leaves that project them
CROSS_KV = ("ck", "cv")
CROSS_KV_LEAVES = ("cwk", "cwv", "cbk", "cbv")


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
    x = {"embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab_in", "embed"))}
    if cfg.family == "ssm":
        x["layers"] = ssm_lib.mamba1_specs(cfg, L)
    elif cfg.family == "hybrid":
        x["layers"] = ssm_lib.mamba2_specs(cfg, L)
        x["shared"] = {**_attn_specs(cfg, 0), **_mlp_specs(cfg, 0, cfg.d_ff)}
    elif cfg.family == "moe":
        x["layers"] = {**_attn_specs(cfg, L), **moe_lib.moe_specs(cfg, L),
                       "ln_mlp": ParamSpec((L, cfg.d_model),
                                           ("layers", "embed"), init="ones",
                                           dtype="float32")}
    else:
        x["layers"] = {**_attn_specs(cfg, L), **_mlp_specs(cfg, L, cfg.d_ff)}
    if cfg.family == "encdec":
        x["layers"].update(_attn_specs(cfg, L, prefix="c"))  # cross-attention
        le = cfg.encoder.n_layers
        x["encoder"] = {
            "layers": {**_attn_specs(cfg, le), **_mlp_specs(cfg, le,
                                                            cfg.d_ff)},
            "ln_out": ParamSpec((cfg.d_model,), ("embed",), init="ones",
                                dtype="float32")}
    y = {"final_norm": ParamSpec((cfg.d_model,), ("embed",), init="ones",
                                 dtype="float32"),
         "head": ParamSpec((cfg.d_model, cfg.vocab), ("embed", "vocab"))}
    return {"x": x, "y": y}


def layer(stacked: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s params: views into the stacked leaves."""
    return {k: v[i] for k, v in stacked.items()}


def layers(stacked: Dict[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
    """Every layer's params, one ``unbind`` of each stacked leaf: under
    autograd its backward stacks the layers' gradients once, where taking
    each layer's slice would backpropagate a zero-padded gradient of the
    whole stacked leaf per layer (at qwen1.5-4b's depth a third of a
    training step's device time). The same values either way."""
    per = {k: v.unbind(0) for k, v in stacked.items()}
    n = len(next(iter(per.values())))
    return [{k: per[k][i] for k in per} for i in range(n)]


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


def cross_query(cfg: ArchConfig, p, h: torch.Tensor) -> torch.Tensor:
    """An encdec decoder layer's cross-attention Q [B,S,H,Dh]: from its
    normed input, no RoPE."""
    q = proj(rmsnorm(h, p["cln_attn"], cfg.norm_eps), p["cwq"])
    return q + p["cbq"] if cfg.qkv_bias and "cbq" in p else q


def cross_kv(cfg: ArchConfig, p, enc_out: torch.Tensor):
    """Its K and V [B,Senc,KV,Dh]: from the encoder's output as it is (no
    norm, no RoPE)."""
    k, v = proj(enc_out, p["cwk"]), proj(enc_out, p["cwv"])
    if cfg.qkv_bias and "cbk" in p:
        k, v = k + p["cbk"], v + p["cbv"]
    return k, v


def _cross_block(cfg: ArchConfig, p, h, k, v, ctx: ModelCtx):
    """Cross-attention block of the training forward: Q from ``h`` over
    the encoder's K and V, no mask (``attend_flash`` past ``attn_chunk``
    frames)."""
    q = cross_query(cfg, p, h)
    if k.shape[1] > ctx.attn_chunk:
        o = attn_lib.attend_flash(q, k, v, causal=False, window=ctx.window,
                                  chunk=ctx.attn_chunk)
    else:
        o = attn_lib.attend_full(q, k, v, causal=False)
    return h + out_proj(o, p["cwo"])


def mlp_block(cfg: ArchConfig, p, h: torch.Tensor) -> torch.Tensor:
    """The layer's MLP with its norm and residual: the gated MLP, or the
    MoE layer for the moe family (the hybrid's shared block is dense)."""
    hn = rmsnorm(h, p["ln_mlp"], cfg.norm_eps)
    if cfg.family == "moe":
        return h + moe_lib.apply_moe(cfg, p, hn)
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
    head), through the reference's paths (``attend_full``/``attend_flash``,
    the chunked scan): the training forward keeps them until the kernels
    have a backward.

    With ``ctx.kind == "train"`` each layer runs under
    :func:`~repro_torch.models.remat.remat_layer`, as the reference runs
    each under ``jax.checkpoint``: the attention block and the MLP of a
    dense, vlm or moe layer, the norm, mixer and residual of an ssm or hybrid
    layer. A layer then keeps only its input for the backward, which
    recomputes it (the falcon-mamba-7b scan's residuals are gigabytes a
    layer). The hybrid's weight-tied shared block runs directly, as in the
    reference (``_hybrid_seq``). An encdec model runs its encoder first
    (:func:`encoder_forward`), then each decoder layer: self-attention,
    cross-attention over K and V projected from the encoder's output, the
    MLP. The values and gradients are those of the direct layers, bit for
    bit."""
    check_family(cfg)
    tokens = batch["tokens"]
    h = embed_tokens(cfg, xp, tokens, batch.get("prefix_embeds"))
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    per_layer = layers(xp["layers"])

    def run(body, h, lp):
        return (remat_layer(body, h, lp) if ctx.kind == "train"
                else body(h, lp))

    if cfg.family in ("ssm", "hybrid"):
        def mixer_layer(h, lp):
            hn = rmsnorm(h, lp["ln"], cfg.norm_eps)
            return h + ssm_lib.mixer_seq(cfg, lp, hn, ctx.ssm_chunk)[0]

        for seg, idx in mixer_segments(cfg):
            for i in idx:
                h = run(mixer_layer, h, per_layer[i])
            if seg is not None:
                h = _attn_block(cfg, xp["shared"], h, ctx, pos=pos)
                h = mlp_block(cfg, xp["shared"], h)
        return h

    if cfg.family == "encdec":
        enc_out = encoder_forward(cfg, xp, batch["enc_embeds"], ctx)

        def decoder_layer(h, lp):
            lpos = torch.arange(h.shape[1], device=h.device)
            h = _attn_block(cfg, lp, h, ctx, pos=lpos)
            h = _cross_block(cfg, lp, h, *(lp[n] for n in CROSS_KV), ctx)
            return mlp_block(cfg, lp, h)

        for lp in per_layer:
            # K and V are projected here and go into the layer as entries
            # of its params: under remat they are then the Function's
            # inputs, so the gradient reaches x["encoder"], and enc_out's
            # gradient sums its 2L uses in the same order as without remat
            inner = {n: t for n, t in lp.items() if n not in CROSS_KV_LEAVES}
            h = run(decoder_layer, h, {**inner, **dict(zip(
                CROSS_KV, cross_kv(cfg, lp, enc_out)))})
        return h

    def dense_layer(h, lp):
        # the positions are made here, not closed over: a layer under
        # remat_layer may close over no tensor
        lpos = torch.arange(h.shape[1], device=h.device)
        return mlp_block(cfg, lp, _attn_block(cfg, lp, h, ctx, pos=lpos))

    for lp in per_layer:
        h = run(dense_layer, h, lp)
    return h


def encoder_forward(cfg: ArchConfig, xp, enc_embeds: torch.Tensor,
                    ctx: ModelCtx) -> torch.Tensor:
    """The whisper-style encoder over stubbed frame embeddings [B,Senc,d]:
    each layer self-attention (not causal, RoPE over the frame positions;
    ``attend_flash`` past ``attn_chunk`` frames) and the MLP, under remat
    in training; then ``ln_out``. The embeddings enter in the model's
    dtype, as the prefix embeddings do (``embed_tokens``): the trainer's
    batches carry them in bf16 whatever the model's dtype."""
    ep = xp["encoder"]
    h = enc_embeds.to(xp["embed"].dtype)

    def encoder_layer(h, lp):
        lpos = torch.arange(h.shape[1], device=h.device)
        return mlp_block(cfg, lp, _attn_block(cfg, lp, h, ctx, pos=lpos,
                                              causal=False))

    for lp in layers(ep["layers"]):
        h = (remat_layer(encoder_layer, h, lp) if ctx.kind == "train"
             else encoder_layer(h, lp))
    return rmsnorm(h, ep["ln_out"], cfg.norm_eps)


def mixer_segments(cfg: ArchConfig):
    """The ssm and hybrid families' layer order: ``(segment, layer
    indices)`` for each segment of ``shared_attn_every`` mamba2 layers,
    each followed by the shared block (zamba2), then ``(None, rest)`` for
    the layers with no shared block after them (every layer of an ssm
    model; zamba2's tail)."""
    every = cfg.shared_attn_every if cfg.family == "hybrid" else 0
    nseg = cfg.n_layers // every if every else 0
    out = [(s, range(s * every, (s + 1) * every)) for s in range(nseg)]
    if cfg.n_layers > nseg * every:
        out.append((None, range(nseg * every, cfg.n_layers)))
    return out


def head_logits(cfg: ArchConfig, yp, feats: torch.Tensor) -> torch.Tensor:
    """Final norm and LM head; the product in the promoted dtype of the
    two, as JAX promotes (bf16 features cached against an f32 head give
    f32 logits)."""
    h = rmsnorm(feats, yp["final_norm"], cfg.norm_eps)
    dt = torch.promote_types(h.dtype, yp["head"].dtype)
    return h.to(dt) @ yp["head"].to(dt)


def forward(cfg: ArchConfig, params, batch, ctx: ModelCtx) -> torch.Tensor:
    return head_logits(cfg, params["y"], features(cfg, params["x"], batch,
                                                  ctx))
