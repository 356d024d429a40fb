"""Serving programs for the global model (x̄, ȳ), with no client axis: the
prefill and one-token decode callables and the abstract shapes of their
inputs (``src/repro/fed/serve.py``). The JAX package returns ``jax.jit``
programs; PyTorch runs eagerly, so these are plain callables over the
model functions. Sharded serving (``mesh=``) comes with the port's
``sharding`` slice."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.decode import cache_spec, decode_step, prefill
from repro_torch.models.model import ModelCtx
from repro_torch.models.params import TensorSpec, torch_dtype

# kv_kernel (the reference's knob, under the port's names) -> ModelCtx.attn:
# "auto" and "kernel" the kernels' wrappers ("kernel" is refused off the
# card by the engine), "xla" the reference's paths
KV_KERNELS = {"auto": "kernel", "kernel": "kernel", "xla": "reference"}
TPU_KV_KERNELS = ("pallas", "interpret")


def check_kv_kernel(kv_kernel: str) -> None:
    if kv_kernel in TPU_KV_KERNELS:
        raise ValueError(f"kv_kernel={kv_kernel!r} names the JAX package's "
                         f"Pallas kernel; the port's choices are "
                         f"{tuple(KV_KERNELS)}")
    if kv_kernel not in KV_KERNELS:
        raise ValueError(f"kv_kernel must be one of {tuple(KV_KERNELS)}, "
                         f"got {kv_kernel!r}")


def serve_window(cfg: ArchConfig, shape: ShapeConfig) -> Optional[int]:
    """long_500k: attention archs fall back to their sliding-window
    variant."""
    if shape.seq_len > 65536 and cfg.family != "ssm":
        return cfg.long_context_window
    return None


def serve_batch_specs(cfg: ArchConfig, shape: ShapeConfig, kind: str
                      ) -> Tuple[Dict[str, TensorSpec], Dict[str, Any]]:
    """The prefill's or decode's input shapes: an encdec prefill takes
    ``max(S // 4, 8)`` decoder tokens and ``enc_embeds`` [B, S, d] (S the
    frames); the embeddings in the model's dtype, as they enter the
    residual stream."""
    b, s = shape.global_batch, shape.seq_len
    emb = torch_dtype(cfg.dtype)
    specs: Dict[str, TensorSpec] = {}
    axes: Dict[str, Any] = {}
    if kind == "prefill":
        sdec = max(s // 4, 8) if cfg.family == "encdec" else s
        specs["tokens"] = TensorSpec((b, sdec), torch.int32)
        axes["tokens"] = ("batch", None)
        if cfg.n_prefix_embeds:
            specs["prefix_embeds"] = TensorSpec(
                (b, cfg.n_prefix_embeds, cfg.d_model), emb)
            axes["prefix_embeds"] = ("batch", None, "act_embed")
        if cfg.family == "encdec":
            specs["enc_embeds"] = TensorSpec((b, s, cfg.d_model), emb)
            axes["enc_embeds"] = ("batch", "seq", "act_embed")
    else:
        specs["token"] = TensorSpec((b, 1), torch.int32)
        axes["token"] = ("batch", None)
    return specs, axes


def serve_cache(cfg: ArchConfig, shape: ShapeConfig, kv_quant: bool = False):
    window = serve_window(cfg, shape)
    enc_len = shape.seq_len if cfg.family == "encdec" else 0
    spec, axes = cache_spec(cfg, shape.global_batch, shape.seq_len,
                            window=window, enc_len=enc_len, quant=kv_quant)
    return spec, axes, window


def build_serve_fns(cfg: ArchConfig, shape: ShapeConfig, mesh=None,
                    kv_quant: bool = False, kv_kernel: str = "auto"
                    ) -> Dict[str, Any]:
    """A dict with the ``prefill(params, batch, cache)`` and
    ``decode(params, cache, token, pos)`` callables, the cache's and the
    batch's TensorSpecs, the window and the ``ModelCtx``. ``kv_kernel``
    picks the attention path of both (``KV_KERNELS``)."""
    if mesh is not None:
        raise NotImplementedError("sharded serving (mesh=) comes with the "
                                  "port's sharding slice; pass mesh=None")
    check_kv_kernel(kv_kernel)
    cache_abs, _, window = serve_cache(cfg, shape, kv_quant)
    kind = "prefill" if shape.kind == "prefill" else "decode"
    ctx = ModelCtx(kind=kind, window=window, attn=KV_KERNELS[kv_kernel])

    def prefill_fn(params, batch, cache):
        return prefill(cfg, params, batch, cache, ctx)

    def decode_fn(params, cache, token, pos):
        return decode_step(cfg, params, cache, token, pos, ctx)

    batch_specs, _ = serve_batch_specs(cfg, shape, kind)
    return {"cache_abs": cache_abs, "window": window, "ctx": ctx,
            "batch_specs": batch_specs, "prefill": prefill_fn,
            "decode": decode_fn}
