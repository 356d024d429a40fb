"""Forward GQA attention (causal, optional sliding window) on Hopper,
behind a PyTorch wrapper.

``flash_attention`` replaces the Pallas TPU kernel of the same name
(``src/repro/kernels/flash_attention.py:63``). The serve path's prefill
calls it for its self-attention at every prompt length; the CUDA source is
``csrc/flash_attention.cu`` (a simple f32 online-softmax kernel, no tensor
cores yet; see its header for the design). The inputs are read through
their strides, so the prefill hands in its ``[B, S, H, D]`` projections
viewed as ``[B, H, S, D]`` and gets the output in the same layout.

Dispatch follows the tensors' device: CPU tensors take the plain version
:func:`repro_torch.kernels.ref.flash_attention_ref`; CUDA tensors launch the
kernel or raise (there is no fallback). Every launch adds one to
``launches["flash_attention"]``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.storm_update import _on_cpu, _raise_on

launches = {"flash_attention": 0}
HEAD_DIMS = (64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.flash_attention_fwd.argtypes is None:
        # without argtypes ctypes would pass each pointer as a 32-bit int
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.flash_attention_fwd.argtypes = (
            [ptr] * 4 + [i32] * 7 + [i64] * 12
            + [i32, i32, ctypes.c_float, i32, i32, ptr])
        lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def aligned16(t: torch.Tensor, dims) -> bool:
    """True when ``t`` starts on a 16-byte boundary and its strides along
    ``dims`` are multiples of 16 bytes (16-byte loads of a row are safe)."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        (t.stride(d) * size) % 16 == 0 for d in dims)


def check_head_dim(d: int) -> None:
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim must be one of {HEAD_DIMS} (the kernel "
                         f"is compiled for those), got {d}")


def check_rows(name: str, t: torch.Tensor) -> None:
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must have a contiguous last dimension, "
                         f"got strides {t.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: [B,H,Sq,D]; k,v: [B,KV,Sk,D] (q head h reads kv head
    h // (H/KV)); f32 or bf16, all of one dtype. Returns [B,H,Sq,D] in q's
    dtype and memory layout."""
    if _on_cpu(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be 4-D [B, heads, S, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of "
                        f"{sorted(map(str, DTYPES))}, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, kv, sk, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must be [B, KV, Sk, D] = [{b}, KV, Sk, "
                         f"{d}], got {tuple(k.shape)} and {tuple(v.shape)}")
    if kv < 1 or h % kv:
        raise ValueError(f"the {h} query heads must split evenly over the "
                         f"{kv} kv heads")
    check_head_dim(d)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 (or None), got {window}")
    if sq < 1 or sk < 1:
        raise ValueError(f"empty sequence: Sq {sq}, Sk {sk}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_rows(name, t)
    out = torch.empty_like(q)
    scale = float(np.float32(d ** -0.5))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        DTYPES[q.dtype], b, h, kv, sq, sk, d, *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], int(causal),
        int(window or 0), scale, int(aligned16(q, (0, 1, 2))),
        int(aligned16(k, (0, 1, 2)) and aligned16(v, (0, 1, 2))), stream)
    _raise_on(err, "flash_attention")
    launches["flash_attention"] += 1
    return out
