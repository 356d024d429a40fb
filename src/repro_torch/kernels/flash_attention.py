"""Forward GQA attention (causal, optional sliding window) on Hopper,
behind a PyTorch wrapper.

``flash_attention`` replaces the Pallas TPU kernel of the same name
(``src/repro/kernels/flash_attention.py:63``). The serve path's prefill
calls it for its self-attention at every prompt length. The inputs are
read through their strides, so the prefill hands in its ``[B, S, H, D]``
projections viewed as ``[B, H, S, D]`` and gets the output in the same
layout.

Dispatch follows the tensors' device: CPU tensors take the plain version
:func:`repro_torch.kernels.ref.flash_attention_ref`; CUDA tensors launch a
kernel or raise (there is no fallback). On the card the dtype picks the
kernel (:func:`source_for`): bf16 runs on the tensor cores
(``csrc/flash_attention_sm90.cu``: wgmma products, TMA tile loads), which
needs 16-byte-aligned starts and (b, head, s) strides and raises
``ValueError`` on a bf16 input without them; f32 runs on the SIMT kernel
(``csrc/flash_attention.cu``), whose f32 FMAs hold the 1e-6 f32 checks
that bf16 products could not. Every launch adds one to
``launches["flash_attention"]``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.storm_update import _on_cpu, _raise_on

launches = {"flash_attention": 0}
HEAD_DIMS = (64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The tensor-core kernel's tiles (csrc/flash_attention_sm90.cu): BQ query
# rows a block (64 a consumer warpgroup), BK keys a tile, STAGES K/V tiles
# in flight.
BQ, BK, STAGES = 128, 128, 2


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def source_for(dtype: torch.dtype) -> str:
    """The CUDA source whose kernel runs ``dtype``: bf16 on the tensor
    cores, f32 on the SIMT kernel."""
    if dtype == torch.bfloat16:
        return "flash_attention_sm90"
    if dtype == torch.float32:
        return "flash_attention"
    raise TypeError(f"no flash_attention kernel for {dtype}")


def sm90_smem_bytes(head_dim: int) -> int:
    """Shared memory of one block of the tensor-core kernel: 1024 bytes of
    slack to align the tiles to the 128-byte swizzle's 1024-byte period, Q
    [BQ, D] and STAGES K and V tiles [BK, D] in bf16, 128 bytes of
    barriers. The kernel refuses a launch whose plan differs from its
    own."""
    check_head_dim(head_dim)
    return 1024 + 2 * head_dim * (BQ + 2 * STAGES * BK) + 128


def _library(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    fn = getattr(lib, f"{name}_fwd")
    if fn.argtypes is None:
        # without argtypes ctypes would pass each pointer as a 32-bit int
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        tail = [i32] if name == "flash_attention_sm90" else [i32, i32]
        fn.argtypes = ([ptr] * 4 + [i32] * 6 + [i64] * 12
                       + [i32, i32, ctypes.c_float] + tail + [ptr])
        fn.restype = ctypes.c_int
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


def tma_strides(name: str, t: torch.Tensor) -> Tuple[int, int, int]:
    """The (b, head, s) strides, in elements, of a bf16 ``[B, heads, S,
    D]`` view as the tensor-core kernel's tensor maps take them. A
    dimension of size 1 is never stepped, so it takes the stride a
    contiguous tensor would give it. Raises ``ValueError`` unless the
    start and every stride are positive multiples of 16 bytes, as TMA
    requires."""
    dense = (t.shape[1] * t.shape[2] * t.shape[3], t.shape[2] * t.shape[3],
             t.shape[3])
    strides = tuple(c if n == 1 else st for n, st, c in
                    zip(t.shape[:3], t.stride()[:3], dense))
    size = t.element_size()
    if (t.data_ptr() % 16 or any(st <= 0 or st * size % 16
                                 for st in strides)):
        raise ValueError(
            f"{name}: the bf16 kernel loads tiles with TMA, which needs a "
            f"16-byte-aligned start and (b, head, s) strides that are "
            f"multiples of 16 bytes; got start {t.data_ptr()} and strides "
            f"{t.stride()[:3]} of {size}-byte elements")
    return strides


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: [B,H,Sq,D]; k,v: [B,KV,Sk,D] (q head h reads kv head
    h // (H/KV)); f32 or bf16, all of one dtype. Returns [B,H,Sq,D] in q's
    dtype and memory layout. On the card bf16 runs the tensor-core kernel
    (16-byte-aligned starts and (b, head, s) strides, else ValueError) and
    f32 the SIMT kernel."""
    if _on_cpu(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return _launch(q, k, v, causal, window)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: Optional[int]) -> torch.Tensor:
    """Checks the inputs, then launches the kernel of their dtype once on
    the current stream of q's device."""
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
    named = (("q", q), ("k", k), ("v", v))
    for name, t in named:
        check_rows(name, t)
    source = source_for(q.dtype)
    if source == "flash_attention_sm90":
        strides = [s for name, t in named for s in tma_strides(name, t)]
        tail = (sm90_smem_bytes(d),)
    else:
        strides = [s for _, t in named for s in t.stride()[:3]]
        tail = (int(aligned16(q, (0, 1, 2))),
                int(aligned16(k, (0, 1, 2)) and aligned16(v, (0, 1, 2))))
    out = torch.empty_like(q)
    scale = float(np.float32(d ** -0.5))
    err = getattr(_library(source), f"{source}_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, kv,
        sq, sk, d, *strides, *out.stride()[:3], int(causal),
        int(window or 0), scale, *tail, _stream(q.device))
    _raise_on(err, "flash_attention")
    launches["flash_attention"] += 1
    return out
