"""One-token GQA decode attention over an int8 KV cache on Hopper, behind
a PyTorch wrapper, and the cache's quantizer.

``quant_decode_attention`` replaces the Pallas TPU kernel of the same name
(``src/repro/kernels/quant_decode.py:64``): the serve path's decode calls
it once per layer per tick on the int8 pool. The CUDA source is
``csrc/quant_decode.cu``; it dequantizes in shared memory and runs an f32
online softmax, one block per (row, kv head, run of cache tiles) with a
second pass that merges the runs, and skips the cache tiles at or past
each row's position. It reads the cache through its strides: the
decode hands in one layer's ``[B, W, KV, Dh]`` pool slice viewed as
``[B, KV, W, Dh]``, with no copy.

``quantize_kv`` is the reference's jnp helper (same file, line 23) as a
plain torch op, level for level.

Dispatch follows the tensors' device: CPU tensors take the plain version
:func:`repro_torch.kernels.ref.quant_decode_ref`; CUDA tensors launch the
kernel or raise (there is no fallback). Every launch adds one to
``launches["quant_decode_attention"]``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import (DTYPES, aligned16,
                                                 check_head_dim, check_rows)
from repro_torch.kernels.storm_update import _on_cpu, _raise_on

launches = {"quant_decode_attention": 0}
SMEM_LIMIT = 232_448      # shared memory one block may use on Hopper
TILE = 64                 # cache slots per tile (BS in csrc/quant_decode.cu)
_sm_count = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def quantize_kv(k: torch.Tensor):
    """[...] -> (int8 levels, f32 scale over the last dim): scale =
    amax|k| / 127 + 1e-8 in f32, levels round(k / scale) half to even,
    clipped to ±127 (a true division, as the reference: a multiply by the
    reciprocal would move levels at rounding boundaries)."""
    kf = k.float()
    scale = kf.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-8
    q = torch.clamp(torch.round(kf / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def _library() -> ctypes.CDLL:
    lib = _build.load("quant_decode")
    if lib.quant_decode_attention.argtypes is None:
        # without argtypes ctypes would pass each pointer as a 32-bit int
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.quant_decode_attention.argtypes = (
            [ptr] * 6 + [i64, ptr, ptr] + [i32] * 8 + [i64] * 16
            + [ctypes.c_float, i32, ptr])
        lib.quant_decode_attention.restype = ctypes.c_int
        lib.quant_decode_smem_bytes.argtypes = [i32, i32]
        lib.quant_decode_smem_bytes.restype = i64
    return lib


def split_plan(b: int, kv: int, s: int, device):
    """(n_split, tiles_per_split): each row's cache tiles cut into runs so
    that the B * KV * n_split blocks number about two per SM."""
    if device not in _sm_count:
        _sm_count[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    tiles = -(-s // TILE)
    want = -(-2 * _sm_count[device] // (b * kv))
    per = -(-tiles // max(1, min(want, tiles)))
    return -(-tiles // per), per


def _positions(pos, b: int, device) -> torch.Tensor:
    """``pos`` as int32 on ``device``: a scalar as one element read by every
    row (stride 0), or a ``[B]`` vector. No host sync."""
    if not isinstance(pos, torch.Tensor):
        return torch.full((1,), int(pos), dtype=torch.int32, device=device)
    if pos.device != device:
        raise ValueError(f"pos must be on {device}, got {pos.device}")
    if pos.dim() == 0 or pos.shape == (1,):
        return pos.reshape(1).to(torch.int32)
    if pos.shape != (b,):
        raise ValueError(f"pos must be a scalar or [B] = [{b}], got "
                         f"{tuple(pos.shape)}")
    return pos.to(torch.int32).contiguous()


def quant_decode_attention(q: torch.Tensor, k8: torch.Tensor,
                           k_scale: torch.Tensor, v8: torch.Tensor,
                           v_scale: torch.Tensor, pos) -> torch.Tensor:
    """q: [B,H,Dh] (one token, f32 or bf16); k8/v8: [B,KV,S,Dh] int8;
    scales: [B,KV,S] f32; pos: the valid length, a scalar or ``[B]`` per
    row. Returns [B,H,Dh] in q's dtype."""
    if _on_cpu(q, k8, k_scale, v8, v_scale):
        return ref.quant_decode_ref(q, k8, k_scale, v8, v_scale, pos)
    if q.dim() != 3 or k8.dim() != 4:
        raise ValueError(f"q must be [B, H, Dh] and k8 [B, KV, S, Dh], got "
                         f"{tuple(q.shape)} and {tuple(k8.shape)}")
    if q.dtype not in DTYPES:
        raise TypeError(f"q must be one of {sorted(map(str, DTYPES))}, got "
                        f"{q.dtype}")
    if k8.dtype != torch.int8 or v8.dtype != torch.int8:
        raise TypeError(f"k8 and v8 must be int8, got {k8.dtype} and "
                        f"{v8.dtype}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError(f"scales must be float32, got {k_scale.dtype} and "
                        f"{v_scale.dtype}")
    b, h, dh = q.shape
    kv, s = k8.shape[1], k8.shape[2]
    if tuple(k8.shape) != (b, kv, s, dh) or v8.shape != k8.shape:
        raise ValueError(f"k8 and v8 must be [B, KV, S, Dh] = [{b}, KV, S, "
                         f"{dh}], got {tuple(k8.shape)} and "
                         f"{tuple(v8.shape)}")
    if k_scale.shape != (b, kv, s) or v_scale.shape != (b, kv, s):
        raise ValueError(f"scales must be [B, KV, S] = [{b}, {kv}, {s}], got "
                         f"{tuple(k_scale.shape)} and {tuple(v_scale.shape)}")
    if kv < 1 or h % kv:
        raise ValueError(f"the {h} query heads must split evenly over the "
                         f"{kv} kv heads")
    check_head_dim(dh)
    if s < 1:
        raise ValueError("empty cache")
    for name, t in (("q", q), ("k8", k8), ("v8", v8)):
        check_rows(name, t)
    lib = _library()
    need = lib.quant_decode_smem_bytes(dh, h // kv)
    if need > SMEM_LIMIT:
        raise ValueError(f"a group of {h // kv} query heads of {dh} needs "
                         f"{need} bytes of shared memory, over the "
                         f"{SMEM_LIMIT} a block may use")
    p = _positions(pos, b, q.device)
    out = torch.empty((b, h, dh), dtype=q.dtype, device=q.device)
    n_split, per = split_plan(b, kv, s, q.device)
    # scratch of the runs' partial results: [B, KV, n_split, H/KV, Dh + 2]
    part = torch.empty((b * n_split * h * (dh + 2) if n_split > 1 else 0,),
                       device=q.device)
    scale = float(np.float32(dh ** -0.5))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.quant_decode_attention(
        q.data_ptr(), k8.data_ptr(), k_scale.data_ptr(), v8.data_ptr(),
        v_scale.data_ptr(), p.data_ptr(), 0 if p.numel() == 1 else 1,
        out.data_ptr(), part.data_ptr(), n_split, per, DTYPES[q.dtype], b,
        h, kv, s, dh, *q.stride()[:2],
        *out.stride()[:2], *k8.stride()[:3], *k_scale.stride(),
        *v8.stride()[:3], *v_scale.stride(), scale,
        int(aligned16(k8, (0, 1, 2)) and aligned16(v8, (0, 1, 2))), stream)
    _raise_on(err, "quant_decode_attention")
    launches["quant_decode_attention"] += 1
    return out
