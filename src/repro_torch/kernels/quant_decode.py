"""One-token GQA decode attention over an int8 KV cache on Hopper, behind
a PyTorch wrapper, and the cache's quantizer.

``quant_decode_attention`` replaces the Pallas TPU kernel of the same name
(``src/repro/kernels/quant_decode.py:64``): the serve path's decode calls
it once per layer per tick on the int8 pool. The CUDA source is
``csrc/quant_decode.cu``: one launch a call, whose blocks split the rows'
cache tiles evenly by the positions they read on the card (the rule is
mirrored by :func:`shares`), keep the tiles int8 in shared memory (a
cp.async ring, dequantized in registers) and merge a (row, kv head) split
between blocks inside the kernel. It reads the cache through its strides:
the decode hands in one layer's ``[B, W, KV, Dh]`` pool slice viewed as
``[B, KV, W, Dh]``, with no copy.

``quantize_kv`` is the reference's jnp helper (same file, line 23) as a
plain torch op, level for level.

Dispatch follows the tensors' device: CPU tensors take the plain version
:func:`repro_torch.kernels.ref.quant_decode_ref`; CUDA tensors launch the
kernel or raise (there is no fallback). Every launch adds one to
``launches["quant_decode_attention"]``. The kernel's merge counters are
allocated once per device and left at zero by every call, so calls on one
device must not run on two streams at once.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import (DTYPES, aligned16,
                                                 check_head_dim, check_rows)
from repro_torch.kernels.storm_update import _on_cpu, _raise_on

launches = {"quant_decode_attention": 0}
SMEM_LIMIT = 232_448      # shared memory one block may use on Hopper
# The kernel's plan (csrc/quant_decode.cu): TILE cache slots a tile, STAGES
# tiles in flight, WARPS warps a block; by q's dtype, GROUP query heads a
# pass (the f32 kernel's FMAs hold 5 in registers, the bf16 kernel's
# tensor-core products take 8) and BLOCKS_PER_SM blocks resident on an SM.
TILE, STAGES, WARPS = 64, 3, 4
GROUP = {torch.float32: 5, torch.bfloat16: 8}
BLOCKS_PER_SM = {torch.float32: 2, torch.bfloat16: 3}
_sm_counts: Dict[torch.device, int] = {}
_counter_bufs: Dict[torch.device, List[torch.Tensor]] = {}


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
            [ptr] * 6 + [i64] + [ptr] * 3 + [i32] * 9 + [i64] * 16
            + [ctypes.c_float, i32, i32, ptr])
        lib.quant_decode_attention.restype = ctypes.c_int
    return lib


def _sm_count(device: torch.device) -> int:
    if device not in _sm_counts:
        _sm_counts[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sm_counts[device]


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 merge counters on ``device``, allocated
    once (a larger call allocates more; the older buffers stay alive, as a
    captured graph may hold them). Every call leaves them at zero."""
    bufs = _counter_bufs.setdefault(device, [])
    if not bufs or bufs[-1].numel() < n:
        bufs.append(torch.zeros(max(n, 1024), dtype=torch.int32,
                                device=device))
    return bufs[-1]


def smem_bytes(head_dim: int, dtype: torch.dtype, b: int) -> int:
    """Shared memory of one block for q of ``dtype``: STAGES stages of a
    tile's K and V levels (int8), their f32 scales and GROUP q rows; the
    WARPS warps' merge area (GROUP heads of head_dim + 2 floats each); B
    positions and B + 1 task starts, and a flag (csrc/quant_decode.cu
    ``Plan::bytes``)."""
    check_head_dim(head_dim)
    g = GROUP[dtype]
    stage = 2 * TILE * head_dim + 2 * TILE * 4 + g * head_dim * dtype.itemsize
    return (STAGES * stage + WARPS * g * (head_dim + 2) * 4
            + (2 * b + 2) * 4)


def record_floats(head_dim: int, dtype: torch.dtype) -> int:
    """Floats of one partial record: GROUP heads' head_dim outputs, then
    their (max, denominator), rounded up to whole float4s."""
    return -(-GROUP[dtype] * (head_dim + 2) // 4) * 4


def head_passes(g: int, dtype: torch.dtype) -> Tuple[int, int]:
    """(passes, heads a pass) for a group of g query heads a kv head: the
    fewest passes of at most GROUP[dtype] heads, as even as they go."""
    passes = -(-g // GROUP[dtype])
    return passes, -(-g // passes)


def grid_blocks(b: int, kv: int, s: int, passes: int, sm_count: int,
                dtype: torch.dtype) -> int:
    """Blocks a pass: enough to fill the card once, BLOCKS_PER_SM[dtype]
    an SM over all passes, and no more than the cache's tiles. Host-known
    sizes only, so the launch captures in a CUDA graph."""
    return max(1, min(b * kv * -(-s // TILE),
                      BLOCKS_PER_SM[dtype] * sm_count // passes))


def row_tiles(pos: Sequence[int], s: int) -> List[int]:
    """Tiles a kv head of each row walks: ceil(min(pos, S) / TILE), and
    all S slots' tiles for pos <= 0 (the plain version then averages every
    slot)."""
    return [-(-(min(p, s) if p > 0 else s) // TILE) for p in pos]


def shares(pos: Sequence[int], kv: int, s: int, n_blocks: int):
    """The device's work split, in Python: for each of the ``n_blocks``
    blocks, its tasks (row, kv head, tile) in order. Tasks are numbered
    row-major (tile fastest); with nblk = min(n_blocks, T) of the T tasks,
    block i < nblk takes [i * T // nblk, (i + 1) * T // nblk) and the rest
    none (csrc/quant_decode.cu's header)."""
    tiles = row_tiles(pos, s)
    tasks = [(b, h, j) for b, n in enumerate(tiles) for h in range(kv)
             for j in range(n)]
    total = len(tasks)
    nblk = min(n_blocks, total)
    return [tasks[i * total // nblk:(i + 1) * total // nblk] if i < nblk
            else [] for i in range(n_blocks)]


def block_of(t: int, total: int, n_blocks: int) -> int:
    """The block whose share holds task t (the kernel's closed form)."""
    nblk = min(n_blocks, total)
    return ((t + 1) * nblk - 1) // total


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
    return _launch(q, k8, k_scale, v8, v_scale, pos)


def _launch(q: torch.Tensor, k8: torch.Tensor, k_scale: torch.Tensor,
            v8: torch.Tensor, v_scale: torch.Tensor, pos) -> torch.Tensor:
    """Checks the inputs, then launches the kernel once on the current
    stream of q's device."""
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
    need = smem_bytes(dh, q.dtype, b)
    if need > SMEM_LIMIT:
        raise ValueError(f"{b} rows need {need} bytes of shared memory (the "
                         f"kernel keeps each row's position and first task "
                         f"there), over the {SMEM_LIMIT} a block may use")
    p = _positions(pos, b, q.device)
    passes, gc = head_passes(h // kv, q.dtype)
    n_blocks = grid_blocks(b, kv, s, passes, _sm_count(q.device), q.dtype)
    out = torch.empty((b, h, dh), dtype=q.dtype, device=q.device)
    # the partials of (row, kv head)s split between blocks: per pass, one
    # record per (block + row * KV + kv head) (csrc/quant_decode.cu's
    # header)
    part = torch.empty((passes * (n_blocks + b * kv)
                        * record_floats(dh, q.dtype),), device=q.device)
    counters = _counters(q.device, passes * b * kv)
    scale = float(np.float32(dh ** -0.5))
    err = _library().quant_decode_attention(
        q.data_ptr(), k8.data_ptr(), k_scale.data_ptr(), v8.data_ptr(),
        v_scale.data_ptr(), p.data_ptr(), 0 if p.numel() == 1 else 1,
        out.data_ptr(), part.data_ptr(), counters.data_ptr(), n_blocks,
        passes, gc, DTYPES[q.dtype], b, h, kv, s, dh, *q.stride()[:2],
        *out.stride()[:2], *k8.stride()[:3], *k_scale.stride(),
        *v8.stride()[:3], *v_scale.stride(), scale,
        int(aligned16(k8, (0, 1, 2)) and aligned16(v8, (0, 1, 2))),
        int(aligned16(q, (0, 1))), _stream(q.device))
    _raise_on(err, "quant_decode_attention")
    launches["quant_decode_attention"] += 1
    return out
