"""The int8 codec's quantize and dequantize kernels on Hopper, behind
PyTorch wrappers.

``quantize_stoch`` and ``dequantize`` replace the Pallas TPU kernels of the
same names (``src/repro/kernels/quantize.py``). The TPU kernels take one 1-D
buffer and one scalar scale, so the reference calls them once per leaf per
client. These take client-stacked rows: an ``[M, n]`` buffer cut into L
segments at ``offsets`` ([L+1] int64, 0 to n), with one f32 scale per
(row, segment) in ``scale`` [M, L]; one launch covers every row and
segment. The codec (:mod:`repro_torch.fed.compress`) hands them one leaf
at a time, a one-segment table over the cohort's rows; a packed message
of many leaves is one call too. The CUDA source is ``csrc/quantize.cu``;
both are bound by memory (9 and 5 bytes per element).

Dispatch follows the tensors' device: CPU tensors take the plain versions in
:mod:`repro_torch.kernels.ref`; CUDA tensors launch the kernel or raise
(there is no fallback). Every launch adds one to ``launches[name]``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.storm_update import _check_buffer, _on_cpu, _raise_on

launches = {"quantize_stoch": 0, "dequantize": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _library() -> ctypes.CDLL:
    lib = _build.load("quantize")
    if lib.quantize_stoch_i8.argtypes is None:
        # without argtypes ctypes would pass each pointer as a 32-bit int
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.quantize_stoch_i8.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64,
                                          i64, ptr, ptr]
        lib.quantize_stoch_i8.restype = ctypes.c_int
        lib.dequantize_i8.argtypes = [ptr, ptr, ptr, i64, i64, i64, ptr, ptr]
        lib.dequantize_i8.restype = ctypes.c_int
    return lib


def _check_segments(scale: torch.Tensor, offsets: torch.Tensor, rows: int,
                    device) -> int:
    """The segment count L; ``scale`` must be [rows, L] f32 and ``offsets``
    [L+1] int64, both contiguous on ``device``. The offsets' values are the
    caller's contract (0, nondecreasing, n at the end): checking them would
    read device memory and wait for the card."""
    if offsets.dtype != torch.int64 or offsets.dim() != 1 or (
            offsets.numel() < 2):
        raise TypeError(f"offsets must be a 1-D int64 tensor of L+1 >= 2 "
                        f"entries, got {offsets.dtype} {tuple(offsets.shape)}")
    n_seg = offsets.numel() - 1
    _check_buffer("scale", scale, (rows, n_seg))
    for name, t in (("scale", scale), ("offsets", offsets)):
        if t.device != device:
            raise ValueError(f"{name} must be on {device}, got {t.device}")
    if not offsets.is_contiguous():
        raise ValueError("offsets must be contiguous")
    return n_seg


def quantize_stoch(x: torch.Tensor, u: torch.Tensor, scale: torch.Tensor,
                   offsets: torch.Tensor, qmax: int) -> torch.Tensor:
    """q = clip(floor(x / scale + u), ±qmax) as int8 over ``[M, n]`` f32
    rows, one scale per (row, segment); ``u`` is uniform[0, 1) noise."""
    if _on_cpu(x, u, scale, offsets):
        return ref.quantize_stoch_ref(x, u, scale, offsets, qmax)
    if x.dim() != 2:
        raise ValueError(f"x must be [M, n], got shape {tuple(x.shape)}")
    if not 1 <= qmax <= 127:
        raise ValueError(f"qmax must be in [1, 127] for int8 levels, "
                         f"got {qmax}")
    rows, n = x.shape
    _check_buffer("x", x, (rows, n))
    _check_buffer("u", u, (rows, n))
    n_seg = _check_segments(scale, offsets, rows, x.device)
    out = torch.empty((rows, n), dtype=torch.int8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _library().quantize_stoch_i8(
        x.data_ptr(), u.data_ptr(), scale.data_ptr(), offsets.data_ptr(),
        n_seg, rows, n, int(qmax), out.data_ptr(), stream)
    _raise_on(err, "quantize_stoch")
    launches["quantize_stoch"] += 1
    return out


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               offsets: torch.Tensor) -> torch.Tensor:
    """x = q * scale back to f32 over ``[M, n]`` int8 rows, one scale per
    (row, segment)."""
    if _on_cpu(q, scale, offsets):
        return ref.dequantize_ref(q, scale, offsets)
    if q.dim() != 2:
        raise ValueError(f"q must be [M, n], got shape {tuple(q.shape)}")
    if q.dtype != torch.int8:
        raise TypeError(f"q must be int8, got {q.dtype}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    rows, n = q.shape
    n_seg = _check_segments(scale, offsets, rows, q.device)
    out = torch.empty((rows, n), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _library().dequantize_i8(
        q.data_ptr(), scale.data_ptr(), offsets.data_ptr(), n_seg, rows, n,
        out.data_ptr(), stream)
    _raise_on(err, "dequantize")
    launches["dequantize"] += 1
    return out
