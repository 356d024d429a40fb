"""The fused update kernels of AdaFBiO on Hopper, behind PyTorch wrappers.

``storm_update`` (STORM refresh, Eqs. 10-11) and ``adafbio_update`` (the
Eq. 14 preconditioned step) replace the Pallas TPU kernels of the same names
(``src/repro/kernels/storm_update.py``). Each has two entries into one CUDA
source, ``csrc/storm_update.cu``, bound by memory:

  * the packed entries (:func:`storm_update`, :func:`adafbio_update`) work
    on an ``[M, n]`` f32 client buffer (16 bytes per element) and launch
    once over all M client rows;
  * the leaf-table entries (:func:`storm_update_leaves`,
    :func:`adafbio_update_leaves`) take a tree's leaves where they lie, f32
    and bf16 mixed, and launch once over all of them: the math in f32, each
    output rounded once into its leaf's dtype, bit for bit what the packed
    entry gives after packing and casting back. The tree wrappers of
    :mod:`repro_torch.kernels.ops` take this route.

Dispatch follows the tensors' device: CPU tensors take the plain versions in
:mod:`repro_torch.kernels.ref` (leaf by leaf for the leaf-table entries);
CUDA tensors launch the kernel or raise (there is no fallback). Every launch
adds one to ``launches[name]``, whichever entry launched it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from repro_torch import device as devices
from repro_torch.kernels import _build, ref

launches = {"storm_update": 0, "adafbio_update": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _library() -> ctypes.CDLL:
    lib = _build.load("storm_update")
    if lib.storm_update_f32.argtypes is None:
        # without argtypes ctypes would pass each pointer as a 32-bit int
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.storm_update_f32.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, ptr]
        lib.storm_update_f32.restype = ctypes.c_int
        lib.adafbio_update_f32.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,
                                           i64, i64, i64, ptr]
        lib.adafbio_update_f32.restype = ctypes.c_int
        lib.storm_update_leaves.argtypes = [ptr, ptr, i64, i64, ptr, ptr]
        lib.storm_update_leaves.restype = ctypes.c_int
        lib.adafbio_update_leaves.argtypes = [ptr, ptr, i64, i64, ptr, ptr,
                                              ptr]
        lib.adafbio_update_leaves.restype = ctypes.c_int
    return lib


def _on_cpu(*tensors) -> bool:
    """True when every tensor is on the CPU; raises on a device mix or on a
    device that is neither CPU nor CUDA."""
    devices = {t.device for t in tensors if isinstance(t, torch.Tensor)}
    if len(devices) != 1:
        raise ValueError(f"tensors must share one device, got {devices}")
    (device,) = devices
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    return False


def _check_buffer(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_scalar(name: str, t, device) -> None:
    if not isinstance(t, torch.Tensor) or t.numel() != 1:
        raise TypeError(f"{name} must be a one-element tensor on {device} "
                        f"(the kernel reads it from device memory)")
    if t.dtype != torch.float32 or t.device != device:
        raise TypeError(f"{name} must be float32 on {device}, got "
                        f"{t.dtype} on {t.device}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def storm_update(g_new: torch.Tensor, g_old: torch.Tensor, est: torch.Tensor,
                 beta) -> torch.Tensor:
    """est' = g_new + (1-beta)(est - g_old) over ``[M, n]`` f32 buffers.

    On CUDA ``beta`` is a one-element f32 tensor on the same device."""
    if _on_cpu(g_new, g_old, est, beta):
        return ref.storm_update_ref(g_new, g_old, est, beta)
    for name, t in (("g_new", g_new), ("g_old", g_old), ("est", est)):
        _check_buffer(name, t, est.shape)
    _check_scalar("beta", beta, est.device)
    out = torch.empty_like(est)
    stream = torch.cuda.current_stream(est.device).cuda_stream
    err = _library().storm_update_f32(
        g_new.data_ptr(), g_old.data_ptr(), est.data_ptr(), beta.data_ptr(),
        out.data_ptr(), est.numel(), stream)
    _raise_on(err, "storm_update")
    launches["storm_update"] += 1
    return out


def adafbio_update(p: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                   lr_eta, rho) -> torch.Tensor:
    """p' = p - lr_eta * w / (sqrt(a) + rho): ``p, w`` are ``[M, n]``, ``a``
    is one ``[n]`` row shared by every client row, or ``[M, n]``, one row
    per client row (the gossip engine's per-node accumulators). Either way
    one launch covers all M rows.

    On CUDA ``lr_eta`` and ``rho`` are one-element f32 tensors on the same
    device."""
    if _on_cpu(p, w, a, lr_eta, rho):
        return ref.adafbio_update_ref(p, w, a, lr_eta, rho)
    if p.dim() != 2:
        raise ValueError(f"p must be [M, n], got shape {tuple(p.shape)}")
    rows, n = p.shape
    _check_buffer("p", p, (rows, n))
    _check_buffer("w", w, (rows, n))
    per_row = a.dim() == 2
    _check_buffer("a", a, (rows, n) if per_row else (n,))
    _check_scalar("lr_eta", lr_eta, p.device)
    _check_scalar("rho", rho, p.device)
    out = torch.empty_like(p)
    stream = torch.cuda.current_stream(p.device).cuda_stream
    err = _library().adafbio_update_f32(
        p.data_ptr(), w.data_ptr(), a.data_ptr(), lr_eta.data_ptr(),
        rho.data_ptr(), out.data_ptr(), rows, n, n if per_row else 0,
        stream)
    _raise_on(err, "adafbio_update")
    launches["adafbio_update"] += 1
    return out


# ------------------------------------------------------------ leaf tables

UNIT = 8                   # elements of a work unit (csrc: kUnit)
PER_ROW_A = 16             # info flag: adafbio's `a` has a row per row
LEAF_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=64)
def _info_table(layout: Tuple[Tuple[int, int, int], ...],
                device: torch.device) -> Tuple[torch.Tensor, int]:
    """The ``[L, 4]`` int64 info table of a leaf layout (``(n, rows,
    flags)`` per leaf: elements a row, rows, dtype flags) on ``device``,
    with each leaf's first work unit, and the units in all. Built and
    copied once per (layout, device) and reused by every call."""
    table, start = [], 0
    for n, rows, flags in layout:
        table.append((n, rows, start, flags))
        start += -(-n * rows // UNIT)
    return devices.to_device(torch.tensor(table, dtype=torch.int64),
                             device), start


def _dtype_flags(*tensors) -> int:
    """Bit k set where operand k (in0, in1, in2, out) is bf16."""
    return sum(1 << k for k, t in enumerate(tensors)
               if t.dtype == torch.bfloat16)


def _check_leaf(name: str, i: int, t: torch.Tensor, shape, device) -> None:
    if t.dtype not in LEAF_DTYPES:
        raise TypeError(f"{name} leaf {i} must be float32 or bfloat16, "
                        f"got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} leaf {i} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} leaf {i} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} leaf {i} is on {t.device}, not {device}")


def _launch_leaves(entry: str, layout, ins: Sequence[Sequence[torch.Tensor]],
                   outs: List[torch.Tensor], scalars) -> None:
    """One launch of a leaf-table entry over ``layout`` (``(n, rows,
    flags)`` a leaf): the per-call pointer table and the cached info table
    go to the card without waiting for it."""
    device = outs[0].device
    leaves = list(zip(*ins, outs))
    info, total = _info_table(tuple(
        (n, rows, f | _dtype_flags(*leaf))
        for (n, rows, f), leaf in zip(layout, leaves)), device)
    ptrs = devices.to_device(torch.tensor(
        [[t.data_ptr() for t in leaf] for leaf in leaves],
        dtype=torch.int64), device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(_library(), entry)(
        ptrs.data_ptr(), info.data_ptr(), len(outs), total,
        *(s.data_ptr() for s in scalars), stream)
    _raise_on(err, entry)


def storm_update_leaves(g_new: Sequence[torch.Tensor],
                        g_old: Sequence[torch.Tensor],
                        est: Sequence[torch.Tensor], beta) -> List[torch.Tensor]:
    """est' = g_new + (1-beta)(est - g_old), leaf by leaf over matching
    lists of leaves (f32 or bf16, each operand its own), computed in f32;
    each output leaf takes ``est``'s dtype. On CUDA one launch covers every
    leaf, and ``beta`` is a one-element f32 tensor on the same device."""
    if _on_cpu(*g_new, *g_old, *est, beta):
        return [ref.storm_update_ref(a, b, c, beta)
                for a, b, c in zip(g_new, g_old, est)]
    if not len(g_new) == len(g_old) == len(est):
        raise ValueError("g_new, g_old and est must have the same leaves")
    device = est[0].device
    for i, e in enumerate(est):
        for name, t in (("g_new", g_new[i]), ("g_old", g_old[i]),
                        ("est", e)):
            _check_leaf(name, i, t, e.shape, device)
    _check_scalar("beta", beta, device)
    out = [torch.empty_like(e) for e in est]
    _launch_leaves("storm_update_leaves", [(e.numel(), 1, 0) for e in est],
                   (g_new, g_old, est), out, (beta,))
    launches["storm_update"] += 1
    return out


def adafbio_update_leaves(p: Sequence[torch.Tensor],
                          w: Sequence[torch.Tensor],
                          a: Sequence[torch.Tensor], lr_eta,
                          rho) -> List[torch.Tensor]:
    """p' = p - lr_eta * w / (sqrt(a) + rho), leaf by leaf, computed in f32;
    each output leaf takes ``p``'s dtype. A leaf of ``a`` either has its
    ``p`` leaf's shape (one value per element: one client's tree, or one
    row per client row) or that shape without the leading client axis (one
    row shared by every client row). On CUDA one launch covers every leaf,
    and ``lr_eta`` and ``rho`` are one-element f32 tensors on the same
    device."""
    if _on_cpu(*p, *w, *a, lr_eta, rho):
        return [ref.adafbio_update_ref(pi, wi, ai, lr_eta, rho)
                for pi, wi, ai in zip(p, w, a)]
    if not len(p) == len(w) == len(a):
        raise ValueError("p, w and a must have the same leaves")
    device = p[0].device
    layout = []
    for i, (pi, wi, ai) in enumerate(zip(p, w, a)):
        _check_leaf("p", i, pi, pi.shape, device)
        _check_leaf("w", i, wi, pi.shape, device)
        if ai.shape == pi.shape:
            _check_leaf("a", i, ai, pi.shape, device)
            layout.append((pi.numel(), 1, PER_ROW_A))
        else:
            _check_leaf("a", i, ai, pi.shape[1:], device)
            layout.append((ai.numel(), pi.shape[0], 0))
    _check_scalar("lr_eta", lr_eta, device)
    _check_scalar("rho", rho, device)
    out = [torch.empty_like(pi) for pi in p]
    _launch_leaves("adafbio_update_leaves", layout, (p, w, a), out,
                   (lr_eta, rho))
    launches["adafbio_update"] += 1
    return out
