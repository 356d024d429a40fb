"""The fused update kernels of AdaFBiO on Hopper, behind PyTorch wrappers.

``storm_update`` (STORM refresh, Eqs. 10-11) and ``adafbio_update`` (the
Eq. 14 preconditioned step) replace the Pallas TPU kernels of the same names
(``src/repro/kernels/storm_update.py``). Both work on the packed ``[M, n]``
f32 client buffer of :func:`repro_torch.core.tree_util.tree_pack_stacked`
and launch once over all M client rows. The CUDA source is
``csrc/storm_update.cu``; it is bound by memory (16 bytes per element).

Dispatch follows the tensors' device: CPU tensors take the plain versions in
:mod:`repro_torch.kernels.ref`; CUDA tensors launch the kernel or raise
(there is no fallback). Every launch adds one to ``launches[name]``.
"""
from __future__ import annotations

import ctypes

import torch

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
