"""The mamba1 selective scan on Hopper, behind a PyTorch wrapper.

``mamba_scan`` replaces the Pallas TPU kernel of the same name
(``src/repro/kernels/mamba_scan.py:44``). The ssm family's prefill
(``models/ssm.py`` ``mamba1_seq``) calls it once per layer; the CUDA source
is ``csrc/mamba_scan.cu`` (a SIMT kernel, one lane per state; see its
header for the design). The inputs are read through their strides, so the
model hands in B and C as column slices of its projection, with no copy.

Dispatch follows the tensors' device: CPU tensors take the plain version
:func:`repro_torch.kernels.ref.mamba_scan_ref`; CUDA tensors launch the
kernel or raise (there is no fallback). Every launch adds one to
``launches["mamba_scan"]``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.storm_update import _on_cpu, _raise_on

launches = {"mamba_scan": 0}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 16          # one lane a state, at most 16 lanes a channel


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _library() -> ctypes.CDLL:
    lib = _build.load("mamba_scan")
    if lib.mamba_scan_fwd.argtypes is None:
        # without argtypes ctypes would pass each pointer as a 32-bit int
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.mamba_scan_fwd.argtypes = (
            [ptr, i32, i64, i64, i64] * 2 + [ptr, i32, i64, i64]
            + [ptr, i32, i64, i64, i64] * 2 + [ptr, ptr] + [i32] * 4 + [ptr])
        lib.mamba_scan_fwd.restype = ctypes.c_int
    return lib


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               Bm: torch.Tensor, Cm: torch.Tensor):
    """x, dt: [B,S,Di]; A: [Di,N]; Bm, Cm: [B,S,N]; each f32 or bf16, any
    strides. From a zero state, returns (y [B,S,Di] in x's dtype, h_last
    [B,Di,N] f32), both contiguous."""
    if _on_cpu(x, dt, A, Bm, Cm):
        return ref.mamba_scan_ref(x, dt, A, Bm, Cm)
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(f"x must be [B, S, Di] and A [Di, N], got "
                         f"{tuple(x.shape)} and {tuple(A.shape)}")
    b, s, di = x.shape
    n = A.shape[1]
    for name, t, shape in (("dt", dt, (b, s, di)), ("A", A, (di, n)),
                           ("Bm", Bm, (b, s, n)), ("Cm", Cm, (b, s, n))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if t.dtype not in DTYPES:
            raise TypeError(f"{name} must be one of "
                            f"{sorted(map(str, DTYPES))}, got {t.dtype}")
    if s < 1 or di < 1 or b < 1:
        raise ValueError(f"empty scan: B {b}, S {s}, Di {di}")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"the state dimension must be in [1, {MAX_STATE}] "
                         f"(mamba1's sizes: one lane a state, 16 lanes a "
                         f"channel), got {n}")
    y = torch.empty((b, s, di), dtype=x.dtype, device=x.device)
    h_last = torch.empty((b, di, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _library().mamba_scan_fwd(
        x.data_ptr(), DTYPES[x.dtype], *x.stride(),
        dt.data_ptr(), DTYPES[dt.dtype], *dt.stride(),
        A.data_ptr(), DTYPES[A.dtype], *A.stride(),
        Bm.data_ptr(), DTYPES[Bm.dtype], *Bm.stride(),
        Cm.data_ptr(), DTYPES[Cm.dtype], *Cm.stride(),
        y.data_ptr(), h_last.data_ptr(), b, s, di, n, stream)
    _raise_on(err, "mamba_scan")
    launches["mamba_scan"] += 1
    return y, h_last
