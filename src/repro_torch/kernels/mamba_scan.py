"""The mamba1 selective scan on Hopper, behind a PyTorch wrapper.

``mamba_scan`` replaces the Pallas TPU kernel of the same name
(``src/repro/kernels/mamba_scan.py:44``). The ssm family's prefill
(``models/ssm.py`` ``mamba1_seq``) calls it once per layer; the CUDA source
is ``csrc/mamba_scan.cu`` (4 states of a channel a thread, the next
tile's inputs staged with cp.async while the current one is scanned; see
its header for the design). The inputs are read through their strides, so
the model hands in B and C as column slices of its projection, with no
copy.

Dispatch follows the tensors' device: CPU tensors take the plain version
:func:`repro_torch.kernels.ref.mamba_scan_ref`; CUDA tensors launch the
kernel or raise (there is no fallback). Every launch adds one to
``launches["mamba_scan"]``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import aligned16
from repro_torch.kernels.storm_update import _on_cpu, _raise_on

launches = {"mamba_scan": 0}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 16          # the states a channel carries (N padded)
# The kernel's tiles (csrc/mamba_scan.cu): STEPS steps a tile, CHANNELS
# channels a block.
STEPS, CHANNELS = 64, 16


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def smem_bytes(dtype: torch.dtype) -> int:
    """Shared memory of one block: two buffers of x and dt [STEPS,
    CHANNELS] and B and C [STEPS, MAX_STATE] in the inputs' dtype, and y
    [STEPS, CHANNELS] in f32. The kernel refuses a launch whose plan
    differs from its own."""
    return (2 * 2 * STEPS * (CHANNELS + MAX_STATE) * dtype.itemsize
            + 4 * STEPS * CHANNELS)


def copies16(t: torch.Tensor) -> bool:
    """True when the kernel may stage ``t`` ([B, S, cols]) in 16-byte
    chunks: a contiguous last dimension whose rows fill whole chunks, a
    16-byte-aligned start and (b, s) strides (a dimension of size 1 is
    never stepped)."""
    steps = tuple(d for d in (0, 1) if t.shape[d] > 1)
    return (t.stride(-1) == 1 and t.shape[-1] * t.element_size() % 16 == 0
            and aligned16(t, steps))


def _library() -> ctypes.CDLL:
    lib = _build.load("mamba_scan")
    if lib.mamba_scan_fwd.argtypes is None:
        # without argtypes ctypes would pass each pointer as a 32-bit int
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.mamba_scan_fwd.argtypes = (
            [ptr, i32, i64, i64, i64] * 2 + [ptr, i32, i64, i64]
            + [ptr, i32, i64, i64, i64] * 2 + [ptr, i32, ptr] + [i32] * 7
            + [ptr])
        lib.mamba_scan_fwd.restype = ctypes.c_int
    return lib


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               Bm: torch.Tensor, Cm: torch.Tensor):
    """x, dt: [B,S,Di]; A: [Di,N]; Bm, Cm: [B,S,N]; each f32 or bf16, any
    strides. From a zero state, returns (y [B,S,Di] in x's dtype, h_last
    [B,Di,N] f32), both contiguous. On the card x, dt, Bm and Cm go to the
    kernel in one dtype: a mix is widened to f32, which is exact."""
    if _on_cpu(x, dt, A, Bm, Cm):
        return ref.mamba_scan_ref(x, dt, A, Bm, Cm)
    return _launch(x, dt, A, Bm, Cm)


def _launch(x, dt, A, Bm, Cm):
    """Checks the inputs, then launches the kernel once on the current
    stream of x's device."""
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
                         f"(mamba1's sizes: 16 states a channel at most), "
                         f"got {n}")
    y = torch.empty((b, s, di), dtype=x.dtype, device=x.device)
    h_last = torch.empty((b, di, n), dtype=torch.float32, device=x.device)
    # the kernel takes x, dt, B and C in one dtype: a mix goes as f32
    if len({x.dtype, dt.dtype, Bm.dtype, Cm.dtype}) > 1:
        x, dt, Bm, Cm = x.float(), dt.float(), Bm.float(), Cm.float()
    err = _library().mamba_scan_fwd(
        x.data_ptr(), DTYPES[x.dtype], *x.stride(),
        dt.data_ptr(), DTYPES[dt.dtype], *dt.stride(),
        A.data_ptr(), DTYPES[A.dtype], *A.stride(),
        Bm.data_ptr(), DTYPES[Bm.dtype], *Bm.stride(),
        Cm.data_ptr(), DTYPES[Cm.dtype], *Cm.stride(),
        y.data_ptr(), int(y.dtype == torch.bfloat16), h_last.data_ptr(), b,
        s, di, n, int(copies16(x) and copies16(dt)),
        int(copies16(Bm) and copies16(Cm)), smem_bytes(x.dtype),
        _stream(y.device))
    _raise_on(err, "mamba_scan")
    launches["mamba_scan"] += 1
    return y, h_last
