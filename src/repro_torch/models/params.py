"""Parameter specs: shapes, logical axes and initializers as plain nested
dicts, and the tensors they describe.

Models declare a tree of ``ParamSpec``; :func:`init_params` materializes it
with an explicit ``torch.Generator`` on the target device. The draws cannot
equal ``jax.random``'s, so parity tests carry the reference's weights
across (:func:`repro_torch.interop.serve_params_from_reference`). Logical
axes are kept for the sharded slices to come; nothing reads them yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.tree_util import tree_leaves, tree_map

# the Cephes polynomial of XLA's f32 log on the CPU
_LOG_P = np.array([7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
                   -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
                   2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1],
                  np.float32)


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]     # logical axis name per dim
    init: str = "normal"          # normal | zeros | ones | ssm_a | ssm_dt
    scale: float = 0.02
    dtype: Optional[str] = None         # override the model dtype (f32 norms)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a tensor not yet allocated (the port's stand-in
    for ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"``/``"float32"``/... (or a torch dtype) as a torch
    dtype."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def log_f32(v: np.ndarray) -> np.ndarray:
    """f32 natural log in the order of operations of the JAX package's
    ``jnp.log`` on the CPU (Cephes ``logf``: split off the exponent, a
    degree-8 polynomial around 1), so that ``ssm_a`` equals the reference's
    init bit for bit: a correctly rounded log differs from it by one ulp at
    some integers (7, for one)."""
    f = np.float32
    m, e = np.frexp(np.asarray(v, f))          # v = m 2^e, m in [.5, 1)
    x, e = m.astype(f), e.astype(f)
    low = x < f(0.707106781186547524)
    e = e - np.where(low, f(1), f(0))
    x = (x - f(1)) + np.where(low, x, f(0))
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y = (x * p[0] + p[1]) * x + p[2]
    y1 = (x * p[3] + p[4]) * x + p[5]
    y2 = (x * p[6] + p[7]) * x + p[8]
    y = ((y * x3 + y1) * x3 + y2) * x3
    y = y + e * f(-2.12194440e-4)
    x = (x - x2 * f(0.5)) + y
    return x + e * f(0.693359375)


def _materialize(spec: ParamSpec, gen: torch.Generator, default_dtype,
                 device) -> torch.Tensor:
    dtype = torch_dtype(spec.dtype or default_dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init == "ssm_a":
        # mamba A_log init: log(1..N) broadcast over the leading dims
        n = spec.shape[-1]
        a = torch.from_numpy(log_f32(np.arange(1, n + 1)))
        return a.to(device).expand(spec.shape).to(dtype).contiguous()
    if spec.init == "ssm_dt":
        # softplus^-1 of a log-uniform dt in [1e-3, 1e-1]
        lo, hi = 1e-3, 1e-1
        u = torch.rand(spec.shape, generator=gen, device=device,
                       dtype=torch.float32)
        dt = torch.exp(u * (math.log(hi) - math.log(lo)) + math.log(lo))
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    if spec.init != "normal":
        raise ValueError(f"unknown init {spec.init!r}")
    # f32 normal draws times the scale, cast to the leaf's dtype, as the
    # reference; a stacked leaf is drawn one layer at a time, so the f32
    # temporary stays one layer's size at full width
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    for r in (out if out.dim() > 2 else [out]):
        r.copy_(torch.randn(r.shape, generator=gen, device=device,
                            dtype=torch.float32) * spec.scale)
    return out


def init_params(specs, gen: torch.Generator, default_dtype="bfloat16",
                device=None):
    """The tensors of ``specs`` on ``device`` (default: the generator's),
    the normal and ssm_dt leaves drawn from ``gen`` in the tree's leaf
    order."""
    device = torch.device(device if device is not None else gen.device)
    return tree_map(lambda s: _materialize(s, gen, default_dtype, device),
                    specs)


def param_count(specs) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(specs))
