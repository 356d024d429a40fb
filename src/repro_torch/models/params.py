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

import torch

from repro_torch.core.tree_util import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]     # logical axis name per dim
    init: str = "normal"                # normal | zeros | ones
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


def _materialize(spec: ParamSpec, gen: torch.Generator, default_dtype,
                 device) -> torch.Tensor:
    dtype = torch_dtype(spec.dtype or default_dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init != "normal":
        raise NotImplementedError(f"init {spec.init!r} comes with the SSM "
                                  f"slice")
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
    normal leaves drawn from ``gen`` in the tree's leaf order."""
    device = torch.device(device if device is not None else gen.device)
    return tree_map(lambda s: _materialize(s, gen, default_dtype, device),
                    specs)


def param_count(specs) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(specs))
