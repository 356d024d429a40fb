"""Tree-level wrappers around the fused update kernels.

The update kernels run over a tree's leaves where they lie: one launch of
the leaf-table entry (:func:`repro_torch.kernels.storm_update.
storm_update_leaves`, :func:`~repro_torch.kernels.storm_update.
adafbio_update_leaves`) covers every leaf and every client row, f32 and
bf16 leaves mixed, with no packed f32 copy of the tree (at language-model
width one such copy of the backbone is 14 GB). The values are those of
packing into one ``[M, n]`` f32 buffer, the packed kernel and casting back
to each leaf's dtype. Where the kernel runs follows the tensors' device
(:mod:`repro_torch.kernels.storm_update`, :mod:`repro_torch.kernels.quantize`).

The int8 codec's round trip works on one leaf of the message at a time
(f32, one row a client): one quantize and one dequantize launch over the
client rows, with one scale per row (:mod:`repro_torch.fed.compress` goes
leaf by leaf).
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch

from repro_torch import device as devices
from repro_torch.core.tree_util import (tree_leaves, tree_structure,
                                        tree_unflatten)
from repro_torch.kernels.quantize import dequantize, quantize_stoch
from repro_torch.kernels.storm_update import (adafbio_update_leaves,
                                              storm_update_leaves)


def _device_scalar(s, device) -> torch.Tensor:
    """``s`` as a one-element f32 tensor on ``device`` (a fill on the
    device, never a copy from the host that would wait for the card)."""
    if isinstance(s, torch.Tensor):
        return s.reshape(()).to(device=device, dtype=torch.float32)
    return torch.full((), float(s), dtype=torch.float32, device=device)


def _dense_leaves(tree):
    """The leaves, each contiguous (the kernels read a leaf as one run of
    elements; a strided view, such as a vmapped output, is copied)."""
    return [t.contiguous() for t in tree_leaves(tree)]


def storm_update_tree(g_new, g_old, est, beta):
    """STORM refresh (Eqs. 10-11) over trees stacked on a leading client
    axis (or one client's trees). Output leaves take ``est``'s dtypes (the
    estimator refreshed)."""
    est_l = _dense_leaves(est)
    out = storm_update_leaves(_dense_leaves(g_new), _dense_leaves(g_old),
                              est_l, _device_scalar(beta, est_l[0].device))
    return tree_unflatten(tree_structure(est), out)


def adafbio_update_tree(p, w, a, lr_eta, rho):
    """Adaptive update (Eq. 14). ``p`` and ``w`` are stacked on a leading
    client axis, or are one client's tree. ``a`` is one client's tree (the
    server's accumulator, shared by every row), or stacked like ``p`` (one
    accumulator per row: the gossip engine's nodes); each leaf's shape says
    which. Output leaves take ``p``'s dtypes."""
    p_l, w_l, a_l = _dense_leaves(p), _dense_leaves(w), _dense_leaves(a)
    device = p_l[0].device
    out = adafbio_update_leaves(p_l, w_l, a_l,
                                _device_scalar(lr_eta, device),
                                _device_scalar(rho, device))
    return tree_unflatten(tree_structure(p), out)


# ------------------------------------------------------------ int8 codec

@functools.lru_cache(maxsize=64)
def _offset_table(offsets: Tuple[int, ...],
                  device: torch.device) -> torch.Tensor:
    """``offsets`` as the kernels' ``[L+1]`` int64 table on ``device``,
    copied there once per (layout, device) and reused by every sync."""
    return devices.to_device(torch.tensor(offsets, dtype=torch.int64), device)


def leaf_scales(flat: torch.Tensor, offsets, qmax: int) -> torch.Tensor:
    """The int8 codec's scales of a packed ``[M, n]`` buffer, ``[M, L]``
    f32: ``max(max|x|, 1e-30) / qmax`` per (row, leaf). The max-abs is one
    reduction per leaf that reads the leaf in place (no ``|x|`` copy). The
    floor only guards an all-zero leaf (its levels are then 0 exactly)."""
    amax = torch.stack([torch.linalg.vector_norm(flat[:, a:b], ord=math.inf,
                                                 dim=1)
                        for a, b in zip(offsets, offsets[1:])], dim=1)
    return amax.clamp_min(1e-30) / qmax


def int8_roundtrip(flat: torch.Tensor, u: torch.Tensor,
                   qmax: int) -> torch.Tensor:
    """decode(encode(flat)) of the int8 codec over one leaf's ``[M, n]`` f32
    rows: the per-row scales, then one quantize and one dequantize launch
    over all rows (a one-segment table). ``u`` is the ``[M, n]``
    uniform[0, 1) rounding noise."""
    offsets = (0, flat.shape[1])
    table = _offset_table(offsets, flat.device)
    scale = leaf_scales(flat, offsets, qmax)
    q = quantize_stoch(flat, u, scale, table, qmax)
    return dequantize(q, scale, table)
