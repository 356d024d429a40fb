"""Tree-level wrappers around the fused update kernels.

The flat-buffer path: pack a client-stacked tree into one ``[M, n]`` f32
buffer (:func:`repro_torch.core.tree_util.tree_pack_stacked`), run the fused
kernel once over all M client rows, and unpack, casting back to each leaf's
dtype. Where the kernel runs follows the tensors' device
(:mod:`repro_torch.kernels.storm_update`, :mod:`repro_torch.kernels.quantize`).

The int8 codec's round trip runs the same way: one quantize and one
dequantize launch over every client row and every leaf of the packed
message, with one scale per (client, leaf).
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch

from repro_torch import device as devices
from repro_torch.core.tree_util import (TreeBufferSpec, tree_leaves, tree_map,
                                        tree_pack_stacked, tree_unpack_stacked)
from repro_torch.kernels.quantize import dequantize, quantize_stoch
from repro_torch.kernels.storm_update import adafbio_update, storm_update


def _device_scalar(s, device) -> torch.Tensor:
    """``s`` as a one-element f32 tensor on ``device`` (a fill on the
    device, never a copy from the host that would wait for the card)."""
    if isinstance(s, torch.Tensor):
        return s.reshape(()).to(device=device, dtype=torch.float32)
    return torch.full((), float(s), dtype=torch.float32, device=device)


def storm_update_tree(g_new, g_old, est, beta):
    """STORM refresh (Eqs. 10-11) over trees stacked on a leading client
    axis. Output leaves take ``est``'s dtypes (the estimator refreshed)."""
    fl_est, spec = tree_pack_stacked(est)
    fl_new, _ = tree_pack_stacked(g_new, spec)
    fl_old, _ = tree_pack_stacked(g_old, spec)
    beta = _device_scalar(beta, fl_est.device)
    return tree_unpack_stacked(storm_update(fl_new, fl_old, fl_est, beta),
                               spec)


def adafbio_update_tree(p, w, a, lr_eta, rho, *, per_row: bool = False):
    """Adaptive update (Eq. 14). ``p`` and ``w`` are stacked on a leading
    client axis, or are one client's tree, which runs as M = 1. ``a`` is
    one client's tree (the server's accumulator, shared by every row), or
    with ``per_row`` stacked like ``p`` (one accumulator per row: the gossip
    engine's nodes)."""
    one_row = lambda t: tree_map(lambda x: x.unsqueeze(0), t)
    single = not per_row and tree_leaves(p)[0].dim() == tree_leaves(a)[0].dim()
    if single:
        p, w = one_row(p), one_row(w)
    fl_p, spec = tree_pack_stacked(p)
    fl_w, _ = tree_pack_stacked(w, spec)
    fl_a = (tree_pack_stacked(a, spec)[0] if per_row
            else tree_pack_stacked(one_row(a))[0][0])
    device = fl_p.device
    out = adafbio_update(fl_p, fl_w, fl_a, _device_scalar(lr_eta, device),
                         _device_scalar(rho, device))
    out = tree_unpack_stacked(out, spec)
    return tree_map(lambda x: x[0], out) if single else out


# ------------------------------------------------------------ int8 codec

def segment_offsets(spec: TreeBufferSpec) -> Tuple[int, ...]:
    """Where each leaf starts in a packed row, then the row length: the
    ``offsets`` of the quantize kernels."""
    offsets = [0]
    for shape in spec.shapes:
        offsets.append(offsets[-1] + math.prod(shape))
    return tuple(offsets)


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


def int8_roundtrip_stacked(flat: torch.Tensor, u: torch.Tensor, offsets,
                           qmax: int) -> torch.Tensor:
    """decode(encode(flat)) of the int8 codec over a packed ``[M, n]`` f32
    buffer whose leaves start at ``offsets`` (a tuple, as
    :func:`segment_offsets` gives it): the per-(row, leaf) scales, then one
    quantize and one dequantize launch over all rows and leaves. ``u`` is
    the ``[M, n]`` uniform[0, 1) rounding noise."""
    table = _offset_table(tuple(offsets), flat.device)
    scale = leaf_scales(flat, offsets, qmax)
    q = quantize_stoch(flat, u, scale, table, qmax)
    return dequantize(q, scale, table)
