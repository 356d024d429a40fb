"""Tree arithmetic over nested dicts (and lists/tuples) of tensors.

A bare tensor is a tree of one leaf. Dict keys are visited in sorted order,
as JAX flattens dicts, so flat buffers lay leaves out the same way in both
packages. There is no ``tree_barrier``: eager PyTorch already runs in order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Tuple

import torch


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over matching leaves of ``tree`` and ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for t in tree for l in tree_leaves(t)]
    return [tree]


def tree_structure(tree):
    """The tree with every leaf replaced by None (the port's treedef)."""
    return tree_map(lambda _: None, tree)


def tree_unflatten(structure, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), structure)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


def tree_axpy(s, a, b):
    """s*a + b"""
    return tree_map(lambda x, y: s * x + y, a, b)


def tree_update(params, direction, step):
    """params - step * direction, computed in f32, cast back to each param's
    dtype (an f32 step size never promotes bf16 params)."""
    return tree_map(
        lambda p, d: (p.float() - step * d.float()).to(p.dtype),
        params, direction)


def tree_match_dtypes(a, like):
    return tree_map(lambda x, r: x.to(r.dtype), a, like)


def tree_vdot(a, b):
    total = None
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        d = torch.dot(x.reshape(-1).float(), y.reshape(-1).float())
        total = d if total is None else total + d
    return total


def tree_sqnorm(a):
    """``tree_vdot(a, a)`` from one f32 copy of each leaf: the same value
    and derivatives, bit for bit, but autodiff keeps one f32 copy where the
    dot of two copies keeps both (at LM width each is the head's size in
    f32, several of them live in a Neumann product)."""
    total = None
    for x in tree_leaves(a):
        xf = x.reshape(-1).float()
        d = torch.dot(xf, xf)
        total = d if total is None else total + d
    return total


def tree_norm(a):
    return torch.sqrt(tree_sqnorm(a))


def tree_row_norm(a):
    """[M] norms of the rows of a tree stacked on a leading axis: row m's
    :func:`tree_norm`, every leaf's squares summed in f32."""
    total = None
    for x in tree_leaves(a):
        sq = (x.float() ** 2).reshape(x.shape[0], -1).sum(dim=1)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_mean_axis0(a):
    """Mean over a leading (client) axis on every leaf. The mean of one row
    is that row, a view (no copy of a model-sized leaf)."""
    return tree_map(lambda x: x[0] if x.shape[0] == 1 else x.mean(dim=0), a)


def tree_bcast_axis0(a, m: int):
    """Every leaf repeated along a new leading axis of size m (a copy per
    row: client states are written per client)."""
    return tree_map(
        lambda x: x.unsqueeze(0).expand((m,) + tuple(x.shape)).contiguous(), a)


def take(d):
    """A shallow copy of the dict ``d``, which is emptied: a donated
    argument, whose buffers the callee frees as it replaces them (None
    passes through)."""
    if d is None:
        return None
    out = dict(d)
    d.clear()
    return out


def tree_stack(trees):
    """Stack a list of identically-structured trees along a new axis 0."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def tree_index(tree, i):
    """Row ``i`` of every leaf (the inverse of :func:`tree_stack`)."""
    return tree_map(lambda x: x[i], tree)


# ------------------------------------------------------------ flat buffers

@dataclasses.dataclass(frozen=True)
class TreeBufferSpec:
    """Static recipe for round-tripping a tree through one flat buffer."""
    treedef: Any
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    size: int                  # valid (unpadded) element count
    padded_size: int

    def with_dtype(self, dtype: torch.dtype) -> "TreeBufferSpec":
        """The same layout, every leaf unpacked as ``dtype``."""
        return dataclasses.replace(self, dtypes=(dtype,) * len(self.dtypes))


def tree_buffer_spec(tree, *, align: int = 128,
                     stacked: bool = False) -> TreeBufferSpec:
    """The spec of one flat row, padded to ``align``. With ``stacked`` the
    leaves carry a leading client axis, which the spec leaves out: it
    describes one client's row, unpadded (the kernels mask ragged rows)."""
    leaves = tree_leaves(tree)
    cut = 1 if stacked else 0
    shapes = tuple(tuple(l.shape)[cut:] for l in leaves)
    dtypes = tuple(l.dtype for l in leaves)
    size = sum(math.prod(s) for s in shapes)
    if stacked:
        padded = size
    else:
        padded = size + (-size) % align if size else align
    return TreeBufferSpec(tree_structure(tree), shapes, dtypes, size, padded)


def tree_pack(tree, spec: TreeBufferSpec = None, *, align: int = 128):
    """Flatten a tree into ONE 1-D f32 buffer (zero-padded to ``align``).

    Returns ``(flat, spec)``; feed ``spec`` to :func:`tree_unpack` to invert.
    Leaves are cast to f32 (the fused kernels do their math in f32) and
    unpack casts back per leaf.
    """
    if spec is None:
        spec = tree_buffer_spec(tree, align=align)
    leaves = tree_leaves(tree)
    parts = [l.reshape(-1).float() for l in leaves]
    pad = spec.padded_size - spec.size
    if pad or not parts:
        device = leaves[0].device if leaves else None
        parts.append(torch.zeros((pad,), device=device))
    return torch.cat(parts), spec


def tree_unpack(flat, spec: TreeBufferSpec):
    """Invert :func:`tree_pack`: split, reshape and cast back per leaf."""
    leaves = []
    off = 0
    for shape, dt in zip(spec.shapes, spec.dtypes):
        n = math.prod(shape)
        leaves.append(flat[off:off + n].reshape(shape).to(dt))
        off += n
    return tree_unflatten(spec.treedef, leaves)


def tree_pack_stacked(tree, spec: TreeBufferSpec = None):
    """Pack a tree stacked on a leading client axis into ``[M, n]`` f32,
    with no padding: row m is client m's leaves, flattened and concatenated
    as :func:`tree_pack` lays out one tree. ``spec`` describes one row."""
    if spec is None:
        spec = tree_buffer_spec(tree, stacked=True)
    leaves = tree_leaves(tree)
    m = leaves[0].shape[0]
    return torch.cat([l.reshape(m, -1).float() for l in leaves], dim=1), spec


def tree_unpack_stacked(flat, spec: TreeBufferSpec):
    """Invert :func:`tree_pack_stacked`. Leaves are views into ``flat``
    where the dtype already matches."""
    m = flat.shape[0]
    leaves = []
    off = 0
    for shape, dt in zip(spec.shapes, spec.dtypes):
        n = math.prod(shape)
        leaves.append(flat[:, off:off + n].reshape((m,) + shape).to(dt))
        off += n
    return tree_unflatten(spec.treedef, leaves)
