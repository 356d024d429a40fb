"""Tree checkpoints in the JAX package's files (``src/repro/checkpoint/
ckpt.py``): ``<path>.npz`` with one array a leaf (``leaf_{i}`` in the
leaves' order: dict keys sorted, as JAX flattens), a ``<path>.json``
sidecar (step, the tree's structure, each array's dtype and shape) and,
with ``shards=K``, ``<path>.shard{k}.npz`` files that split each leaf whose
leading axis holds at least K rows row-contiguously (``np.array_split``
bounds); smaller leaves stay in the base file. Sharded and dense files load
the same way, so runs resume from each other's files, and either package
reads what the other wrote:

  * bf16 leaves are stored as f32 (lossless widening; loading casts back);
  * the structure is written as JAX writes ``str(PyTreeDef)`` of the tree
    (:func:`treedef_str`): a tuple of nested dicts reads
    ``PyTreeDef(({'v': {...}, ...}, {...}))``.

:class:`LazyRows` lets a caller hand :func:`save_checkpoint` a leaf that
fetches row ranges on demand, one shard at a time. Every check of
:func:`load_checkpoint` raises ``ValueError`` naming the leaf's path (in
JAX's ``keystr`` form, ``[0]['x']['embed']``).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch.models.params import TensorSpec, torch_dtype


class LazyRows:
    """A checkpoint leaf that yields row ranges on demand: ``fetch(lo, hi)``
    returns the rows ``[lo:hi]`` (numpy or a tensor); ``shape`` and
    ``dtype`` describe the whole leaf. :func:`save_checkpoint` pulls one
    shard's range at a time."""

    def __init__(self, fetch: Callable[[int, int], Any],
                 shape: Tuple[int, ...], dtype) -> None:
        self.fetch = fetch
        self.shape = tuple(shape)
        self.dtype = dtype


def _is_leaf(x) -> bool:
    return not isinstance(x, (dict, list, tuple)) and x is not None


def _flatten(tree, path: str = ""):
    """``[(keystr, leaf)]`` in JAX's leaf order, and the structure string
    (the inside of JAX's ``PyTreeDef(...)``)."""
    if isinstance(tree, dict):
        out, parts = [], []
        for k in sorted(tree):
            sub, s = _flatten(tree[k], f"{path}[{k!r}]")
            out += sub
            parts.append(f"{k!r}: {s}")
        return out, "{" + ", ".join(parts) + "}"
    if isinstance(tree, (list, tuple)):
        out, parts = [], []
        for i, t in enumerate(tree):
            sub, s = _flatten(t, f"{path}[{i}]")
            out += sub
            parts.append(s)
        if isinstance(tree, list):
            return out, "[" + ", ".join(parts) + "]"
        if len(parts) == 1:
            return out, "(" + parts[0] + ",)"
        return out, "(" + ", ".join(parts) + ")"
    if tree is None:
        return [], "None"
    return [(path, tree)], "*"


def treedef_str(tree) -> str:
    """JAX's ``str(jax.tree.structure(tree))`` of a tree of dicts, lists,
    tuples and None, with tensors (or anything else) as leaves."""
    return f"PyTreeDef({_flatten(tree)[1]})"


def _to_np(x) -> np.ndarray:
    """A leaf as host numpy: bf16 widens to f32 (lossless)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _leaf_shape(x) -> Tuple[int, ...]:
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


def _dense(x) -> np.ndarray:
    if isinstance(x, LazyRows):
        return _to_np(x.fetch(0, x.shape[0]))
    return _to_np(x)


def _rows(x, lo: int, hi: int) -> np.ndarray:
    if isinstance(x, LazyRows):
        return _to_np(x.fetch(lo, hi))
    return _to_np(x[lo:hi])


def shard_bounds(n: int, shards: int) -> List[Tuple[int, int]]:
    """Row-contiguous (lo, hi) ranges matching ``np.array_split(arange(n),
    shards)``: the first ``n % shards`` shards get one extra row."""
    sizes = [n // shards + (1 if i < n % shards else 0)
             for i in range(shards)]
    off = [0]
    for s in sizes:
        off.append(off[-1] + s)
    return [(off[i], off[i + 1]) for i in range(shards)]


def save_checkpoint(path, tree, step: int = 0, shards: int = 1) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat, structure = _flatten(tree)
    leaves = [leaf for _, leaf in flat]
    treedef = f"PyTreeDef({structure})"
    names = [f"leaf_{i}" for i in range(len(leaves))]
    if shards <= 1:
        arrays = {nm: _dense(x) for nm, x in zip(names, leaves)}
        np.savez(str(path) + ".npz", **arrays)
        meta = {"step": step, "treedef": treedef,
                "n_leaves": len(arrays),
                "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
                "shapes": {k: list(v.shape) for k, v in arrays.items()}}
        Path(str(path) + ".json").write_text(json.dumps(meta))
        return
    # a leaf shards when its leading axis can feed every shard at least one
    # row; everything else (scalars, short vectors, server leaves) stays
    # dense in the base file
    shapes = [_leaf_shape(x) for x in leaves]
    sharded = [i for i, s in enumerate(shapes)
               if len(s) >= 1 and s[0] >= shards]
    sharded_set = set(sharded)
    base = {names[i]: _dense(x) for i, x in enumerate(leaves)
            if i not in sharded_set}
    np.savez(str(path) + ".npz", **base)
    dtypes: Dict[str, str] = {k: str(v.dtype) for k, v in base.items()}
    for k in range(shards):
        arrays = {}
        for i in sharded:
            lo, hi = shard_bounds(shapes[i][0], shards)[k]
            arrays[names[i]] = _rows(leaves[i], lo, hi)
            dtypes[names[i]] = str(arrays[names[i]].dtype)
        np.savez(f"{path}.shard{k}.npz", **arrays)
    meta = {"step": step, "treedef": treedef, "n_leaves": len(leaves),
            "dtypes": dtypes,
            "shapes": {names[i]: list(shapes[i])
                       for i in range(len(leaves))},
            "shards": shards, "sharded_leaves": sharded}
    Path(str(path) + ".json").write_text(json.dumps(meta))


def _rebuild(like, leaves):
    it = iter(leaves)

    def go(t):
        if isinstance(t, dict):
            return {k: go(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(go(u) for u in t)
        if t is None:
            return None
        return next(it)
    return go(like)


def load_checkpoint(path, like_tree, device="cuda") -> Tuple[Any, int]:
    """Restore into the structure of ``like_tree`` (tensors, or
    :class:`~repro_torch.models.params.TensorSpec` leaves); returns
    ``(tree, step)``. Each leaf comes back in its template's dtype, on the
    template tensor's device, or on ``device`` for a ``TensorSpec`` (default
    the card: a CUDA device without a card raises; pass ``device="cpu"``).

    Checks the leaf count, every stored shape against the template, and the
    stored arrays against the sidecar's own dtypes and shapes (a mismatch
    means a corrupt or mixed-up .npz/.json pair); each raises
    ``ValueError`` naming the leaf's path. Dense and sharded files load the
    same way.
    """
    flat, _ = _flatten(like_tree)
    if any(isinstance(ref, TensorSpec) for _, ref in flat):
        device = devices.resolve(device)
    meta = json.loads(Path(str(path) + ".json").read_text())
    data = dict(np.load(str(path) + ".npz"))
    shards = int(meta.get("shards", 1))
    if shards > 1:
        pieces = [np.load(f"{path}.shard{k}.npz") for k in range(shards)]
        for i in meta.get("sharded_leaves", []):
            name = f"leaf_{i}"
            data[name] = np.concatenate([p[name] for p in pieces], axis=0)
    if len(flat) != meta["n_leaves"]:
        raise ValueError(
            f"checkpoint {path} holds {meta['n_leaves']} leaves but the "
            f"target structure has {len(flat)}")
    new = []
    for i, (kp, ref) in enumerate(flat):
        name = f"leaf_{i}"
        where = kp or "<root>"
        arr = data[name]
        ref_shape = tuple(ref.shape)
        if tuple(arr.shape) != ref_shape:
            raise ValueError(
                f"checkpoint {path} leaf {i} at {where}: stored shape "
                f"{tuple(arr.shape)} != expected {ref_shape}")
        want_dtype = meta.get("dtypes", {}).get(name)
        if want_dtype is not None and str(arr.dtype) != want_dtype:
            raise ValueError(
                f"checkpoint {path} leaf {i} at {where}: stored dtype "
                f"{arr.dtype} != recorded metadata {want_dtype} (corrupt "
                f"or mismatched .npz/.json pair)")
        want_shape = meta.get("shapes", {}).get(name)
        if want_shape is not None and tuple(want_shape) != tuple(arr.shape):
            raise ValueError(
                f"checkpoint {path} leaf {i} at {where}: stored shape "
                f"{tuple(arr.shape)} != recorded metadata "
                f"{tuple(want_shape)} (corrupt or mismatched .npz/.json "
                f"pair)")
        if isinstance(ref, TensorSpec):
            dtype, dev = ref.dtype, device
        else:
            dtype, dev = torch_dtype(ref.dtype), ref.device
        new.append(torch.from_numpy(np.array(arr, copy=True)).to(
            device=dev, dtype=dtype))
    return _rebuild(like_tree, new), meta["step"]
