"""Carrying trees between the JAX reference and the port.

The reference exports params, client states and server state with
``jax.tree.map(np.asarray, ...)``; :func:`from_reference` turns such a
nested dict of numpy arrays into the port's tensors and :func:`to_numpy`
goes back. bfloat16 arrives as ml_dtypes' numpy bfloat16 and is carried
bit for bit; on the way back it widens to float32, which is exact.
:func:`serve_params_from_reference` carries a model's params and checks
them against the port's ``model_specs`` on the way.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tree_util import tree_map
from repro_torch.models.params import torch_dtype


def _leaf_to_torch(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(arr, copy=True).view(np.uint16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def from_reference(tree, device) -> object:
    """Nested dicts/lists of numpy arrays (or scalars) -> tensors on
    ``device``, dtypes kept."""
    return tree_map(lambda a: _leaf_to_torch(a, device), tree)


def to_numpy(tree) -> object:
    """Tensors -> numpy arrays on the host (bfloat16 widens to float32)."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree_map(leaf, tree)


def _named(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], f"{path}/{k}" if path else k)
    else:
        yield path, tree


def serve_params_from_reference(cfg, tree, device="cuda") -> dict:
    """The reference's model params (``init_params(model_specs(cfg))`` or a
    trained model, as numpy) as the port's tensors on ``device``. Every
    leaf's path, shape and dtype must match the port's ``model_specs(cfg)``;
    a difference raises ``ValueError`` naming the leaf."""
    from repro_torch.models.model import model_specs
    want = dict(_named(model_specs(cfg)))
    got = dict(_named(tree))
    for path in sorted(set(want) | set(got)):
        if path not in got:
            raise ValueError(f"leaf {path}: missing from the reference tree")
        if path not in want:
            raise ValueError(f"leaf {path}: not a param of {cfg.name}")
        arr, spec = np.asarray(got[path]), want[path]
        dtype = torch_dtype(spec.dtype or cfg.dtype)
        have = _leaf_to_torch(np.zeros((), arr.dtype), "cpu").dtype
        if tuple(arr.shape) != tuple(spec.shape) or have != dtype:
            raise ValueError(f"leaf {path}: reference has {have} "
                             f"{tuple(arr.shape)}, the port's spec "
                             f"{dtype} {tuple(spec.shape)}")
    return from_reference(tree, device)
