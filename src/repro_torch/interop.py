"""Carrying trees between the JAX reference and the port.

The reference exports params, client states and server state with
``jax.tree.map(np.asarray, ...)``; :func:`from_reference` turns such a
nested dict of numpy arrays into the port's tensors and :func:`to_numpy`
goes back. bfloat16 arrives as ml_dtypes' numpy bfloat16 and is carried
bit for bit; on the way back it widens to float32, which is exact.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tree_util import tree_map


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
