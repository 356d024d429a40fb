"""Dirichlet non-IID data partitioning across a client population.

The label-skew construction of the federated learning literature: for each
class k, split its examples among the N clients with proportions drawn from
Dir(alpha·1_N). Small alpha concentrates each class on few clients; large
alpha recovers a near-uniform IID split.

A Dirichlet draw is the softmax of log-gamma draws, as the JAX package
computes it. The draws are inputs: by default they come from PyTorch's
generator seeded by ``seed``; ``log_gamma`` (and ``perms`` for the
partition) hand in other draws, such as the reference's, exported through
numpy.

  dirichlet_class_priors  per-client class distributions [N, K]; used by
                          the generator of ``data.hyperclean``, which samples
                          labels rather than partitioning a fixed set.
  dirichlet_partition     index partition of a fixed labeled set (ragged,
                          on the host).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as devices


def _log_gamma(seed: int, shape, alpha: float) -> torch.Tensor:
    """log Gamma(alpha, 1) draws in float64 on the CPU (float64 keeps the
    tiny draws of a small alpha away from log 0), from PyTorch's generator
    seeded by ``seed`` and restored afterwards."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        draw = torch.distributions.Gamma(
            torch.full(shape, float(alpha), dtype=torch.float64),
            1.0).sample()
    return torch.log(draw)


def _softmax_rows(log_gamma) -> torch.Tensor:
    if not isinstance(log_gamma, torch.Tensor):
        log_gamma = torch.from_numpy(np.array(log_gamma, copy=True))
    return torch.softmax(log_gamma, dim=-1)


def dirichlet_class_priors(seed: int, n_clients: int, n_classes: int,
                           alpha: float, *,
                           log_gamma=None) -> torch.Tensor:
    """[n_clients, n_classes] class priors on the CPU, row i ~ Dir(alpha·1_K):
    the row softmax of ``log_gamma`` ([n_clients, n_classes] log-gamma
    draws; default drawn from ``seed``)."""
    if alpha <= 0:
        raise ValueError(f"alpha must be > 0, got {alpha}")
    if log_gamma is None:
        log_gamma = _log_gamma(seed, (n_clients, n_classes), alpha).float()
    return _softmax_rows(log_gamma)


def dirichlet_partition(seed: int, labels, n_clients: int, alpha: float, *,
                        log_gamma=None,
                        perms: Optional[Sequence] = None) -> List[np.ndarray]:
    """Partition ``labels``' indices into ``n_clients`` Dirichlet-skewed sets.

    For each class k, the class's indices, shuffled by ``perms[k]`` (a
    permutation of their count; default drawn from ``seed`` and k), are split
    among clients with proportions row k of the softmax of ``log_gamma``
    ([n_classes, n_clients]; default drawn from ``seed``). Returns one int64
    index array per client; the arrays are disjoint and cover
    ``range(len(labels))``.
    """
    if alpha <= 0:
        raise ValueError(f"alpha must be > 0, got {alpha}")
    labels = np.asarray(labels)
    n_classes = int(labels.max()) + 1
    if log_gamma is None:
        log_gamma = _log_gamma(seed, (n_classes, n_clients), alpha).float()
    props = _softmax_rows(log_gamma).numpy()
    parts: List[List[np.ndarray]] = [[] for _ in range(n_clients)]
    for k in range(n_classes):
        idx_k = np.where(labels == k)[0]
        if idx_k.size == 0:
            continue
        if perms is not None:
            perm = np.asarray(perms[k])
        else:
            perm = torch.randperm(idx_k.size, generator=devices.generator(
                "cpu", seed, 1 + k)).numpy()
        idx_k = idx_k[perm]
        cuts = np.minimum((np.cumsum(props[k]) * idx_k.size).astype(int),
                          idx_k.size)[:-1]
        for cid, chunk in enumerate(np.split(idx_k, cuts)):
            parts[cid].append(chunk)
    return [np.concatenate(p) if p else np.zeros((0,), np.int64)
            for p in parts]


def label_histogram(labels, parts: Sequence[np.ndarray],
                    n_classes: int) -> np.ndarray:
    """[n_clients, n_classes] label counts of a partition (skew
    diagnostics)."""
    labels = np.asarray(labels)
    return np.stack([np.bincount(labels[idx], minlength=n_classes)
                     for idx in parts])
