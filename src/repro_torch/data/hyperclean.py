"""Federated data hyper-cleaning dataset (paper Problem (4)).

Per client: a training set with a fraction of its labels corrupted (each
resampled uniformly) and a clean validation set. The UL variable x^m
weights each training sample through σ(x_i); the LL variable y is a shared
linear classifier with an L2 (strongly convex) regulariser.

The construction is the JAX package's: class prototypes shared by every
client, a client-specific rotation for heterogeneity, Gaussian noise, and
labels drawn uniformly or, with ``label_alpha > 0``, from a client-specific
Dir(label_alpha·1_K) prior (:mod:`repro_torch.data.partition`). The draws
come from ``torch.Generator``s on the requested device seeded by (seed,
stream, client), so nothing is downloaded and a seed repeats a set. The
port cannot reproduce the reference's threefry streams; to hold the two
packages to one data set, hand the reference's ``all_clients()`` arrays to
:func:`from_arrays`.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict

import numpy as np
import torch

from repro_torch import device as devices

KEYS = ("a_tr", "b_tr", "a_val", "b_val", "corrupted")
# generator streams of one client's draws, apart from each other
_PROTO, _ROT, _TRAIN, _VAL, _BAD_IDX, _BAD_LAB, _PRIOR = range(7)


@functools.lru_cache(maxsize=8)
def _label_prior_table(seed: int, n_clients: int, n_classes: int,
                       alpha: float) -> torch.Tensor:
    """[n_clients, n_classes] Dirichlet label priors, drawn once per
    (seed, N, K, alpha)."""
    from repro_torch.data.partition import dirichlet_class_priors
    return dirichlet_class_priors(devices.mix_seed(seed, _PRIOR), n_clients,
                                  n_classes, alpha)


@dataclasses.dataclass(frozen=True)
class HyperCleanData:
    n_clients: int
    n_train: int
    n_val: int
    feat_dim: int
    n_classes: int
    corrupt_frac: float
    seed: int = 0
    # Dirichlet label skew: client m draws labels from a client-specific
    # Dir(label_alpha·1_K) prior instead of uniformly; 0 disables
    label_alpha: float = 0.0

    def client_data(self, m: int, device="cuda") -> Dict[str, torch.Tensor]:
        dev = devices.resolve(device)

        def gen(*parts) -> torch.Generator:
            return devices.generator(dev, self.seed, *parts)

        proto = torch.randn(self.n_classes, self.feat_dim,
                            generator=gen(_PROTO), device=dev)
        rot = torch.eye(self.feat_dim, device=dev) + 0.1 * torch.randn(
            self.feat_dim, self.feat_dim, generator=gen(_ROT, m),
            device=dev) / math.sqrt(self.feat_dim)
        prior = None
        if self.label_alpha > 0:
            prior = _label_prior_table(self.seed, self.n_clients,
                                       self.n_classes,
                                       self.label_alpha)[m].to(dev)

        def make(stream, n):
            g = gen(stream, m)
            if prior is None:
                labels = torch.randint(0, self.n_classes, (n,), generator=g,
                                       device=dev)
            else:
                labels = torch.multinomial(prior, n, replacement=True,
                                           generator=g)
            noise = torch.randn(n, self.feat_dim, generator=g, device=dev)
            return proto[labels] @ rot + 0.5 * noise, labels.to(torch.int32)

        a_tr, b_tr = make(_TRAIN, self.n_train)
        a_val, b_val = make(_VAL, self.n_val)
        # corrupt a fraction of the TRAIN labels
        n_bad = int(self.corrupt_frac * self.n_train)
        bad_idx = torch.randperm(self.n_train, generator=gen(_BAD_IDX, m),
                                 device=dev)[:n_bad]
        bad_lab = torch.randint(0, self.n_classes, (n_bad,),
                                generator=gen(_BAD_LAB, m), device=dev)
        b_tr = b_tr.index_put((bad_idx,), bad_lab.to(torch.int32))
        corrupted = torch.zeros(self.n_train, dtype=torch.bool,
                                device=dev).index_fill(0, bad_idx, True)
        return {"a_tr": a_tr, "b_tr": b_tr, "a_val": a_val, "b_val": b_val,
                "corrupted": corrupted}

    def all_clients(self, device="cuda") -> Dict[str, torch.Tensor]:
        """Every client's set, stacked [M, ...]."""
        ds = [self.client_data(m, device) for m in range(self.n_clients)]
        return {k: torch.stack([d[k] for d in ds]) for k in KEYS}


def from_arrays(arrays, device="cuda") -> Dict[str, torch.Tensor]:
    """A stacked data set given as arrays (the reference's
    ``all_clients()`` through numpy, or tensors) on ``device``: features
    f32, labels int32, ``corrupted`` bool."""
    dev = devices.resolve(device)
    dtypes = {"a_tr": torch.float32, "a_val": torch.float32,
              "b_tr": torch.int32, "b_val": torch.int32,
              "corrupted": torch.bool}

    def tensor(a):
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.array(a, copy=True))
        return a
    return {k: tensor(arrays[k]).to(device=dev, dtype=dtypes[k])
            for k in KEYS if k in arrays}
