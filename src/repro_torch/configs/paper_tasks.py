"""Configs of the paper's own experiments (Section 6).

1. Federated hyper-representation learning (Problem (3)): an MLP backbone
   ``x`` shared across clients, per-client linear heads ``y^m``.
2. Federated data hyper-cleaning (Problem (4)): per-sample weights ``x``
   (UL variable), a linear classifier ``y`` (LL variable) trained on
   weighted, label-corrupted client data.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import FedConfig


@dataclasses.dataclass(frozen=True)
class HyperRepConfig:
    n_clients: int = 8
    in_dim: int = 32
    hidden: int = 64
    rep_dim: int = 32
    n_classes: int = 10
    batch: int = 32
    fed: FedConfig = dataclasses.field(default_factory=lambda: FedConfig(
        q=8, neumann_k=4, lr_x=0.01, lr_y=0.1, nu=1e-3))


@dataclasses.dataclass(frozen=True)
class HyperCleanConfig:
    n_clients: int = 8
    n_train_per_client: int = 128     # dim(x^m) = per-sample weights
    n_val_per_client: int = 64
    feat_dim: int = 32
    n_classes: int = 10
    corrupt_frac: float = 0.3
    nu: float = 1e-2                  # LL l2 regulariser (strong convexity)
    batch: int = 32
    fed: FedConfig = dataclasses.field(default_factory=lambda: FedConfig(
        q=8, neumann_k=4, lr_x=0.05, lr_y=0.1, nu=1e-2))
