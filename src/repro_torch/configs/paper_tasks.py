"""Config of the paper's hyper-representation experiment (Section 6.1)."""
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
