"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64 — Mamba2 layers + a weight-tied shared attention
block. [arXiv:2411.15242]
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    source="arXiv:2411.15242",
    n_layers=38,
    d_model=2048,
    n_heads=32,                 # shared attention block
    n_kv_heads=32,
    d_ff=8192,                  # shared attention block MLP
    vocab=32000,
    ssm=SSMConfig(state_dim=64, expand=2, head_dim=64, version=2),
    shared_attn_every=6,
    fed_mode="replica",
)
