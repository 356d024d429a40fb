"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 beside a shared FFN, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E]"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=0,
    vocab=202048,
    moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192, d_ff_shared=8192),
    n_prefix_embeds=256,        # early-fusion multimodal stub
    fed_mode="zero",
)
