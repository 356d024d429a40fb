"""internvl2-76b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256, InternViT + InternLM2. The vision encoder and projector are
stubbed: the prompt's first ``n_prefix_embeds`` positions take given patch
embeddings (early fusion); this config is the language backbone.
[arXiv:2404.16821]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    source="arXiv:2404.16821",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    n_prefix_embeds=256,
    fed_mode="zero",
)
