"""whisper-tiny [audio]: 4L d_model=384 6H (GQA kv=6) d_ff=1536 vocab=51865.

Encoder-decoder transformer backbone; the mel-spectrogram and conv feature
extractor frontend is stubbed: the batches carry precomputed frame
embeddings (``enc_embeds``). [arXiv:2212.04356]
"""
from repro_torch.configs.base import ArchConfig, EncoderConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="encdec",
    source="arXiv:2212.04356",
    n_layers=4,                 # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    encoder=EncoderConfig(n_layers=4),
    fed_mode="replica",
)
