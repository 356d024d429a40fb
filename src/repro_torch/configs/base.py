"""Federation config: ``FedConfig`` with the JAX package's field names,
defaults and validation, so ``dataclasses.asdict`` moves a config across."""
from __future__ import annotations

import dataclasses

CODECS = ("none", "int8", "topk")


def validate_codec(name: str, bits: int, topk_frac: float) -> None:
    """Codec validation shared by ``FedConfig``. Raises ``ValueError``."""
    if name not in CODECS:
        raise ValueError(f"codec must be one of {CODECS}, got {name!r}")
    if not 2 <= bits <= 8:
        raise ValueError(f"codec_bits must be in [2, 8] (levels are shipped "
                         f"bit-packed, one f32 scale per tensor), "
                         f"got {bits}")
    if not 0.0 < topk_frac <= 1.0:
        raise ValueError(f"topk_frac must be in (0, 1] (1 = keep every "
                         f"entry), got {topk_frac}")


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """AdaFBiO hyper-parameters (Algorithm 1)."""
    q: int = 8                  # local steps between syncs
    neumann_k: int = 8          # K in Eq. (15)
    lr_x: float = 1e-3          # gamma
    lr_y: float = 1e-2          # lambda
    eta: float = 0.5            # eta_t (momentum interpolation); schedule in core
    alpha_c1: float = 4.0       # alpha_{t+1} = c1 * eta_t^2
    beta_c2: float = 4.0        # beta_{t+1}  = c2 * eta_t^2
    rho: float = 1e-4           # adaptive-matrix regularizer
    varrho: float = 0.9         # EMA for adaptive matrices
    nu: float = 1e-3            # LL strong-convexity regularizer
    theta: float = 1.0          # Neumann step (vartheta in paper, <= 1/L_g)
    adaptive: str = "adam"      # adam | adabelief | amsgrad | adagrad | none
    eta_k: float = 1.0          # k in eta_t = k M^{1/3} / (n+t)^{1/3}
    eta_n: float = 64.0         # n in the eta_t schedule
    # UL (f) batch and Neumann batch sizes as fractions of the LL batch
    ul_batch_frac: float = 0.125
    neumann_batch: int = 1
    # gradient-accumulation bound: sequences per microbatch per data shard
    microbatch_per_shard: int = 1
    # fused flat-buffer update path (STORM refresh + Eq. 14): "auto" takes
    # the CUDA kernels when the tensors are on a CUDA device and the per-leaf
    # path elsewhere; "on" forces the flat-buffer path (the kernels' plain
    # versions on the CPU); "off" disables it.
    fused: str = "auto"
    # ---- communication compression: only "none" is ported so far ----
    codec: str = "none"
    codec_bits: int = 8
    topk_frac: float = 0.1
    error_feedback: bool = True

    def __post_init__(self):
        validate_codec(self.codec, self.codec_bits, self.topk_frac)
