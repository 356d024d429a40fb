"""Configs with the JAX package's field names, defaults and validation, so
``dataclasses.asdict`` moves a config across: the federation configs
(``FedConfig``, ``PopulationConfig``) and the model architectures
(``ArchConfig`` and its registry, ``ShapeConfig``, ``reduced``).

The registry holds the architectures the port runs so far, one module each
under ``configs/``: the dense family (``qwen2.5-14b`` GQA, ``qwen1.5-4b``
MHA, ``granite-20b`` MQA, ``deepseek-67b``), the vlm family
(``internvl2-76b``, the language backbone with stubbed patch embeddings),
the moe family (``qwen3-moe-30b-a3b``, ``llama4-scout-17b-a16e``), the ssm
family (``falcon-mamba-7b``, mamba1) and the hybrid family
(``zamba2-1.2b``, mamba2 with a shared attention block) and the encdec
family (``whisper-tiny``, an encoder over stubbed frame embeddings and a
decoder with cross-attention): every architecture of the JAX package, in
its registry's order.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

CODECS = ("none", "int8", "topk")
TOPOLOGIES = ("ring", "torus2d", "complete", "erdos")
DELAY_MODELS = ("uniform", "tiers", "lognormal", "trace")


def validate_topology(name: str, er_p: float, time_varying: bool) -> None:
    """Gossip-topology validation shared by ``PopulationConfig``. Raises
    ``ValueError``."""
    if name not in TOPOLOGIES:
        raise ValueError(f"topology must be one of {TOPOLOGIES}, "
                         f"got {name!r}")
    if not 0.0 <= er_p <= 1.0:
        raise ValueError(f"er_p must be in [0, 1], got {er_p}")
    if time_varying and name != "erdos":
        raise ValueError("time_varying resamples an Erdős–Rényi graph every "
                         "round: the fixed topologies (ring/torus2d/"
                         "complete) are static by definition — set "
                         "topology='erdos'")


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
    # ---- communication compression (repro_torch.fed.compress) ----
    # client→server update codec: "none" (full precision), "int8"
    # (stochastic uniform quantization to codec_bits-bit levels, on the
    # quantize kernels), "topk" (magnitude sparsification keeping a
    # topk_frac fraction of each tensor)
    codec: str = "none"
    codec_bits: int = 8
    topk_frac: float = 0.1
    # error feedback: keep each client's compression residual and fold it
    # into its next message (EF-SGD; lossy codecs only)
    error_feedback: bool = True

    def __post_init__(self):
        validate_codec(self.codec, self.codec_bits, self.topk_frac)


def validate_delay_model(name: str, max_delay: int, tier_fracs, tier_delays,
                         delay_sigma: float) -> None:
    """Delay-model validation shared by ``PopulationConfig``. Raises
    ``ValueError``."""
    if name not in DELAY_MODELS:
        raise ValueError(f"delay_model must be one of {DELAY_MODELS}, "
                         f"got {name!r}")
    if max_delay < 1:
        raise ValueError(f"max_delay must be >= 1 round, got {max_delay}")
    if name == "tiers":
        if len(tier_fracs) != len(tier_delays) or not tier_fracs:
            raise ValueError(
                f"tiers need matching non-empty tier_fracs/tier_delays, "
                f"got {len(tier_fracs)} fracs, {len(tier_delays)} delay "
                f"ranges")
        if (any(f <= 0 for f in tier_fracs)
                or abs(sum(tier_fracs) - 1.0) > 1e-6):
            raise ValueError(f"tier_fracs must be positive and sum to 1, "
                             f"got {tier_fracs}")
        if any(not 1 <= lo <= hi for lo, hi in tier_delays):
            raise ValueError(f"each tier delay range needs 1 <= lo <= hi "
                             f"rounds, got {tier_delays}")
    if name == "lognormal":
        if delay_sigma < 0:
            raise ValueError(f"delay_sigma must be >= 0, got {delay_sigma}")
        if max_delay < 2:
            raise ValueError(
                "lognormal delays are clipped to [1, max_delay]: "
                "max_delay=1 makes every delay 1 (the degenerate "
                "no-heterogeneity case) — set max_delay >= 2")


@dataclasses.dataclass(frozen=True)
class PopulationConfig:
    """Client population ≫ per-round cohort (repro_torch.fed.population).

    ``n`` persistent client states live in a bank; each round a sampler
    picks a ``cohort`` of C clients, and only those C are computed (gather,
    the round's local steps, scatter), so per-round compute is O(C), not
    O(n). The asynchronous fields are kept and validated; the port runs the
    synchronous rounds only (``max_staleness = 0``) until the async slice.
    """
    n: int                          # population size N
    cohort: int                     # per-round compute cohort C
    sampler: str = "uniform"        # uniform | roundrobin | trace | trace-file
    sync_mode: str = "broadcast"    # broadcast | participants
    # staleness-aware aggregation: weight ∝ (1 + rounds_since_sync)^-decay;
    # 0 = plain uniform cohort average (only meaningful with participants)
    staleness_decay: float = 0.0
    # availability-trace sampler schedule (sampler == "trace")
    trace_period: int = 8
    trace_duty: float = 0.5
    # recorded-trace replay (sampler == "trace-file"): JSONL of per-client
    # up intervals (docs/async.md)
    trace_file: Optional[str] = None
    # ---- asynchronous execution: 0 = synchronous rounds; > 0 drops
    # arrivals staler than this many rounds (inf = no gating)
    max_staleness: float = 0.0
    max_delay: int = 1
    delay_eta: float = 0.0
    # heterogeneous per-client delay model: uniform | tiers | lognormal |
    # trace, with the tiers' population fractions and [lo, hi] delays and
    # the lognormal's location and scale (in rounds)
    delay_model: str = "uniform"
    tier_fracs: Tuple[float, ...] = (0.2, 0.6, 0.2)
    tier_delays: Tuple[Tuple[int, int], ...] = ((1, 1), (2, 4), (4, 8))
    delay_mu: float = 0.0
    delay_sigma: float = 0.5
    # ---- gossip engine: mixing topology of the decentralized rounds
    topology: str = "ring"
    er_p: float = 0.4
    time_varying: bool = False
    topology_seed: int = 0

    def __post_init__(self):
        if not 1 <= self.cohort <= self.n:
            raise ValueError(f"need 1 <= cohort <= n, got cohort="
                             f"{self.cohort}, n={self.n}")
        if self.sync_mode not in ("broadcast", "participants"):
            raise ValueError(f"sync_mode must be 'broadcast' or "
                             f"'participants', got {self.sync_mode!r}")
        if self.sampler not in ("uniform", "roundrobin", "trace",
                                "trace-file"):
            raise ValueError(f"sampler must be one of uniform/roundrobin/"
                             f"trace/trace-file, got {self.sampler!r}")
        if self.sampler == "trace-file" and not self.trace_file:
            raise ValueError("sampler='trace-file' needs trace_file=<path>")
        if self.max_staleness < 0:
            raise ValueError(f"max_staleness must be >= 0 (0 = synchronous),"
                             f" got {self.max_staleness}")
        if self.max_delay < 1:
            raise ValueError(f"max_delay must be >= 1 round, "
                             f"got {self.max_delay}")
        if self.delay_eta < 0:
            raise ValueError(f"delay_eta must be >= 0, got {self.delay_eta}")
        validate_delay_model(self.delay_model, self.max_delay,
                             self.tier_fracs, self.tier_delays,
                             self.delay_sigma)
        validate_topology(self.topology, self.er_p, self.time_varying)
        if self.delay_model == "trace" and not self.trace_file:
            raise ValueError("delay_model='trace' replays the trace_file's "
                             "per-client 'delay' field: set "
                             "trace_file=<path> (format: docs/async.md)")
        if self.max_staleness == 0 and (self.max_delay > 1
                                        or self.delay_eta > 0
                                        or self.delay_model != "uniform"):
            raise ValueError("max_delay > 1 / delay_eta > 0 / a non-uniform"
                             " delay_model are async knobs: set "
                             "max_staleness > 0 (or float('inf')) to "
                             "enable asynchronous execution")

    @property
    def asynchronous(self) -> bool:
        """True when rounds run the async path (overlapping cohorts,
        delayed arrivals, bounded-staleness gating)."""
        return self.max_staleness != 0


# ------------------------------------------------------------ architectures

@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    # if > 0, a shared (always-on) dense ffn of this width runs beside them
    d_ff_shared: int = 0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int
    expand: int = 2            # d_inner = expand * d_model
    conv_width: int = 4
    head_dim: int = 64         # mamba2 multi-head state layout
    version: int = 1           # 1 = mamba1 (falcon-mamba), 2 = mamba2 (zamba2)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec (whisper) architectures."""
    n_layers: int


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                # dense | moe | ssm | hybrid | encdec | vlm
    source: str                # citation of the published config
    n_layers: int
    d_model: int
    n_heads: int               # 0 for attention-free
    n_kv_heads: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    head_dim: int = 0          # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    # hybrid: apply the shared attention block every `shared_attn_every` layers
    shared_attn_every: int = 0
    # sliding-window width of the long-context serve variant
    long_context_window: int = 4096
    # multimodal early-fusion stub: prefix positions replaced by given embeds
    n_prefix_embeds: int = 0
    # federated placement on a mesh: "replica" or "zero" (the reference's
    # sharding.py). Without a mesh it means nothing: the port's trainer
    # runs one client on one device whatever it says (ROADMAP item 1f)
    fed_mode: str = "replica"
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        assert self.n_heads > 0
        return self.d_model // self.n_heads


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# the reference's registry, in its order
_ARCH_IDS = ("whisper-tiny", "zamba2-1.2b", "qwen2.5-14b", "internvl2-76b",
             "qwen3-moe-30b-a3b", "falcon-mamba-7b", "deepseek-67b",
             "granite-20b", "llama4-scout-17b-a16e", "qwen1.5-4b")


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "p")


def list_arch_ids() -> Tuple[str, ...]:
    return _ARCH_IDS


def get_arch(arch_id: str) -> ArchConfig:
    if arch_id not in _ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {_ARCH_IDS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.CONFIG


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A smoke-test-sized variant of the same family (<=2 layers,
    d_model<=256), field for field as the JAX package's ``reduced``."""
    d = min(cfg.d_model, 256)
    heads = min(cfg.n_heads, 4) if cfg.n_heads else 0
    kv = min(cfg.n_kv_heads, heads) if heads else 0
    if heads and cfg.n_kv_heads == cfg.n_heads:
        kv = heads                           # keep MHA archs MHA
    if heads and cfg.n_kv_heads == 1:
        kv = 1                               # keep MQA archs MQA
    changes = dict(
        n_layers=2,
        d_model=d,
        n_heads=heads,
        n_kv_heads=kv,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab=min(cfg.vocab, 512),
        head_dim=(d // heads if heads else 0),
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=min(cfg.moe.d_ff_expert, 128),
            d_ff_shared=(min(cfg.moe.d_ff_shared, 128)
                         if cfg.moe.d_ff_shared else 0))
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, state_dim=min(cfg.ssm.state_dim, 16),
            head_dim=min(cfg.ssm.head_dim, 32))
    if cfg.encoder is not None:
        changes["encoder"] = EncoderConfig(n_layers=2)
    if cfg.shared_attn_every:
        changes["shared_attn_every"] = 2
    if cfg.n_prefix_embeds:
        changes["n_prefix_embeds"] = 8
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
