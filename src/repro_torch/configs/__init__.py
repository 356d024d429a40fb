from repro_torch.configs.base import (CODECS, INPUT_SHAPES, ArchConfig,
                                     EncoderConfig, FedConfig, MoEConfig,
                                     PopulationConfig, ShapeConfig, SSMConfig,
                                     get_arch, list_arch_ids, reduced,
                                     validate_codec)
from repro_torch.configs.paper_tasks import HyperCleanConfig, HyperRepConfig

__all__ = ["CODECS", "INPUT_SHAPES", "ArchConfig", "EncoderConfig",
           "FedConfig", "HyperCleanConfig", "HyperRepConfig", "MoEConfig",
           "PopulationConfig", "ShapeConfig", "SSMConfig", "get_arch",
           "list_arch_ids", "reduced", "validate_codec"]
