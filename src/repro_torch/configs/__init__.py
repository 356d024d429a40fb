from repro_torch.configs.base import (CODECS, FedConfig, PopulationConfig,
                                     validate_codec)
from repro_torch.configs.paper_tasks import HyperRepConfig

__all__ = ["CODECS", "FedConfig", "HyperRepConfig", "PopulationConfig",
           "validate_codec"]
