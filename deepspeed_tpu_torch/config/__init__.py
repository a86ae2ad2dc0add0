from .base import ConfigError, ConfigModel  # noqa: F401
from .config import (BF16Config, Config, FP16Config, OptimizerConfig,  # noqa: F401
                     ParallelConfig, SchedulerConfig, ServingConfig,
                     SpeculativeConfig, ZeroConfig, load_config)

__all__ = ["ConfigError", "ConfigModel", "BF16Config", "Config",
           "FP16Config", "OptimizerConfig", "ParallelConfig",
           "SchedulerConfig", "ServingConfig", "SpeculativeConfig",
           "ZeroConfig", "load_config"]
