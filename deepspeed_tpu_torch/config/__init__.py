from .base import ConfigError, ConfigModel  # noqa: F401
from .config import (AIOConfig, BF16Config, CheckpointConfig,  # noqa: F401
                     CommsLoggerConfig, Config, FP16Config, OptimizerConfig,
                     ParallelConfig, SchedulerConfig, ServingConfig,
                     SpeculativeConfig, ZeroConfig, load_config)

__all__ = ["ConfigError", "ConfigModel", "AIOConfig", "BF16Config", "CheckpointConfig",
           "CommsLoggerConfig", "Config",
           "FP16Config", "OptimizerConfig", "ParallelConfig",
           "SchedulerConfig", "ServingConfig", "SpeculativeConfig",
           "ZeroConfig", "load_config"]
