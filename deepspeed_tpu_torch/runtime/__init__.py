from .dataloader import (DeepSpeedDataLoader, RepeatingLoader,  # noqa: F401
                         default_collate)
from .engine import TrainEngine, initialize  # noqa: F401
from .loss_scaler import (DynamicLossScaler, LossScaler,  # noqa: F401
                          create_loss_scaler, has_overflow)
from .lr_schedules import build_lr_schedule  # noqa: F401
from .optimizer import (MixedPrecisionOptimizer, OptimizerState,  # noqa: F401
                        StepStats, build_optimizer)

__all__ = ["DeepSpeedDataLoader", "RepeatingLoader", "default_collate",
           "TrainEngine", "initialize", "DynamicLossScaler", "LossScaler",
           "create_loss_scaler", "has_overflow", "build_lr_schedule",
           "MixedPrecisionOptimizer", "OptimizerState", "StepStats",
           "build_optimizer"]
