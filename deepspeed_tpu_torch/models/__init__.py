from .convert import params_from_jax, params_to_numpy  # noqa: F401
from .core import Model, cast_floating, param_count  # noqa: F401
from .presets import available_presets, create_model, transformer_config  # noqa: F401
from .transformer import (TransformerConfig, build_model,  # noqa: F401
                          cross_entropy_loss, forward, init_params)

__all__ = ["params_from_jax", "params_to_numpy", "Model", "cast_floating",
           "param_count", "available_presets", "create_model",
           "transformer_config", "TransformerConfig", "build_model",
           "cross_entropy_loss", "forward", "init_params"]
