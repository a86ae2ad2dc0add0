from .convert import params_from_jax, params_to_numpy  # noqa: F401
from .core import (Model, cast_floating, is_quantized,  # noqa: F401
                   param_count, tree_bytes)
from .presets import available_presets, create_model, transformer_config  # noqa: F401
from .spatial import (attention_block, conv2d, group_norm,  # noqa: F401
                      init_mid_block, mid_block, resnet_block)
from .transformer import (TransformerConfig, build_model,  # noqa: F401
                          cross_entropy_loss, forward, init_params)

__all__ = ["params_from_jax", "params_to_numpy", "Model", "cast_floating",
           "is_quantized", "param_count", "tree_bytes", "available_presets", "create_model",
           "transformer_config", "TransformerConfig", "build_model",
           "cross_entropy_loss", "forward", "init_params", "attention_block",
           "conv2d", "group_norm", "init_mid_block", "mid_block",
           "resnet_block"]
