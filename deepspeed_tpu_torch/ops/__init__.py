from .decode_attention import (decode_attention,  # noqa: F401
                               reference_decode_attention)
from .flash_attention import (attention_delta, flash_attention,  # noqa: F401
                              flash_attention_bwd, flash_attention_bwd_dkv,
                              flash_attention_bwd_dq,
                              flash_attention_bwd_magnitude,
                              reference_flash_attention,
                              reference_flash_attention_bwd)
from .fused_adam import fused_adam_flat, reference_adam_flat  # noqa: F401
from .normalization import (fused_layer_norm, layer_norm_bwd,  # noqa: F401
                            reference_layer_norm)
from .paged_decode_attention import (paged_decode_attention,  # noqa: F401
                                     paged_prefill_attention,
                                     reference_paged_attention)
from .registry import (launch_counts, op_report,  # noqa: F401
                       reset_launch_counts)

__all__ = ["decode_attention", "reference_decode_attention",
           "attention_delta", "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "flash_attention_bwd_magnitude",
           "reference_flash_attention", "reference_flash_attention_bwd",
           "fused_adam_flat", "reference_adam_flat",
           "fused_layer_norm", "layer_norm_bwd", "reference_layer_norm",
           "paged_decode_attention", "paged_prefill_attention",
           "reference_paged_attention", "launch_counts", "op_report",
           "reset_launch_counts"]
