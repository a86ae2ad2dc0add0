from .decode_attention import (decode_attention,  # noqa: F401
                               reference_decode_attention)
from .flash_attention import (flash_attention,  # noqa: F401
                              reference_flash_attention)
from .normalization import fused_layer_norm, reference_layer_norm  # noqa: F401
from .paged_decode_attention import (paged_decode_attention,  # noqa: F401
                                     paged_prefill_attention,
                                     reference_paged_attention)
from .registry import (launch_counts, op_report,  # noqa: F401
                       reset_launch_counts)

__all__ = ["decode_attention", "reference_decode_attention",
           "flash_attention", "reference_flash_attention",
           "fused_layer_norm", "reference_layer_norm",
           "paged_decode_attention", "paged_prefill_attention",
           "reference_paged_attention", "launch_counts", "op_report",
           "reset_launch_counts"]
