from .block_sparse_attention import (  # noqa: F401
    TilePlan, block_sparse_attention, block_sparse_attention_bwd_dkv,
    block_sparse_attention_bwd_dq, block_sparse_attention_bwd_magnitude,
    block_sparse_attention_fwd, build_tile_plan,
    reference_block_sparse_attention, reference_block_sparse_attention_bwd)
from .decode_attention import (decode_attention,  # noqa: F401
                               reference_decode_attention)
from .flash_attention import (attention_delta, flash_attention,  # noqa: F401
                              flash_attention_bwd, flash_attention_bwd_dkv,
                              flash_attention_bwd_dq,
                              flash_attention_bwd_magnitude,
                              reference_flash_attention,
                              reference_flash_attention_bwd)
from .fused_adam import fused_adam_flat, reference_adam_flat  # noqa: F401
from .fused_lamb import (LambSegments, fused_lamb_flat,  # noqa: F401
                         lamb_phase1, lamb_phase2, lamb_step,
                         reference_lamb_flat, reference_lamb_phase1)
from .normalization import (fused_layer_norm, layer_norm_bwd,  # noqa: F401
                            reference_layer_norm)
from .paged_decode_attention import (paged_decode_attention,  # noqa: F401
                                     paged_prefill_attention,
                                     reference_paged_attention)
from .quant_matmul import (int4_a8_matmul, int4_matmul,  # noqa: F401
                           int8_a8_matmul, int8_matmul,
                           quantize_activation_rows, quantize_int4,
                           reference_int4_a8_matmul, reference_int4_matmul,
                           reference_int8_a8_matmul, reference_int8_matmul,
                           unpack_int4)
from .quantization import (dequantize_symmetric,  # noqa: F401
                           fake_quantize, quantize_symmetric,
                           reference_quantize_symmetric)
from .registry import (launch_counts, op_report,  # noqa: F401
                       reset_launch_counts)
from .spatial import (diffusers_attention, fused_group_norm,  # noqa: F401
                      reference_group_norm)
from .sparse_attention import (  # noqa: F401
    BigBirdSparsityConfig, BSLongformerSparsityConfig, DenseSparsityConfig,
    FixedSparsityConfig, LocalSlidingWindowSparsityConfig,
    LocalSparsityConfig, SparsityConfig, VariableSparsityConfig,
    layout_to_token_mask, make_sparse_attention_impl, sparse_self_attention,
    tile_plan_for)

__all__ = ["TilePlan", "block_sparse_attention",
           "block_sparse_attention_bwd_dkv", "block_sparse_attention_bwd_dq",
           "block_sparse_attention_bwd_magnitude",
           "block_sparse_attention_fwd", "build_tile_plan",
           "reference_block_sparse_attention",
           "reference_block_sparse_attention_bwd",
           "LambSegments", "fused_lamb_flat", "lamb_phase1", "lamb_phase2",
           "lamb_step", "reference_lamb_flat", "reference_lamb_phase1",
           "BigBirdSparsityConfig", "BSLongformerSparsityConfig",
           "DenseSparsityConfig", "FixedSparsityConfig",
           "LocalSlidingWindowSparsityConfig", "LocalSparsityConfig",
           "SparsityConfig", "VariableSparsityConfig",
           "layout_to_token_mask", "make_sparse_attention_impl",
           "sparse_self_attention", "tile_plan_for",
           "decode_attention", "reference_decode_attention",
           "attention_delta", "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "flash_attention_bwd_magnitude",
           "reference_flash_attention", "reference_flash_attention_bwd",
           "fused_adam_flat", "reference_adam_flat",
           "fused_layer_norm", "layer_norm_bwd", "reference_layer_norm",
           "paged_decode_attention", "paged_prefill_attention",
           "reference_paged_attention", "int4_a8_matmul", "int4_matmul",
           "int8_a8_matmul", "int8_matmul", "quantize_activation_rows",
           "quantize_int4", "reference_int4_a8_matmul",
           "reference_int4_matmul", "reference_int8_a8_matmul",
           "reference_int8_matmul", "unpack_int4", "launch_counts", "op_report",
           "reset_launch_counts", "dequantize_symmetric", "fake_quantize",
           "quantize_symmetric", "reference_quantize_symmetric",
           "diffusers_attention", "fused_group_norm", "reference_group_norm"]
