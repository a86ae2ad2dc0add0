"""deepspeed_tpu_torch.parallel: ZeRO's partition of the flat buffers
(JAX counterpart: deepspeed_tpu/parallel)."""

from .zero import (ALIGN, SHARDED_FROM, GatheredLayers,  # noqa: F401
                   Piece, Unit, ZeroParams, ZeroPartition, sharded)

__all__ = ["ALIGN", "SHARDED_FROM", "GatheredLayers", "Piece", "Unit",
           "ZeroParams", "ZeroPartition", "sharded"]
