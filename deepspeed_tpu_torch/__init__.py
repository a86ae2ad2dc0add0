"""deepspeed_tpu_torch — the PyTorch / CUDA (Hopper) port of deepspeed_tpu.

The JAX package ``deepspeed_tpu`` stays the reference; this package ports it
slice by slice, keeping its module layout and names. It imports torch and
numpy, never JAX nor any module of ``deepspeed_tpu``. Every Pallas kernel on
a ported path becomes a CUDA kernel under ``csrc/``, built with ``nvcc`` for
``sm_90a`` at first use (``ops/registry.py``).

Ported so far: serving over the paged KV arena (``init_serving``), with the
fused norm and the paged decode / chunked-prefill attention kernels; offline
generation over a dense KV arena (``init_inference(...).generate``), with
the flash-attention forward and the dense decode attention kernels; and
single-device training (``initialize(...)`` -> ``engine.train_batch``), with
the flash-attention backward (dq, dkv) and fused Adam kernels; and
quantized inference (``init_inference(..., dtype="int8" | "int4" | "w8a8" |
"w4a8")``, which ``init_serving`` takes too), with the four quantized decode
GEMM kernels; block-sparse attention with LAMB; the diffusers spatial
blocks and group quantization; and data-parallel training under ZeRO
stages 0-3 over ``torch.distributed`` (``comm``, ``parallel/zero.py``) with
the JAX package's format-2 checkpoints (``runtime/checkpoint.py``). Entry
points run on CUDA unless the caller passes ``device="cpu"``.
"""

from .inference import InferenceConfig, InferenceEngine, init_inference  # noqa: F401
from .runtime import TrainEngine, initialize  # noqa: F401
from .serving import ServingConfig, ServingEngine, init_serving  # noqa: F401

__all__ = ["InferenceConfig", "InferenceEngine", "init_inference",
           "TrainEngine", "initialize", "ServingConfig", "ServingEngine",
           "init_serving"]
