from .engine import InferenceConfig, InferenceEngine, init_inference  # noqa: F401
from .kv_cache import (cache_memory_bytes, init_cache,  # noqa: F401
                       init_paged_cache, paged_cache_memory_bytes)

__all__ = ["InferenceConfig", "InferenceEngine", "init_inference",
           "cache_memory_bytes", "init_cache", "init_paged_cache",
           "paged_cache_memory_bytes"]
