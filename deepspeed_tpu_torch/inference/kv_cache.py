"""KV caches: the dense arena of ``generate()`` and the paged serving arena.

Counterpart of ``deepspeed_tpu/inference/kv_cache.py``.

Dense (``init_cache``): one contiguous arena per batch,

    {"k": (L, B, T_MAX, KV_HEADS, HEAD_DIM),
     "v": (L, B, T_MAX, KV_HEADS, HEAD_DIM)}

written in place from a write cursor. JAX carries that cursor in the arena
as a traced ``index`` array; the port keeps it as a host int held by the
engine (``InferenceEngine.generate``) and passed to ``forward`` as
``start_pos``, because eager PyTorch needs no traced cursor.

Paged (``init_paged_cache``): the time axis is carved into fixed-size
blocks shared by every in-flight request (vLLM's PagedAttention block
tables, Kwon et al. SOSP '23):

    {"k": (L, NUM_BLOCKS, BLOCK, KV_HEADS, HEAD_DIM),
     "v": (L, NUM_BLOCKS, BLOCK, KV_HEADS, HEAD_DIM)}

Block 0 is a reserved scratch block: writes of inactive decode rows and
prompt-chunk padding land there. A host-side free list
(``serving/paged_kv.BlockAllocator``) owns blocks 1.. and hands each
sequence a block table of physical ids. ``dtype`` and ``device`` are
mandatory: the arena's type must come from the engine's config.
"""

from __future__ import annotations

from typing import Dict

import torch


def init_cache(cfg, batch_size: int, max_seq_len: int, dtype: torch.dtype,
               device) -> Dict[str, torch.Tensor]:
    """Allocate the dense arena for ``cfg`` (a TransformerConfig), zeroed.
    The write cursor is the caller's host int (see the module docstring)."""
    shape = (cfg.num_layers, batch_size, max_seq_len, cfg.num_kv_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_memory_bytes(cfg, batch_size: int, max_seq_len: int,
                       dtype: torch.dtype = torch.bfloat16) -> int:
    """Dense arena footprint in bytes."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return (2 * cfg.num_layers * batch_size * max_seq_len
            * cfg.num_kv_heads * cfg.head_dim * itemsize)


def blocks_for_tokens(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` KV entries."""
    return -(-max(int(n_tokens), 0) // int(block_size))


def assert_block_divisible(max_seq_len: int, block_size: int) -> int:
    """``max_seq_len`` must split into whole blocks. Returns blocks per
    sequence."""
    if block_size <= 0:
        raise ValueError(f"block_size must be positive, got {block_size}")
    if max_seq_len % block_size != 0:
        raise ValueError(
            f"max_seq_len={max_seq_len} is not divisible by "
            f"block_size={block_size} — the paged arena needs whole blocks "
            "(pick a block size that divides the sequence budget)")
    return max_seq_len // block_size


def init_paged_cache(cfg, num_blocks: int, block_size: int,
                     dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """Allocate the paged arena: ``num_blocks`` INCLUDES the reserved
    scratch block 0 (allocatable blocks are 1..num_blocks-1)."""
    if num_blocks < 2:
        raise ValueError(f"num_blocks={num_blocks}: need the scratch block "
                         "plus at least one allocatable block")
    shape = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def paged_cache_memory_bytes(cfg, num_blocks: int, block_size: int,
                             dtype: torch.dtype) -> int:
    itemsize = torch.empty((), dtype=dtype).element_size()
    return (2 * cfg.num_layers * num_blocks * block_size
            * cfg.num_kv_heads * cfg.head_dim * itemsize)
