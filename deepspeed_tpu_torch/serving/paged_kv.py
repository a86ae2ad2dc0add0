"""Paged KV arena — the device half of the serving layer.

Counterpart of ``deepspeed_tpu/serving/paged_kv.py``:

* ``BlockAllocator`` — host-side refcounted free list over the pool. Block 0
  is a reserved scratch block (inactive decode rows and prompt-chunk padding
  write there); allocatable ids are 1..num_blocks.
* ``PrefixCache`` — content-hashed prompt-prefix sharing: full prompt blocks
  are cached by chain hash, a new request whose prefix is cached maps those
  blocks into its table and skips their prefill; the first write into a
  shared block goes copy-on-write (``build_cow_program``).
* ``build_prefill_program`` / ``build_decode_program`` /
  ``build_cow_program`` — the serving programs as plain functions over the
  arena, which they update IN PLACE (the JAX programs take the arena
  donated and return the new one).
* ``sample_rows`` — per-row greedy/temperature/top-k/top-p sampling.

The host-side classes are copied near line for line; the programs and the
sampler are PyTorch.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..inference.kv_cache import (assert_block_divisible, blocks_for_tokens,
                                  init_paged_cache, paged_cache_memory_bytes)
from ..models.transformer import forward as model_forward

__all__ = ["BlockAllocator", "BlockAllocatorError", "PrefixCache",
           "blocks_for_tokens", "assert_block_divisible", "init_paged_cache",
           "paged_cache_memory_bytes", "build_prefill_program",
           "build_decode_program", "build_cow_program", "sample_rows",
           "extend_block_list", "truncate_block_list"]


class BlockAllocatorError(RuntimeError):
    """Allocator invariant violation (double free, foreign block)."""


class BlockAllocator:
    """Refcounted free-list allocator over the arena's allocatable blocks
    (1..capacity).

    Prefix sharing (copy-on-write block tables) makes one physical block
    appear in several sequences' tables, so every allocated block carries a
    reference count: ``alloc`` hands out blocks at refcount 1, ``incref``
    adds a sharer, and ``free`` DROPS ONE REFERENCE — the block returns to
    the free list only when its last reference is dropped. Callers that
    never share see a plain free list.

    Invariants (tested in tests/test_torch_serving.py):
      * ``blocks_in_use + blocks_free == capacity`` at all times;
      * a block is never handed out twice without reaching refcount 0;
      * dropping a reference that is not held raises (double free);
      * block 0 (scratch) is never allocated.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        self.capacity = int(num_blocks)
        # LIFO free list, lowest ids first out — deterministic for tests
        self._free: List[int] = list(range(self.capacity, 0, -1))
        self._refs: Dict[int, int] = {}
        self.peak_in_use = 0
        self.total_allocs = 0

    @property
    def blocks_in_use(self) -> int:
        return len(self._refs)

    @property
    def blocks_free(self) -> int:
        return len(self._free)

    @property
    def blocks_shared(self) -> int:
        """Blocks referenced by more than one holder (the sharing win)."""
        return sum(1 for r in self._refs.values() if r > 1)

    def refcount(self, block_id: int) -> int:
        return self._refs.get(block_id, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` fresh block ids at refcount 1, or None when the pool can't
        satisfy the request (caller decides whether to wait, evict cached
        prefixes, or preempt) — partial allocations never happen."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(n)]
        for b in ids:
            self._refs[b] = 1
        self.total_allocs += n
        self.peak_in_use = max(self.peak_in_use, len(self._refs))
        return ids

    def incref(self, ids: List[int]) -> None:
        """Add one reference per id — a new sharer of an allocated block."""
        for b in ids:
            if b not in self._refs:
                raise BlockAllocatorError(
                    f"incref of block {b} which is not allocated")
        for b in ids:
            self._refs[b] += 1

    def free(self, ids: List[int]) -> None:
        """Drop one reference per id; a block is recycled only when its
        LAST reference goes — freeing a shared block never takes it away
        from the other holders."""
        for b in ids:
            if b not in self._refs:
                raise BlockAllocatorError(
                    f"free of block {b} which is not allocated "
                    "(double free or foreign id)")
            self._refs[b] -= 1
            if self._refs[b] == 0:
                del self._refs[b]
                self._free.append(b)


def extend_block_list(alloc: BlockAllocator, blocks: List[int],
                      upto_tokens: int, block_size: int) -> bool:
    """Grow ``blocks`` (a block-table list) to cover ``upto_tokens``
    positions by PLAIN pool allocation — no cache eviction, no preemption.
    This is the optional-work discipline shared by the speculative verify
    extension and the draft arena: speculation must never cost anyone
    else their blocks. Returns False when the pool says no (the per-row
    auto-disable signal); ``blocks`` is unchanged in that case."""
    need = blocks_for_tokens(upto_tokens, block_size) - len(blocks)
    if need <= 0:
        return True
    ids = alloc.alloc(need)
    if ids is None:
        return False
    blocks.extend(ids)
    return True


def truncate_block_list(alloc: BlockAllocator, blocks: List[int],
                        upto_tokens: int, block_size: int) -> int:
    """Positional rollback shared by the target and draft arenas: drop one
    reference on every block of ``blocks`` past the ones covering
    positions [0, upto_tokens) — rejected speculative KV beyond the
    accepted length is dead weight (never read: causality over true
    positions). A shared (prefix-cache/fork) block stays resident for its
    other holders. Returns the number of references dropped."""
    keep = blocks_for_tokens(upto_tokens, block_size)
    dropped = len(blocks) - keep
    if dropped > 0:
        alloc.free(blocks[keep:])
        del blocks[keep:]
        return dropped
    return 0


class PrefixCache:
    """Content-hashed prompt-prefix → physical-block cache (vLLM/SGLang
    automatic prefix caching).

    Keys are CHAIN hashes: block i's key digests block i-1's key plus block
    i's tokens, so a block is reusable only under the exact same prefix.
    Only FULL prompt blocks are cached — their KV content is immutable once
    written (the arena layout is position-exact, so identical tokens at
    identical positions produce identical KV bytes under fixed params).

    The cache holds ONE pin reference per cached block. Entries whose block
    no request references (allocator refcount == 1) are evictable LRU-first
    under pool pressure; entries shared with live requests are pinned —
    eviction never frees a block somebody still reads.
    """

    def __init__(self, allocator: BlockAllocator, block_size: int):
        self.alloc = allocator
        self.block_size = int(block_size)
        self._entries: "OrderedDict[bytes, int]" = OrderedDict()
        self.inserts = 0
        self.evictions = 0

    @property
    def cached_blocks(self) -> int:
        return len(self._entries)

    @staticmethod
    def _chain(prev: bytes, tokens: np.ndarray) -> bytes:
        h = hashlib.blake2b(prev, digest_size=16)
        h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
        return h.digest()

    def chain_key(self, prompt: np.ndarray, prev: bytes,
                  block_index: int) -> bytes:
        """One incremental chain step: the key of block ``block_index``
        given its predecessor's key — callers registering blocks in order
        thread the digest instead of rehashing from block 0 (O(P) per
        request, not O(P^2))."""
        BS = self.block_size
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        return self._chain(prev, prompt[block_index * BS:
                                        (block_index + 1) * BS])

    def match(self, prompt) -> Tuple[List[int], int]:
        """Longest cached chain of full blocks for ``prompt``. Returns
        ``(block_ids, n_tokens)`` with ``n_tokens`` capped at
        ``len(prompt) - 1``: at least one prompt token always re-prefills,
        because the request's first sampled token needs the final prompt
        position's logits. When the cap bites (every prompt block cached),
        the last block is handed back SHARED and the re-prefilled token's
        write triggers copy-on-write. Does NOT take references or count
        hit statistics — the caller does both when it COMMITS to using
        the blocks (a rolled-back admission must not inflate the hit
        rate)."""
        BS = self.block_size
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        ids: List[int] = []
        key = b""
        for i in range(int(prompt.size) // BS):
            key = self._chain(key, prompt[i * BS:(i + 1) * BS])
            bid = self._entries.get(key)
            if bid is None:
                break
            self._entries.move_to_end(key)     # LRU recency
            ids.append(bid)
        n = min(len(ids) * BS, int(prompt.size) - 1)
        if n < 1:
            return [], 0
        return ids, n

    def insert_key(self, key: bytes, block_id: int) -> bool:
        """Register a fully-prefilled block under its (caller-threaded)
        chain key, pinning it with one cache reference. A key that is
        already cached keeps its existing block (no double pin)."""
        if key in self._entries:
            self._entries.move_to_end(key)
            return False
        self.alloc.incref([block_id])
        self._entries[key] = block_id
        self.inserts += 1
        return True

    def insert(self, prompt: np.ndarray, block_index: int,
               block_id: int) -> bool:
        """Convenience form of ``insert_key`` that rehashes the chain from
        block 0 — tests and one-off callers; the scheduler threads the
        digest incrementally instead."""
        key = b""
        for i in range(block_index + 1):
            key = self.chain_key(prompt, key, i)
        return self.insert_key(key, block_id)

    def clear(self) -> int:
        """Drop EVERY entry, pinned or not, releasing the cache's one pin
        reference per block: cached KV bytes are a pure function of
        (tokens, positions, params), so new params make every entry stale.
        Blocks shared with a live request stay resident for that request
        (``free`` drops one reference). Returns the number of entries
        dropped."""
        n = len(self._entries)
        for bid in self._entries.values():
            self.alloc.free([bid])
        self._entries.clear()
        return n

    def evict(self, need: int) -> int:
        """Drop up to ``need`` UNPINNED entries (blocks only the cache
        holds), LRU-first, returning their blocks to the free list.
        Returns the number actually freed — pinned entries (shared with a
        live request) are never touched."""
        freed = 0
        for key in list(self._entries):
            if freed >= need:
                break
            bid = self._entries[key]
            if self.alloc.refcount(bid) == 1:
                del self._entries[key]
                self.alloc.free([bid])
                freed += 1
                self.evictions += 1
        return freed


# ---------------------------------------------------------------------------
# per-row sampling
# ---------------------------------------------------------------------------


def _row_seed(base_seed: int, seed: int, step: int) -> int:
    """The row's generator seed: a function of (engine seed, request seed,
    output-token index) only, so a request's stream does not depend on how
    the scheduler batched it (the JAX fold_in discipline, paged_kv.py:340)."""
    h = hashlib.blake2b(np.asarray([base_seed, seed, step], np.int64)
                        .tobytes(), digest_size=8)
    return int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)


def sample_rows(logits: torch.Tensor, base_seed: int,
                temperature: np.ndarray, top_k: np.ndarray,
                top_p: np.ndarray, seeds: np.ndarray,
                steps: np.ndarray) -> torch.Tensor:
    """Per-row sampling: ``logits`` (R, V) on the device; the knobs are host
    arrays (R,). Rows with ``temperature <= 0`` take the greedy branch — an
    fp32 argmax, first maximal index on ties (as ``jnp.argmax``). Other rows
    draw from a ``torch.Generator`` seeded from (engine seed, request seed,
    token index) after top-k and top-p filtering (the JAX rule); they cannot
    reproduce JAX's random bits. Returns (R,) int64 on the device."""
    logits = logits.float()
    out = logits.argmax(dim=-1)
    V = logits.shape[-1]
    for r in np.nonzero(np.asarray(temperature) > 0.0)[0]:
        scaled = logits[r] / max(float(temperature[r]), 1e-6)
        k = int(top_k[r])
        if k > 0:
            kth = torch.topk(scaled, min(k, V)).values[-1]
            scaled = torch.where(scaled < kth,
                                 torch.full_like(scaled, -float("inf")),
                                 scaled)
        desc = torch.sort(scaled, descending=True).values
        probs = torch.softmax(desc, dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) < float(top_p[r])
        keep[0] = True                 # top-1 always survives
        cutoff = desc[keep].min()
        scaled = torch.where(scaled >= cutoff, scaled,
                             torch.full_like(scaled, -float("inf")))
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(_row_seed(base_seed, int(seeds[r]), int(steps[r])))
        out[r] = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                                   generator=gen)[0]
    return out


# ---------------------------------------------------------------------------
# the serving programs
# ---------------------------------------------------------------------------


def build_prefill_program(cfg, paged_impl: str = "auto"):
    """Prefill-chunk program over the paged arena.

    Args:
      params, cache          — model params / paged arena (updated in place)
      block_table (1, MAXB)  — int32 tensor: the request's physical block ids
      chunk (1, C)           — int64 tensor: prompt tokens, zero-padded past
                               ``n_valid``
      start, n_valid         — ints: absolute position of chunk[0], real
                               tokens in the chunk (pad writes land in the
                               scratch block; pad logits are never read)
      temperature/top_k/top_p/seeds (1,) — host arrays, the request's knobs
      base_seed              — the engine's sampling seed

    Returns (token (1,), last_logits (1, V) fp32): ``token`` samples the
    position ``n_valid - 1`` logits at output-token index 0.
    """
    @torch.no_grad()
    def prefill_chunk(params, cache, block_table, chunk, start, n_valid,
                      temperature, top_k, top_p, seeds, base_seed):
        C = chunk.shape[1]
        offs = torch.arange(C, device=chunk.device)
        write_mask = (offs < n_valid)[None]
        # pad queries ride position -1: a pad position past the written
        # range would widen the read's visible window onto scratch/recycled
        # pages, whose non-finite residue must never touch live rows
        pos = torch.where(write_mask, (start + offs)[None],
                          torch.full_like(write_mask, -1, dtype=torch.long))
        logits, _ = model_forward(params, chunk, cfg, cache=cache,
                                  positions=pos, block_table=block_table,
                                  paged_write_mask=write_mask,
                                  paged_impl=paged_impl, paged_chunk=True)
        last = logits[:, max(n_valid - 1, 0)].float()
        tok = sample_rows(last, base_seed, temperature, top_k, top_p, seeds,
                          np.zeros((1,), np.int64))
        return tok, last

    return prefill_chunk


def build_decode_program(cfg, paged_impl: str = "auto"):
    """One-token decode step over the paged arena for a fixed row count R.
    Inactive rows carry an all-zero block table and length 0 — their writes
    land in the scratch block and their sampled tokens are ignored.

    Args: params, cache (updated in place), block_table (R, MAXB) int32,
    lengths (R,) int64 (tokens already in cache per row — the incoming
    token's position), tokens (R,) int64, temperature/top_k/top_p/seeds/steps
    (R,) host arrays, base_seed.
    Returns (next_token (R,), logits (R, V) fp32)."""
    @torch.no_grad()
    def decode(params, cache, block_table, lengths, tokens, temperature,
               top_k, top_p, seeds, steps, base_seed):
        logits, _ = model_forward(params, tokens[:, None], cfg, cache=cache,
                                  positions=lengths[:, None],
                                  block_table=block_table,
                                  paged_impl=paged_impl)
        last = logits[:, -1].float()
        return (sample_rows(last, base_seed, temperature, top_k, top_p,
                            seeds, steps), last)

    return decode


def build_cow_program():
    """Copy-on-write block copy: duplicate physical block ``src`` into
    ``dst`` across every layer of the arena, in place — run before the
    first write into a block whose refcount is > 1 (prefix sharing)."""
    @torch.no_grad()
    def cow_copy(cache, src: int, dst: int):
        cache["k"][:, dst] = cache["k"][:, src]
        cache["v"][:, dst] = cache["v"][:, src]

    return cow_copy
