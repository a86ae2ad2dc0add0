"""Block-sparse attention: declarative sparsity layouts + attention impl.

Counterpart of ``deepspeed_tpu/ops/sparse_attention.py`` (DeepSpeed's
``sparsity_config.py`` Dense / Fixed / Variable / BigBird / BSLongformer /
LocalSlidingWindow configs and ``SparseSelfAttention``). The config classes
are copied so that ``make_layout`` gives JAX's layouts bit for bit (the same
``np.random.RandomState`` streams for BigBird and Variable).

``sparse_self_attention`` takes JAX's two routes:

* the block-skip kernels (``ops/block_sparse_attention.py``) over the
  config's cached ``TilePlan``, which visit only the active 128-tiles;
* the dense-mask route: the layout expanded to a token mask for the port's
  ``dot_product_attention``, which also takes a key-padding mask.

``use_kernel`` chooses as in JAX: ``None`` (auto) takes the kernels for a
CUDA tensor when there is no key-padding mask, S % 128 == 0 and
128 % block == 0 (JAX's auto rule with "tpu" read as "cuda"; JAX's
grid-step ceiling is a limit of the TPU and is not carried over), the dense
mask otherwise; ``True`` the kernels or raise; ``False`` the dense mask.
On a CPU tensor the kernel route runs the kernels' plain versions, as
``plain=True`` does on any device. The two routes differ only on a query
row that sees no key (no shipped layout builds one: each keeps its diagonal
block): the kernels give 0 there, the dense mask uniform weights.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .block_sparse_attention import (TilePlan, block_sparse_attention,
                                     build_tile_plan)


@dataclasses.dataclass
class SparsityConfig:
    """Shared properties (reference sparsity_config.py:10)."""

    num_heads: int
    block: int = 16
    different_layout_per_head: bool = False

    def num_layout_heads(self) -> int:
        return self.num_heads if self.different_layout_per_head else 1

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block != 0:
            raise ValueError(f"seq_len {seq_len} must be divisible by "
                             f"block {self.block}")
        n = seq_len // self.block
        return np.zeros((self.num_layout_heads(), n, n), dtype=np.int64)

    def check_and_propagate_first_head_layout(self, layout: np.ndarray
                                              ) -> np.ndarray:
        if not self.different_layout_per_head:
            layout = np.broadcast_to(layout[0:1],
                                     (self.num_heads, *layout.shape[1:]))
        return np.ascontiguousarray(layout)

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError


@dataclasses.dataclass
class DenseSparsityConfig(SparsityConfig):
    """All blocks live (reference :63) — the degenerate baseline."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return self.check_and_propagate_first_head_layout(layout)


@dataclasses.dataclass
class FixedSparsityConfig(SparsityConfig):
    """Fixed pattern (reference :95): local windows of ``num_local_blocks``
    plus each window attending the last ``num_global_blocks`` of every
    previous window (unidirectional) — the GPT-3 sparse pattern."""

    num_local_blocks: int = 4
    num_global_blocks: int = 1
    attention: str = "unidirectional"
    horizontal_global_attention: bool = False

    def __post_init__(self):
        if self.num_local_blocks % max(self.num_global_blocks, 1) != 0:
            raise ValueError("num_local_blocks must be divisible by "
                             "num_global_blocks")
        if self.horizontal_global_attention and self.attention != "bidirectional":
            raise ValueError("horizontal global attention requires "
                             "bidirectional attention")

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        for h in range(layout.shape[0]):
            for start in range(0, n, self.num_local_blocks):
                end = min(start + self.num_local_blocks, n)
                for i in range(start, end):
                    hi = (i + 1) if self.attention == "unidirectional" else end
                    layout[h, i, start:hi] = 1
            for start in range(0, n, self.num_local_blocks):
                g0 = start + self.num_local_blocks - self.num_global_blocks
                g1 = start + self.num_local_blocks
                if g0 >= n:
                    continue
                g1 = min(g1, n)
                if self.attention == "unidirectional":
                    layout[h, g1:, g0:g1] = 1          # vertical stripes
                else:
                    layout[h, :, g0:g1] = 1
                    if self.horizontal_global_attention:
                        layout[h, g0:g1, :] = 1
        return self.check_and_propagate_first_head_layout(layout)


@dataclasses.dataclass
class LocalSlidingWindowSparsityConfig(SparsityConfig):
    """Sliding window of ``num_sliding_window_blocks`` (reference :692)."""

    num_sliding_window_blocks: int = 3
    attention: str = "unidirectional"

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for h in range(layout.shape[0]):
            for i in range(n):
                lo = max(0, i - w)
                hi = (i + 1 if self.attention == "unidirectional"
                      else min(n, i + w + 1))
                layout[h, i, lo:hi] = 1
        return self.check_and_propagate_first_head_layout(layout)


LocalSparsityConfig = LocalSlidingWindowSparsityConfig


@dataclasses.dataclass
class BigBirdSparsityConfig(SparsityConfig):
    """BigBird (reference :411): random + sliding window + global blocks."""

    num_random_blocks: int = 1
    num_sliding_window_blocks: int = 3
    num_global_blocks: int = 1
    attention: str = "bidirectional"
    seed: int = 0

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        rng = np.random.RandomState(self.seed)
        w = self.num_sliding_window_blocks // 2
        for h in range(layout.shape[0]):
            for i in range(n):
                lo, hi = max(0, i - w), min(n, i + w + 1)
                if self.attention == "unidirectional":
                    hi = i + 1
                layout[h, i, lo:hi] = 1
                pool = np.arange(n) if self.attention == "bidirectional" \
                    else np.arange(i + 1)
                k = min(self.num_random_blocks, len(pool))
                layout[h, i, rng.choice(pool, size=k, replace=False)] = 1
            g = min(self.num_global_blocks, n)
            layout[h, :g, :] = 1 if self.attention == "bidirectional" else \
                layout[h, :g, :]
            layout[h, :, :g] = 1
            if self.attention == "unidirectional":
                layout[h] = np.tril(layout[h])
        return self.check_and_propagate_first_head_layout(layout)


@dataclasses.dataclass
class VariableSparsityConfig(SparsityConfig):
    """Variable layout (reference :239): Fixed extended with per-window
    local block sizes (the last entry repeats), optional random blocks per
    row, and global blocks given as indices or [start, end) ranges. As in
    JAX, a unidirectional layout is ``np.tril``-ed at the end, which also
    removes the above-diagonal random blocks the reference keeps."""

    num_random_blocks: int = 0
    local_window_blocks: tuple = (4,)
    global_block_indices: tuple = (0,)
    global_block_end_indices: Optional[tuple] = None
    attention: str = "bidirectional"
    horizontal_global_attention: bool = False
    seed: int = 0

    def __post_init__(self):
        if self.global_block_end_indices is not None:
            if len(self.global_block_indices) != len(
                    self.global_block_end_indices):
                raise ValueError(
                    "global_block_end_indices must pair 1:1 with "
                    "global_block_indices")
            for s, e in zip(self.global_block_indices,
                            self.global_block_end_indices):
                if s >= e:
                    raise ValueError(
                        f"global block range [{s}, {e}) is empty")
        if self.horizontal_global_attention and self.attention != "bidirectional":
            raise ValueError("horizontal global attention requires "
                             "bidirectional attention")

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        uni = self.attention == "unidirectional"
        rng = np.random.RandomState(self.seed)
        for h in range(layout.shape[0]):
            if self.num_random_blocks:
                k = min(self.num_random_blocks, n)
                for i in range(n):
                    layout[h, i, rng.choice(n, size=k, replace=False)] = 1
            start = 0
            sizes = list(self.local_window_blocks)
            while start < n:
                size = sizes.pop(0) if sizes else self.local_window_blocks[-1]
                end = min(start + size, n)
                for i in range(start, end):
                    hi = (i + 1) if uni else end
                    layout[h, i, start:hi] = 1
                start = end
            ranges = ([(g, g + 1) for g in self.global_block_indices]
                      if self.global_block_end_indices is None else
                      list(zip(self.global_block_indices,
                               self.global_block_end_indices)))
            for s, e in ranges:
                if s >= n:
                    continue
                e = min(e, n)
                if self.horizontal_global_attention:
                    layout[h, s:e, :] = 1
                first_row = 0 if not uni else s
                layout[h, first_row:, s:e] = 1
            if uni:
                layout[h] = np.tril(layout[h])
        return self.check_and_propagate_first_head_layout(layout)


@dataclasses.dataclass
class BSLongformerSparsityConfig(SparsityConfig):
    """Block-sparse Longformer (reference :546): sliding window + global
    blocks at chosen indices."""

    num_sliding_window_blocks: int = 3
    global_block_indices: tuple = (0,)
    attention: str = "bidirectional"

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for h in range(layout.shape[0]):
            for i in range(n):
                lo, hi = max(0, i - w), min(n, i + w + 1)
                layout[h, i, lo:hi] = 1
            for g in self.global_block_indices:
                if g < n:
                    layout[h, :, g] = 1
                    layout[h, g, :] = 1
            if self.attention == "unidirectional":
                layout[h] = np.tril(layout[h])
        return self.check_and_propagate_first_head_layout(layout)


def layout_to_token_mask(layout: np.ndarray, block: int,
                         device=None) -> torch.Tensor:
    """(H, nblk, nblk) block layout -> (H, S, S) int32 token mask."""
    return torch.from_numpy(np.kron(layout, np.ones((block, block))).astype(
        np.int32)).to(device)


# (config class, field values, seq_len) -> TilePlan. Keyed by VALUE, so
# callers that construct a fresh (but equal) config per call share one entry
_PLAN_CACHE: dict = {}
# configs whose field values stay unhashable are keyed by identity and
# pinned here, so a freed id can never be recycled onto another config
_PLAN_CACHE_PINS: list = []


def _hashable(v):
    if isinstance(v, (list, tuple)):
        return tuple(_hashable(e) for e in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _hashable(x)) for k, x in v.items()))
    if isinstance(v, np.ndarray):
        return (v.shape, str(v.dtype), v.tobytes())
    try:
        hash(v)
    except TypeError:
        if not any(p is v for p in _PLAN_CACHE_PINS):
            _PLAN_CACHE_PINS.append(v)
        return ("__id__", id(v))
    return v


def _config_cache_key(config: SparsityConfig) -> tuple:
    vals = [(f.name, _hashable(getattr(config, f.name)))
            for f in dataclasses.fields(config)]
    # the class object is part of the key: a redefined subclass with equal
    # fields but another make_layout must not hit a stale plan
    return (type(config), tuple(vals))


def tile_plan_for(config: SparsityConfig, seq_len: int) -> TilePlan:
    """Cached TilePlan for (config, seq_len): the static schedule the
    block-skip kernels execute."""
    key = (_config_cache_key(config), seq_len)
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        layout = np.asarray(config.make_layout(seq_len))
        plan = _PLAN_CACHE[key] = build_tile_plan(layout, config.block,
                                                  seq_len)
    return plan


def _unidirectional(config: SparsityConfig) -> bool:
    return getattr(config, "attention", "bidirectional") == "unidirectional"


def sparse_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          config: SparsityConfig,
                          key_padding_mask: Optional[torch.Tensor] = None,
                          use_kernel: Optional[bool] = None,
                          plain: bool = False) -> torch.Tensor:
    """SparseSelfAttention forward: q / k / v (B, S, N, D) -> (B, S, N, D),
    masked per the head layouts (unidirectional configs also causal, per
    token). ``use_kernel`` routes as the module docstring says; ``plain``
    runs the kernels' plain versions on the kernel route."""
    B, S, N, D = q.shape
    if N != config.num_heads:
        raise ValueError(f"q has {N} heads, config expects {config.num_heads}")
    from ..models.transformer import dot_product_attention

    if use_kernel is None:
        use_kernel = (key_padding_mask is None and S % 128 == 0
                      and 128 % config.block == 0 and q.is_cuda)
    if use_kernel:
        if key_padding_mask is not None:
            raise NotImplementedError(
                "block-skip kernel path does not take key_padding_mask "
                "yet — pass use_kernel=False (dense-mask fallback)")
        return block_sparse_attention(q, k, v, tile_plan_for(config, S),
                                      causal=_unidirectional(config),
                                      plain=plain)

    layout = config.make_layout(S)
    tok = layout_to_token_mask(layout, config.block, q.device)   # (N, S, S)
    if _unidirectional(config):
        # block layouts are block-causal; the reference's softmax kernel
        # applies token-level triangular masking inside diagonal blocks
        tok = tok * torch.ones(S, S, dtype=torch.int32, device=q.device).tril()
    mask = tok[None].expand(B, N, S, S)
    if key_padding_mask is not None:
        mask = mask * key_padding_mask[:, None, None, :].to(torch.int32)
    if not config.different_layout_per_head:
        # all heads share one layout: one call with the (B, S, T) mask
        return dot_product_attention(q, k, v, mask[:, 0], causal=False)
    outs = [dot_product_attention(q[:, :, h:h + 1], k[:, :, h:h + 1],
                                  v[:, :, h:h + 1], mask[:, h], causal=False)
            for h in range(N)]
    return torch.cat(outs, dim=2)


def make_sparse_attention_impl(config: SparsityConfig,
                               use_kernel: Optional[bool] = None):
    """``attention_impl`` factory (the module-swap analog of the
    reference's ``replace_model_self_attention``): pass the result as
    ``TransformerConfig.attention_impl`` or ``create_model(...,
    attention_impl=...)`` and every layer's attention runs through
    :func:`sparse_self_attention` with this config. Training / encoding
    only: the decode paths call it with a causal=False dense mask, which a
    unidirectional config refuses, as in JAX. ``plain`` (passed by
    ``forward(..., plain=True)``) runs the kernels' plain versions; any
    other keyword raises."""
    uni = _unidirectional(config)

    def impl(q, k, v, mask=None, causal=True, plain=False, **kw):
        if kw:
            raise NotImplementedError(
                f"sparse attention impl got unsupported kwargs "
                f"{sorted(kw)} — sliding windows/ALiBi/decode caches "
                "don't compose with block-sparse layouts")
        if bool(causal) != uni:
            raise ValueError(
                f"model causality (causal={causal}) does not match the "
                f"sparsity config's attention="
                f"'{getattr(config, 'attention', 'bidirectional')}' — "
                "pick a unidirectional config for causal models")
        return sparse_self_attention(q, k, v, config,
                                     key_padding_mask=mask,
                                     use_kernel=use_kernel, plain=plain)

    return impl

