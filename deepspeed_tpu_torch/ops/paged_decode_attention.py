"""Paged attention over the serving arena: decode and chunked prefill.

Counterpart of ``deepspeed_tpu/ops/paged_decode_attention.py``. The arena is
a shared pool of fixed-size KV blocks ``(NUM_BLOCKS, BLOCK, K, D)`` (block 0
is scratch); each row reaches its keys through a block table. The layout is
LEFT-ALIGNED: the token at absolute position ``p`` sits in block
``table[p // BLOCK]`` at offset ``p % BLOCK``, so a key's column is its
position and causality over true positions is the entire validity story.

* ``paged_decode_attention`` — one query per row, CUDA kernel
  ``csrc/paged_attention.cu::paged_split_kernel`` on a CUDA tensor: the
  blocks of a (row, KV head) are a cluster of ``splits`` that divide the
  row's pages among themselves on the device (``split_pages``) and merge in
  the same launch; ``paged_split_plan`` picks ``splits`` on the host from
  shapes alone, so the wrapper never reads ``lengths`` there.
* ``paged_prefill_attention`` — C chunk queries per row at positions
  ``start + c``; on a CUDA tensor, bf16 / fp16 with D in {16, 32, 64, 128}
  run ``csrc/paged_attention.cu::paged_prefill_tma_kernel`` (pages as TMA
  boxes, ``wgmma``), whose work tiles and page boxes ``paged_prefill_plan``
  picks on the host from shapes alone (the wrapper never reads ``start``
  or ``n_valid`` there); fp32 and other D run ``paged_prefill_kernel``.
* ``reference_paged_attention`` — the plain version of both (what each
  wrapper runs on a CPU tensor, and what the kernels are held against).
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Tuple

import torch

from . import registry
from .decode_attention import TILE, _sm_count, ring_stages, split_count

NEG_INF = -1e30
MAX_GROUP = 8        # query heads per KV head the kernels take
MAX_HEAD_DIM = 256
PREFILL_KEYS = 128   # keys of a key tile (a ring stage) of the prefill kernel
PREFILL_TC_DIMS = (16, 32, 64, 128)   # head dims of its 16-bit route

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def reference_paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, block_table: torch.Tensor,
                              positions: torch.Tensor,
                              alibi: Optional[torch.Tensor] = None,
                              scale: Optional[float] = None) -> torch.Tensor:
    """GQA-native paged attention over the gathered view. q (B, S, N, D);
    positions (B, S) absolute query positions (negative => inactive query,
    output zeros); pools (NUM_BLOCKS, BLOCK, K, D)."""
    B, S, N, D = q.shape
    BS, K = k_pool.shape[1], k_pool.shape[2]
    MAXB = block_table.shape[1]
    T = MAXB * BS
    G = N // K
    scale = scale if scale is not None else D ** -0.5
    bt = block_table.long()
    kk = k_pool[bt].reshape(B, T, K, D)
    vv = v_pool[bt].reshape(B, T, K, D)
    col = torch.arange(T, device=q.device)
    # zero v beyond each row's last visible position: masked columns get
    # softmax weight 0, but 0 x NaN = NaN, and scratch/recycled pages may
    # carry non-finite residue that must never reach a live row
    colmask = col[None] <= positions.max(dim=1).values[:, None]
    vv = torch.where(colmask[:, :, None, None], vv, torch.zeros_like(vv))
    q5 = q.reshape(B, S, K, G, D)
    s = torch.einsum("bskgd,btkd->bkgst", q5, kk).float() * scale
    if alibi is not None:
        al = alibi.float().reshape(K, G)
        s = s + al[None, :, :, None, None] * col.float()
    keep = col[None, None, :] <= positions[:, :, None]          # (B, S, T)
    s = torch.where(keep[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgst,btkd->bskgd", p, vv)
    # an all-masked score row softmaxes to uniform weights: inactive
    # queries are zeroed explicitly, like the kernels' empty rows
    inactive = (positions < 0)[:, :, None, None, None]
    o = torch.where(inactive, torch.zeros_like(o), o)
    return o.reshape(B, S, N, D)


def _check(fn: str, q: torch.Tensor, k_pool: torch.Tensor,
           v_pool: torch.Tensor, block_table: torch.Tensor,
           alibi: Optional[torch.Tensor], ints) -> None:
    """Everything the CUDA entry points assume, checked before launch."""
    N, D = q.shape[-2], q.shape[-1]
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"{fn}: k/v pools must both be (NB, BS, K, D), got "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    K = k_pool.shape[2]
    if k_pool.shape[3] != D:
        raise ValueError(f"{fn}: pool head_dim {k_pool.shape[3]} != q {D}")
    if N % K != 0 or N // K > MAX_GROUP:
        raise ValueError(f"{fn}: n_heads {N} must be a multiple of kv_heads "
                         f"{K} with at most {MAX_GROUP} query heads per KV "
                         "head")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"{fn}: head_dim {D} > {MAX_HEAD_DIM}")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise ValueError(f"{fn}: q/k/v must share one of float32, bfloat16, "
                         f"float16; got {q.dtype}/{k_pool.dtype}/"
                         f"{v_pool.dtype}")
    tensors = [("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
               ("block_table", block_table)] + list(ints)
    if alibi is not None:
        if alibi.shape != (N,) or alibi.dtype != torch.float32:
            raise ValueError(f"{fn}: alibi must be ({N},) float32")
        tensors.append(("alibi", alibi))
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"{fn}: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    for name, t in tensors[:3]:
        # the kernels read q/k/v rows as aligned vectors
        if t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must start 16-byte aligned")
    for name, t in [("block_table", block_table)] + list(ints):
        if t.dtype != torch.int32:
            raise ValueError(f"{fn}: {name} must be int32, got {t.dtype}")


def unit_pages(block_size: int) -> int:
    """Pages of the decode kernel's unit of work: the 32 // BS pages that
    fill one 32-key ring stage when a page holds fewer than 32 rows, else
    one page (of ceil(BS / 32) stages)."""
    return TILE // block_size if block_size < TILE else 1


def paged_split_plan(R: int, K: int, D: int, itemsize: int, block_size: int,
                     max_blocks: int, sms: int) -> Tuple[int, int]:
    """(splits, stages) of the decode kernel's launch, from host integers
    only: the dense decode kernel's rule (``decode_split_plan``; PERF.md,
    its findings) over the units of a full table (max_blocks pages):
    ``splits`` blocks a (row, KV head), the largest power of two up to 8
    whose grid stays within 4 blocks an SM and whose splits each keep a
    unit; ``stages`` K / V tile pairs of 32 keys in a 32 KB ring (at least
    two)."""
    units = -(-max_blocks // unit_pages(block_size))
    return split_count(units, R * K, sms), ring_stages(D, itemsize)


def split_pages(length: int, block_size: int, max_blocks: int,
                splits: int) -> List[Tuple[int, int]]:
    """The pages ``[p0, p1)`` each split of a row of ``length`` keys reads
    (``csrc/paged_attention.cu::split_pages``, the same integer arithmetic
    on the device): the row's units (``unit_pages`` pages each, the last
    cut at the row's last page) in runs of ceil(units / splits), split i
    taking the i-th run. Lengths past the table are clamped to it."""
    length = max(0, min(length, max_blocks * block_size))
    up = unit_pages(block_size)
    npages = -(-length // block_size)
    units = -(-npages // up)
    per = -(-units // splits)
    out = []
    for i in range(splits):
        u0 = min(i * per, units)
        out.append((min(u0 * up, npages),
                    min(min(u0 + per, units) * up, npages)))
    return out


def paged_prefill_plan(B: int, C: int, N: int, block_size: int,
                       sms: int) -> Tuple[int, int]:
    """(rows, box_rows) of the 16-bit prefill kernel's launch, from host
    integers only. ``rows``: the chunk queries of a work tile (one block,
    one query head): 128, one consumer warpgroup on each half over every
    key tile, unless twice the 128-row tiles fit one wave of one block an
    SM; then 64, both warpgroups on the same rows, each on every other key
    tile, merged in a fixed order (llama-7b's serve chunk: B 1, C 256, 32
    heads, 64 tiles of 128 rows on 132 SMs, runs 128 blocks of 64 rows).
    ``box_rows``: the rows of one TMA box of a page, gcd(BS, 128) when BS
    is a multiple of 8 (whole 8-row swizzle atoms), else 0 (pages copied by
    the producer warp's plain loads)."""
    tiles = B * N * -(-C // 128)
    rows = 64 if 2 * tiles <= sms else 128
    box_rows = math.gcd(block_size, PREFILL_KEYS) \
        if block_size % 8 == 0 else 0
    return rows, box_rows


def prefill_keys(start: int, n_valid: int, C: int, rows: int, q_tile: int,
                 table_keys: int) -> int:
    """The key columns ``[0, kend)`` the prefill kernel's q tile ``q_tile``
    (chunk queries ``q_tile * rows ..`` of a row at ``start`` with
    ``n_valid`` valid queries) walks: up to its last valid query's
    position, within the table's ``table_keys`` columns; 0 for a tile of
    pads (``csrc/paged_attention.cu::tile_keys``, the same integer
    arithmetic on the device)."""
    c0 = q_tile * rows
    last = min(c0 + rows, max(n_valid, 0), C) - 1
    return 0 if last < c0 else max(0, min(start + last + 1, table_keys))


def _decode_fn():
    return registry.function(
        "paged_attention", "dstt_paged_decode",
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _prefill_fn():
    return registry.function(
        "paged_attention", "dstt_paged_prefill",
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def prefill_kernel(dtype: torch.dtype, head_dim: int) -> str:
    """The CUDA kernel ``paged_prefill_attention`` runs for q's dtype and
    head_dim: the tensor-core route for 16-bit D in PREFILL_TC_DIMS, else
    the CUDA-core one."""
    return ("paged_prefill_tma_kernel"
            if dtype in (torch.bfloat16, torch.float16)
            and head_dim in PREFILL_TC_DIMS else "paged_prefill_kernel")


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_table: torch.Tensor,
                           lengths: torch.Tensor,
                           alibi: Optional[torch.Tensor] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """q (R, N, D) — one new token per row; pools (NUM_BLOCKS, BLOCK, K, D);
    block_table (R, MAXB) int32 (unfilled entries 0 = scratch); lengths
    (R,) int32 — valid keys per row INCLUDING the just-written token (0 =>
    inactive row, output zeros). Returns (R, N, D)."""
    if q.device.type == "cpu":
        return reference_paged_attention(
            q[:, None], k_pool, v_pool, block_table,
            (lengths.long() - 1)[:, None], alibi, scale)[:, 0]
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    R, N, D = q.shape
    if lengths.shape != (R,) or block_table.shape[0] != R:
        raise ValueError("paged_decode_attention: block_table (R, MAXB) and "
                         f"lengths (R,) must match q's R={R}")
    _check("paged_decode_attention", q, k_pool, v_pool, block_table, alibi,
           [("lengths", lengths)])
    NB, BS, K = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    MAXB = block_table.shape[1]
    splits, stages = paged_split_plan(R, K, D, q.element_size(), BS, MAXB,
                                      _sm_count(q.device.index))
    out = torch.empty_like(q)
    err = _decode_fn()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_table.data_ptr(), lengths.data_ptr(),
        alibi.data_ptr() if alibi is not None else None, out.data_ptr(),
        R, N, K, D, BS, MAXB, NB,
        float(scale if scale is not None else D ** -0.5), _DTYPES[q.dtype],
        splits, stages, torch.cuda.current_stream(q.device).cuda_stream)
    registry.check_launch("paged_decode_attention", err)
    return out


def paged_prefill_attention(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, block_table: torch.Tensor,
                            start: torch.Tensor,
                            alibi: Optional[torch.Tensor] = None,
                            scale: Optional[float] = None,
                            n_valid: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Chunked-prefill attention through the block table: q (B, C, N, D) —
    C contiguous queries per row at absolute positions ``start[b] + c``
    (the chunk's own keys must already be written into the pool). Queries
    ``c >= n_valid[b]`` (default: none) are chunk padding: they see no key
    and output zeros, and they do not widen the row's visible range.
    Returns (B, C, N, D)."""
    B, C, N, D = q.shape
    if n_valid is None:
        n_valid = torch.full((B,), C, dtype=torch.int32, device=q.device)
    if q.device.type == "cpu":
        offs = torch.arange(C, device=q.device)
        pos = torch.where(offs[None] < n_valid.long()[:, None],
                          start.long()[:, None] + offs[None],
                          torch.full((B, C), -1, device=q.device))
        return reference_paged_attention(q, k_pool, v_pool, block_table,
                                         pos, alibi, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention: unsupported device "
                         f"{q.device}")
    if start.shape != (B,) or n_valid.shape != (B,) \
            or block_table.shape[0] != B:
        raise ValueError("paged_prefill_attention: block_table (B, MAXB), "
                         f"start (B,) and n_valid (B,) must match q's B={B}")
    _check("paged_prefill_attention", q, k_pool, v_pool, block_table, alibi,
           [("start", start), ("n_valid", n_valid)])
    NB, BS, K = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    # read by the tensor-core route only
    rows, box_rows = paged_prefill_plan(B, C, N, BS,
                                        _sm_count(q.device.index))
    out = torch.empty_like(q)
    err = _prefill_fn()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_table.data_ptr(), start.data_ptr(), n_valid.data_ptr(),
        alibi.data_ptr() if alibi is not None else None, out.data_ptr(),
        B, C, N, K, D, BS, block_table.shape[1], NB,
        float(scale if scale is not None else D ** -0.5), _DTYPES[q.dtype],
        rows, box_rows, torch.cuda.current_stream(q.device).cuda_stream)
    registry.check_launch("paged_prefill_attention", err)
    return out
