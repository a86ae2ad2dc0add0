"""One-query (decode) attention over a dense KV cache.

Counterpart of ``deepspeed_tpu/ops/decode_attention.py``. ``decode_attention``
launches the CUDA kernel of ``csrc/decode_attention.cu`` on a CUDA tensor and
runs its plain version, ``reference_decode_attention``, on a CPU tensor.

q (B, N, D) is one new token per row; the caches are (B, T, K, D) and GQA is
read natively (query head n reads KV head n // (N // K)). ``valid`` (B, T)
marks the live cache slots: the engine's mask is causality and padding in
one. ``key_positions`` (B, T) are the keys' true positions for the alibi
bias (ragged batches; default: the column index). ``kv_len`` is an optional
upper bound on the live columns: every column at or past it counts as
invalid, so the function is ``valid & (col < kv_len)`` and the kernel reads
fewer bytes. A row with no live key gives zeros (the JAX oracle gives
uniform weights there; no caller builds such a row).

The kernel splits the columns below ``kv_len`` across the blocks of each
(row, KV head) and merges the splits in the same launch (a thread-block
cluster); ``decode_split_plan`` picks the split on the host.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional, Tuple

import torch

from . import registry

NEG_INF = -1e30
MAX_GROUP = 8        # query heads per KV head the kernel takes
MAX_HEAD_DIM = 256
TILE = 32            # keys of a ring stage (csrc/decode_attention.cu kTile)
MAX_SPLITS = 8       # blocks of a (row, KV head): a portable cluster
BLOCKS_PER_SM = 4    # the grid a split may grow to, in blocks an SM
RING_BYTES = 32 * 1024   # shared memory of a block's K / V ring

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def reference_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, valid: torch.Tensor,
                               alibi: Optional[torch.Tensor] = None,
                               scale: Optional[float] = None,
                               key_positions: Optional[torch.Tensor] = None,
                               kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain version: JAX ``reference_decode_attention`` (GQA-native, fp32
    scores and softmax), with q scaled in fp32 and empty rows zeroed."""
    B, N, D = q.shape
    T, K = k_cache.shape[1], k_cache.shape[2]
    G = N // K
    scale = D ** -0.5 if scale is None else scale
    q4 = (q.float() * scale).reshape(B, K, G, D)
    s = torch.einsum("bkgd,btkd->bkgt", q4, k_cache.float())
    if alibi is not None:
        kpos = (torch.arange(T, dtype=torch.float32, device=q.device)[None]
                if key_positions is None else key_positions.float())
        s = s + (alibi.float().reshape(K, G)[None, :, :, None]
                 * kpos[:, None, None, :])
    keep = valid != 0
    if kv_len is not None:
        keep = keep & (torch.arange(T, device=q.device) < kv_len)[None]
    s = torch.where(keep[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", p, v_cache.float())
    o = torch.where(keep.any(dim=-1)[:, None, None, None], o,
                    torch.zeros_like(o))
    return o.reshape(B, N, D).to(q.dtype)


def decode_split_plan(B: int, K: int, D: int, itemsize: int, kv_len: int,
                      sms: int) -> Tuple[int, int, int]:
    """(splits, chunk, stages) of the kernel's launch: the columns below
    ``kv_len`` go to ``splits`` blocks a (row, KV head), ``chunk`` columns
    each (split i takes [i * chunk, (i + 1) * chunk)). ``splits`` is the
    largest power of two up to MAX_SPLITS whose grid (B x K x splits
    blocks) stays within BLOCKS_PER_SM blocks an SM and whose splits each
    keep a tile; ``stages`` tiles of K and V fill RING_BYTES (at least
    two). Small rings and a grid of ~4 blocks an SM ran fastest on the
    H100 at llama-7b's decode shapes (PERF.md, the dense decode kernel's
    findings)."""
    tiles = -(-kv_len // TILE)
    splits = split_count(tiles, B * K, sms)
    chunk = TILE * max(1, -(-tiles // splits))
    return splits, chunk, ring_stages(D, itemsize)


def split_count(units: int, pairs: int, sms: int) -> int:
    """Blocks a (row, KV head) of a split-KV decode launch over ``pairs``
    (row, KV head) pairs whose rows hold at most ``units`` units of work:
    the largest power of two up to MAX_SPLITS whose grid stays within
    BLOCKS_PER_SM blocks an SM and whose splits each keep a unit."""
    splits = 1
    while (splits < MAX_SPLITS and 2 * splits <= units
           and 2 * splits * pairs <= BLOCKS_PER_SM * sms):
        splits *= 2
    return splits


def ring_stages(D: int, itemsize: int) -> int:
    """Stages of a split-KV decode ring: K / V tile pairs of TILE rows
    (each tile 128-byte aligned) that fill RING_BYTES, at least two."""
    stage = 2 * (-(-TILE * D * itemsize // 128) * 128)
    return max(2, min(8, RING_BYTES // stage))


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _fn():
    return registry.function(
        "decode_attention", "dstt_decode_attention",
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
        + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid: torch.Tensor,
                     alibi: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None,
                     key_positions: Optional[torch.Tensor] = None,
                     kv_len: Optional[int] = None) -> torch.Tensor:
    """q (B, N, D), caches (B, T, K, D), valid (B, T) (any integer or bool
    dtype; converted to int32), alibi (N,) float32, key_positions (B, T)
    (converted to float32), kv_len a host int. Returns (B, N, D)."""
    if q.device.type == "cpu":
        return reference_decode_attention(q, k_cache, v_cache, valid, alibi,
                                          scale, key_positions, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError("decode_attention: q must be (B, N, D) and the "
                         f"caches both (B, T, K, D); got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, N, D = q.shape
    T, K = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != B or k_cache.shape[3] != D:
        raise ValueError(f"decode_attention: caches {tuple(k_cache.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if K == 0 or N % K != 0 or N // K > MAX_GROUP:
        raise ValueError(f"decode_attention: n_heads {N} must be a multiple "
                         f"of kv_heads {K} with at most {MAX_GROUP} query "
                         "heads per KV head")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: head_dim {D} > {MAX_HEAD_DIM}")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError("decode_attention: q/k/v must share one of "
                         f"float32, bfloat16, float16; got {q.dtype}/"
                         f"{k_cache.dtype}/{v_cache.dtype}")
    if valid.shape != (B, T):
        raise ValueError(f"decode_attention: valid must be ({B}, {T}), got "
                         f"{tuple(valid.shape)}")
    valid = valid.to(torch.int32).contiguous()
    tensors = [("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
               ("valid", valid)]
    if key_positions is not None:
        if key_positions.shape != (B, T):
            raise ValueError(f"decode_attention: key_positions must be "
                             f"({B}, {T}), got {tuple(key_positions.shape)}")
        key_positions = key_positions.to(torch.float32).contiguous()
        tensors.append(("key_positions", key_positions))
    if alibi is not None:
        if alibi.shape != (N,) or alibi.dtype != torch.float32:
            raise ValueError(f"decode_attention: alibi must be ({N},) "
                             "float32")
        tensors.append(("alibi", alibi))
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
    for name, t in tensors[:3]:
        # the kernel reads q / k / v rows as aligned vectors
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must start 16-byte "
                             "aligned")
    kv_len = T if kv_len is None else max(0, min(int(kv_len), T))
    splits, chunk, stages = decode_split_plan(
        B, K, D, q.element_size(), kv_len, _sm_count(q.device.index))
    out = torch.empty_like(q)
    err = _fn()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                valid.data_ptr(),
                alibi.data_ptr() if alibi is not None else None,
                key_positions.data_ptr() if key_positions is not None
                else None,
                out.data_ptr(), B, T, N, K, D, kv_len,
                float(scale if scale is not None else D ** -0.5),
                _DTYPES[q.dtype], splits, chunk, stages,
                torch.cuda.current_stream(q.device).cuda_stream)
    registry.check_launch("decode_attention", err)
    return out
