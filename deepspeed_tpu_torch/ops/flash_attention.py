"""Flash-attention forward over dense q / k / v.

Counterpart of ``deepspeed_tpu/ops/flash_attention.py`` (forward only; the
backward belongs to the training slice). ``flash_attention`` launches the
CUDA kernel of ``csrc/flash_attention.cu`` on a CUDA tensor and runs its
plain version, ``reference_flash_attention``, on a CPU tensor.

Layouts are the JAX wrapper's: q (B, S, N, D), k / v (B, T, K, D) with
GQA read natively (query head n reads KV head n // (N // K)), mask (B, T)
key padding. The function is the Pallas KERNEL's (flash_attention.py:75-96),
not ``dot_product_attention``'s: query row i sees key column j when
``j <= i`` (causal, 0-based, not end-aligned), ``j < T`` and
``mask[b, j] != 0``; alibi adds ``slope[n] * j``; the softmax is fp32. The
two conventions agree when S == T (the cache-less forward); a static
prefill of S queries over a longer arena relies on the 0-based one. A row
with no visible key gives zeros and lse = -inf (the JAX kernel's output for
such a row is not meaningful; no caller builds one).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import registry

MAX_HEAD_DIM = 256

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def reference_flash_attention(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              mask: Optional[torch.Tensor] = None,
                              causal: bool = True,
                              scale: Optional[float] = None,
                              alibi: Optional[torch.Tensor] = None,
                              return_lse: bool = False):
    """Plain version, GQA-native, in fp32; returns o (B, S, N, D) in q's
    dtype, and with ``return_lse`` also lse (B, N, S) fp32."""
    B, S, N, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = N // K
    scale = D ** -0.5 if scale is None else scale
    s = torch.einsum("bskgd,btkd->bkgst", q.reshape(B, S, K, G, D).float(),
                     k.float()) * scale
    col = torch.arange(T, device=q.device)
    if alibi is not None:
        s = s + (alibi.float().reshape(K, G)[None, :, :, None, None]
                 * col.float())
    keep = torch.ones(1, S, T, dtype=torch.bool, device=q.device)
    if causal:
        keep = (col[None, :] <= torch.arange(S, device=q.device)[:, None]
                )[None]
    if mask is not None:
        keep = keep & (mask != 0)[:, None, :]
    keep = keep[:, None, None]                                # (B,1,1,S,T)
    s = torch.where(keep, s, torch.full_like(s, float("-inf")))
    lse = torch.logsumexp(s, dim=-1)                          # (B,K,G,S)
    # select, never multiply: an empty row's lse is -inf and its p is 0
    p = torch.where(keep, torch.exp(s - lse[..., None]),
                    torch.zeros_like(s))
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    o = o.reshape(B, S, N, D).to(q.dtype)
    if return_lse:
        return o, lse.reshape(B, N, S)
    return o


def _fn():
    fn = registry.library("flash_attention").dstt_flash_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None, causal: bool = True,
                    scale: Optional[float] = None,
                    alibi: Optional[torch.Tensor] = None,
                    return_lse: bool = False):
    """o = attention(q, k, v) as the module docstring defines it; q (B, S,
    N, D), k / v (B, T, K, D), mask (B, T) (any integer or bool dtype;
    converted to int32), alibi (N,) float32. Returns o (B, S, N, D), and
    with ``return_lse`` also lse (B, N, S) float32."""
    if q.device.type == "cpu":
        return reference_flash_attention(q, k, v, mask, causal, scale, alibi,
                                         return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention: q must be (B, S, N, D) and k / v "
                         f"both (B, T, K, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, N, D = q.shape
    T, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: k / v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if K == 0 or N % K != 0:
        raise ValueError(f"flash_attention: n_heads {N} must be a multiple "
                         f"of kv_heads {K}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {D} > {MAX_HEAD_DIM}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q/k/v must share one of float32, "
                         f"bfloat16, float16; got {q.dtype}/{k.dtype}/"
                         f"{v.dtype}")
    tensors = [("q", q), ("k", k), ("v", v)]
    if mask is not None:
        if mask.shape != (B, T):
            raise ValueError(f"flash_attention: mask must be ({B}, {T}), "
                             f"got {tuple(mask.shape)}")
        mask = mask.to(torch.int32).contiguous()
        tensors.append(("mask", mask))
    if alibi is not None:
        if alibi.shape != (N,) or alibi.dtype != torch.float32:
            raise ValueError(f"flash_attention: alibi must be ({N},) "
                             "float32")
        tensors.append(("alibi", alibi))
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    for name, t in tensors[:3]:
        # the kernels read k / v rows as aligned 16-byte vectors
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must start 16-byte "
                             "aligned")
    out = torch.empty_like(q)
    lse = (torch.empty(B, N, S, dtype=torch.float32, device=q.device)
           if return_lse else None)
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                mask.data_ptr() if mask is not None else None,
                alibi.data_ptr() if alibi is not None else None,
                out.data_ptr(), lse.data_ptr() if lse is not None else None,
                B, S, T, N, K, D, int(causal),
                float(scale if scale is not None else D ** -0.5),
                _DTYPES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    registry.check_launch("flash_attention", err)
    return (out, lse) if return_lse else out
