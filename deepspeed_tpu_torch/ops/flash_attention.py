"""Flash attention over dense q / k / v: forward, and its backward under
autograd.

Counterpart of ``deepspeed_tpu/ops/flash_attention.py``. ``flash_attention``
launches the forward CUDA kernel of ``csrc/flash_attention.cu`` on a CUDA
tensor and runs its plain version, ``reference_flash_attention``, on a CPU
tensor. When autograd needs its gradient on a CUDA tensor, the forward also
writes lse and the backward is ``flash_attention_bwd``: one call into
``csrc/flash_attention_bwd.cu`` that computes delta = rowsum(dO * O), dq, dk
and dv (the JAX ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` with the delta JAX
computes outside them, ``flash_attention.py:271``); for 16-bit inputs with
head_dim in {16, 32, 64, 128} that is one fused pass on Hopper's wgmma and
TMA, else CUDA-core kernels. On a CPU tensor autograd differentiates the
plain forward natively; ``reference_flash_attention_bwd`` is the backward's
plain version (the FA2 recompute from lse, delta by ``attention_delta``).
The forward kernel takes head_dim up to 512 (the SD VAE mid block's single
head of 512); the backward up to 256, and a backward above that raises
ValueError.

Layouts are the JAX wrapper's: q (B, S, N, D), k / v (B, T, K, D) with
GQA read natively (query head n reads KV head n // (N // K); dk / dv sum
over the G query heads of a KV head, as the vjp of JAX's head repeat
does), mask (B, T) key padding. The function is the Pallas KERNEL's
(flash_attention.py:75-96), not ``dot_product_attention``'s: query row i
sees key column j when ``j <= i`` (causal, 0-based, not end-aligned),
``j < T`` and ``mask[b, j] != 0``; alibi adds ``slope[n] * j``; the softmax
is fp32 and ``scale`` multiplies q . k (JAX folds it into q, :185, :210).
The two conventions agree when S == T (the cache-less forward); a static
prefill of S queries over a longer arena relies on the 0-based one. A row
with no visible key gives zeros and lse = -inf (the JAX kernel's output for
such a row is not meaningful; no caller builds one).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import registry

MAX_HEAD_DIM = 512        # the forward kernel
MAX_BWD_HEAD_DIM = 256    # the backward kernels

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _scale(D: int, scale: Optional[float]) -> float:
    return float(D ** -0.5 if scale is None else scale)


def _scores(q, k, mask, causal, scale, alibi):
    """fp32 scores (B, K, G, S, T) and the visibility mask (B, 1, 1, S, T)."""
    B, S, N, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = N // K
    s = torch.einsum("bskgd,btkd->bkgst", q.reshape(B, S, K, G, D).float(),
                     k.float()) * _scale(D, scale)
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
    return s, keep[:, None, None]


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
    K = k.shape[2]
    s, keep = _scores(q, k, mask, causal, scale, alibi)
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


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, (B, S, N, D) -> (B, N, S)."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def _reference_bwd(q, k, v, do, lse, delta, mask, causal, scale, alibi,
                   magnitude: bool = False):
    B, S, N, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = N // K
    sc = _scale(D, scale)
    s, keep = _scores(q, k, mask, causal, scale, alibi)
    lse5 = lse.reshape(B, K, G, S)[..., None]
    # select, never multiply: invisible pairs (and rows whose lse is -inf)
    p = torch.where(keep, torch.exp(s - lse5), torch.zeros_like(s))
    do5 = do.reshape(B, S, K, G, D).float()
    dp = torch.einsum("bskgd,btkd->bkgst", do5, v.float())
    ds = p * (dp - delta.reshape(B, K, G, S)[..., None])
    kf, q5 = k.float(), q.reshape(B, S, K, G, D).float()
    if magnitude:
        ds, kf, q5, do5 = ds.abs(), kf.abs(), q5.abs(), do5.abs()
    dq = torch.einsum("bkgst,btkd->bskgd", ds, kf) * sc
    dk = torch.einsum("bkgst,bskgd->btkd", ds, q5) * sc
    dv = torch.einsum("bkgst,bskgd->btkd", p, do5)
    if magnitude:
        return dq.reshape(B, S, N, D), dk, dv
    return dq.reshape(B, S, N, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def reference_flash_attention_bwd(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, o: torch.Tensor,
                                  lse: torch.Tensor, do: torch.Tensor,
                                  mask: Optional[torch.Tensor] = None,
                                  causal: bool = True,
                                  scale: Optional[float] = None,
                                  alibi: Optional[torch.Tensor] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Plain version of ``flash_attention_bwd``: the FA2 recompute from
    the forward's lse (B, N, S), delta = rowsum(dO * O), fp32 arithmetic.
    Returns (dq, dk, dv) in q's / k's / v's dtypes."""
    return _reference_bwd(q, k, v, do, lse, attention_delta(o, do), mask,
                          causal, scale, alibi)


def flash_attention_bwd_magnitude(q, k, v, o, lse, do, mask=None,
                                  causal=True, scale=None, alibi=None):
    """fp32 (|dq|, |dk|, |dv|)-shaped sums of the terms' magnitudes:
    ``scale * |dS| |K|``, ``scale * |dS|^T |Q|`` and ``P^T |dO|``. The 16-bit
    kernels round P and dS once to the input type before their products, so
    their error against the plain version is at most that rounding times
    these sums; tolerances scale with them."""
    return _reference_bwd(q, k, v, do, lse, attention_delta(o, do), mask,
                          causal, scale, alibi, magnitude=True)


def _check(name: str, q, k, v, mask, alibi, max_d: int = MAX_HEAD_DIM):
    """Validate the operands every kernel of this module takes; returns the
    mask as contiguous int32 (or None)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: q must be (B, S, N, D) and k / v both "
                         f"(B, T, K, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, N, D = q.shape
    T, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"{name}: k / v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if K == 0 or N % K != 0:
        raise ValueError(f"{name}: n_heads {N} must be a multiple of "
                         f"kv_heads {K}")
    if D > max_d:
        raise ValueError(f"{name}: head_dim {D} > {max_d}"
                         + (" (the backward kernels take head_dim <= "
                            f"{MAX_BWD_HEAD_DIM})" if max_d < MAX_HEAD_DIM
                            else ""))
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q/k/v must share one of float32, "
                         f"bfloat16, float16; got {q.dtype}/{k.dtype}/"
                         f"{v.dtype}")
    tensors = [("q", q), ("k", k), ("v", v)]
    if mask is not None:
        if mask.shape != (B, T):
            raise ValueError(f"{name}: mask must be ({B}, {T}), got "
                             f"{tuple(mask.shape)}")
        mask = mask.to(torch.int32).contiguous()
        tensors.append(("mask", mask))
    if alibi is not None:
        if alibi.shape != (N,) or alibi.dtype != torch.float32:
            raise ValueError(f"{name}: alibi must be ({N},) float32")
        tensors.append(("alibi", alibi))
    for tname, t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name}: {tname} on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
    for tname, t in tensors[:3]:
        # the kernels read q / k / v rows as aligned 16-byte vectors
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {tname} must start 16-byte aligned")
    return mask


def _check_grad_operands(name: str, q, o, do, lse):
    B, S, N, _ = q.shape
    for tname, t in (("o", o), ("dout", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: {tname} must match q {tuple(q.shape)} "
                             f"{q.dtype}, got {tuple(t.shape)} {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {tname} must start 16-byte aligned")
    if (lse.shape != (B, N, S) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"{name}: lse must be ({B}, {N}, {S}) contiguous "
                         f"float32 on {q.device}")


def _fn(source: str, symbol: str, n_ptrs: int):
    fn = getattr(registry.library(source), symbol)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def _launch_fwd(q, k, v, mask, causal, scale, alibi, return_lse):
    B, S, N, D = q.shape
    T, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty(B, N, S, dtype=torch.float32, device=q.device)
           if return_lse else None)
    err = _fn("flash_attention", "dstt_flash_fwd", 7)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), _ptr(alibi),
        out.data_ptr(), _ptr(lse), B, S, T, N, K, D, int(causal),
        _scale(D, scale), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    registry.check_launch("flash_attention", err)
    return out, lse


def _bwd_workspace_floats(B: int, S: int, N: int, D: int) -> int:
    """fp32 scratch of one backward call, enough for either route of
    ``csrc/flash_attention_bwd.cu`` and of the block-sparse backward
    (``csrc/block_sparse_attention.cu``): the fused pass's dq accumulator
    (B, S, N, D) and its lse / delta tiles (B, N, ceil(S / 64), 2, 64), of
    which the CUDA-core kernels (fp32, other head_dims) use B N S for
    delta."""
    return B * S * N * D + B * N * -(-S // 64) * 128


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        causal: bool = True, scale: Optional[float] = None,
                        alibi: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention`` from its output o, its lse (B,
    N, S) fp32 and dout: one call into the backward's CUDA kernels on a CUDA
    tensor (delta included), the plain version on a CPU tensor. dk / dv sum
    over the query heads of each KV head."""
    if q.device.type == "cpu":
        return reference_flash_attention_bwd(q, k, v, o, lse, do, mask,
                                             causal, scale, alibi)
    mask = _check("flash_attention_bwd", q, k, v, mask, alibi,
                  MAX_BWD_HEAD_DIM)
    o, do = o.contiguous(), do.contiguous()
    _check_grad_operands("flash_attention_bwd", q, o, do, lse)
    B, S, N, D = q.shape
    T, K = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ws = torch.empty(_bwd_workspace_floats(B, S, N, D), dtype=torch.float32,
                     device=q.device)
    err = _fn("flash_attention_bwd", "dstt_flash_bwd", 12)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), _ptr(mask), _ptr(alibi),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ws.data_ptr(),
        B, S, T, N, K, D, int(causal), _scale(D, scale), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    registry.check_launch("flash_attention_bwd", err)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward kernel (with lse) and ``flash_attention_bwd`` under
    autograd, for CUDA tensors; mask and alibi get no gradient (alibi slopes
    are constants, JAX returns zeros for them)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, scale, alibi):
        o, lse = _launch_fwd(q, k, v, mask, causal, scale, alibi, True)
        ctx.save_for_backward(q, k, v, o, lse, mask, alibi)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, mask, alibi = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         mask, ctx.causal, ctx.scale, alibi)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None, causal: bool = True,
                    scale: Optional[float] = None,
                    alibi: Optional[torch.Tensor] = None,
                    return_lse: bool = False):
    """o = attention(q, k, v) as the module docstring defines it; q (B, S,
    N, D), k / v (B, T, K, D), mask (B, T) (any integer or bool dtype;
    converted to int32), alibi (N,) float32. Returns o (B, S, N, D), and
    with ``return_lse`` also lse (B, N, S) float32. Differentiable in q, k
    and v (``return_lse`` output excepted)."""
    if q.device.type == "cpu":
        return reference_flash_attention(q, k, v, mask, causal, scale, alibi,
                                         return_lse)
    mask = _check("flash_attention", q, k, v, mask, alibi)
    if (not return_lse and torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return _FlashAttention.apply(q, k, v, mask, causal, scale, alibi)
    out, lse = _launch_fwd(q, k, v, mask, causal, scale, alibi, return_lse)
    return (out, lse) if return_lse else out
