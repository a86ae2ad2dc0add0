"""Fused LayerNorm / RMSNorm, forward and backward.

Counterpart of ``deepspeed_tpu/ops/normalization.py``. ``fused_layer_norm``
runs a CUDA kernel of ``csrc/layer_norm.cu`` on a CUDA tensor and its plain
version, ``reference_layer_norm``, on a CPU tensor. On the card the route is
by shape and alignment: rows whose H is a multiple of 16 bytes, up to
``LN_MAX_ROW_VECTORS`` 16-byte vectors, with x, scale, bias and y 16-byte
aligned run ``ln_rows_kernel`` (the row in registers, read once) under the
launch shape ``ln_plan`` picks from shapes alone; every other call runs
``ln_scalar_kernel``. Under autograd on a CUDA tensor the
forward is that kernel and the backward is ``layer_norm_bwd``, plain torch
transcribing JAX ``_fln_bwd`` (``normalization.py:89-113``), which JAX too
computes in jnp outside Pallas. On a CPU tensor autograd differentiates the
plain forward natively.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import registry
from .decode_attention import _sm_count

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def reference_layer_norm(x: torch.Tensor, scale: torch.Tensor,
                         bias: Optional[torch.Tensor], eps: float = 1e-5,
                         rms: bool = False) -> torch.Tensor:
    """Plain version: fp32 statistics, output in ``x``'s dtype; ``rms``
    ignores ``bias`` (as the JAX kernel does)."""
    x32 = x.float()
    if rms:
        var = (x32 * x32).mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(var + eps) * scale.float()
    else:
        mean = x32.mean(-1, keepdim=True)
        xc = x32 - mean
        var = (xc * xc).mean(-1, keepdim=True)
        y = xc * torch.rsqrt(var + eps) * scale.float()
        if bias is not None:
            y = y + bias.float()
    return y.to(x.dtype)


# ln_rows_kernel's limits (csrc/layer_norm.cu, trouble spot 1): the 16-byte
# vectors of x a thread holds (a template argument), the threads a block may
# have at each (its launch bounds), so the vectors a row may have
LN_BLOCK_THREADS = {1: 512, 2: 512, 4: 512, 8: 256}
LN_VECTORS = tuple(LN_BLOCK_THREADS)
LN_MAX_ROW_VECTORS = max(v * n for v, n in LN_BLOCK_THREADS.items())
# the launch shapes that timed best on the H100 (PERF.md, PR 18): at most
# LN_BLOCKS_PER_SM blocks an SM; up to that many rows, a block a row on at
# most LN_FEW_THREADS threads; past it, LN_MANY_VECTORS vectors a thread in
# blocks of at least LN_MANY_THREADS threads that walk the rows
LN_BLOCKS_PER_SM = 4
LN_FEW_THREADS = 256
LN_MANY_VECTORS = 4
LN_MANY_THREADS = 128
SCALAR_THREADS = 256


class LnPlan(NamedTuple):
    """Launch shape of ``dstt_layer_norm_fwd``: ``vectors`` 16-byte vectors
    of x a thread holds (0: ``ln_scalar_kernel``, a block of
    ``threads_per_row`` threads a row), ``threads_per_row`` threads a row,
    ``rows_per_block`` row groups a block, ``blocks`` blocks; group g of
    block b takes rows ``b * rows_per_block + g``, then every ``blocks *
    rows_per_block`` more."""
    vectors: int
    threads_per_row: int
    rows_per_block: int
    blocks: int


def _group_threads(nv: int, vectors: int) -> int:
    """Threads of a row group that holds ``nv`` vectors at most ``vectors``
    a thread: whole warps."""
    return 32 * -(-nv // (32 * vectors))


def ln_plan(rows: int, H: int, itemsize: int, sms: int) -> LnPlan:
    """Launch shape of the norm of ``rows`` rows of ``H`` elements of
    ``itemsize`` bytes on a card of ``sms`` SMs, from host integers only
    (alignment is the wrapper's to check). H not a multiple of 16 bytes, or
    more than ``LN_MAX_ROW_VECTORS`` 16-byte vectors a row (H 16384 in 16
    bits, 8192 in fp32): the scalar kernel, a block a row. Else, with nv
    vectors a row and ``LN_BLOCKS_PER_SM`` blocks an SM at most:

    * few rows (up to that many blocks; llama-7b's decode step and serve's
      256-row prefill chunk): a block a row, on a group of whole warps of at
      most ``LN_FEW_THREADS`` threads with the fewest vectors a thread that
      cover the row (256 threads of 2 vectors at H 4096 in 16 bits);
    * many rows: ``LN_MANY_VECTORS`` vectors a thread (a group of 128
      threads at H 4096 in 16 bits, 64 at 2048), as many groups a block as
      make ``LN_MANY_THREADS`` threads, and as many blocks as rows allow up
      to the cap, each group walking its rows.

    A thread's template width is the smallest of ``LN_VECTORS`` that covers
    its share of the row."""
    V = 16 // itemsize
    nv = H // V if H % V == 0 else 0
    if nv == 0 or nv > LN_MAX_ROW_VECTORS:
        return LnPlan(0, SCALAR_THREADS, 1, rows)
    cap = LN_BLOCKS_PER_SM * sms
    if rows <= cap:
        vectors = next(v for v in LN_VECTORS
                       if _group_threads(nv, v) <= LN_FEW_THREADS)
        return LnPlan(vectors, _group_threads(nv, vectors), 1, rows)
    tpr = _group_threads(nv, LN_MANY_VECTORS)
    vectors = next(v for v in LN_VECTORS if v * tpr >= nv)
    rpb = max(1, LN_MANY_THREADS // tpr)
    return LnPlan(vectors, tpr, rpb, min(-(-rows // rpb), cap))


def plan_rows(plan: LnPlan, rows: int):
    """The rows each (block, group) of ``plan`` normalises, in its order
    (the kernel's walk: ``csrc/layer_norm.cu`` ln_rows_kernel)."""
    step = plan.blocks * plan.rows_per_block
    return {(b, g): list(range(b * plan.rows_per_block + g, rows, step))
            for b in range(plan.blocks)
            for g in range(plan.rows_per_block)}


def _fn():
    return registry.function(
        "layer_norm", "dstt_layer_norm_fwd",
        [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int,
                                 ctypes.c_float] + [ctypes.c_int] * 6
        + [ctypes.c_void_p])


def layer_norm_bwd(x: torch.Tensor, scale: torch.Tensor,
                   bias: Optional[torch.Tensor], g: torch.Tensor,
                   eps: float = 1e-5, rms: bool = False):
    """(dx, dscale, dbias) of ``norm(x) * scale (+ bias)`` for the output
    gradient ``g``, in fp32 and cast to each input's dtype; ``dbias`` is None
    without a bias or for RMSNorm (JAX ``_fln_bwd``)."""
    H = x.shape[-1]
    x32, g32, s32 = x.float(), g.float(), scale.float()
    gy = g32 * s32
    if rms:
        rstd = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
        xhat = x32 * rstd
        dx = rstd * (gy - xhat * (gy * xhat).mean(-1, keepdim=True))
        dbias = None
    else:
        xc = x32 - x32.mean(-1, keepdim=True)
        rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
        xhat = xc * rstd
        dx = rstd * (gy - gy.mean(-1, keepdim=True)
                     - xhat * (gy * xhat).mean(-1, keepdim=True))
        dbias = (g32.reshape(-1, H).sum(0).to(bias.dtype)
                 if bias is not None else None)
    dscale = (g32 * xhat).reshape(-1, H).sum(0).to(scale.dtype)
    return dx.to(x.dtype), dscale, dbias


class _FusedLayerNorm(torch.autograd.Function):
    """The forward kernel under autograd, with the plain backward."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, rms):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps, ctx.rms = eps, rms
        return _launch(x, scale, bias, eps, rms)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_bwd(x, scale, bias, g, ctx.eps,
                                           ctx.rms)
        return dx, dscale, dbias, None, None


def fused_layer_norm(x: torch.Tensor, scale: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, eps: float = 1e-5,
                     rms: bool = False) -> torch.Tensor:
    """y = norm(x) * scale (+ bias); x (..., H), scale/bias (H,). ``rms``
    selects RMSNorm (no mean subtraction, no bias). Differentiable in x,
    scale and bias."""
    if x.device.type == "cpu":
        return reference_layer_norm(x, scale, bias, eps, rms)
    if rms:
        bias = None
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, scale, bias)):
        return _FusedLayerNorm.apply(x, scale, bias, eps, rms)
    return _launch(x, scale, bias, eps, rms)


def _launch(x: torch.Tensor, scale: torch.Tensor,
            bias: Optional[torch.Tensor], eps: float, rms: bool,
            plan: Optional[LnPlan] = None) -> torch.Tensor:
    """One launch of the norm kernel under ``plan`` (default: ``ln_plan``,
    or the scalar kernel for an unaligned view); a test sets other grids to
    hold the bits, and a plan the kernel cannot run raises."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_layer_norm: unsupported device {x.device}")
    H = x.shape[-1]
    for name, t in (("scale", scale), ("bias", bias)):
        if t is None:
            continue
        if t.shape != (H,) or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(
                f"fused_layer_norm: {name} must be ({H},) {x.dtype} on "
                f"{x.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_layer_norm: {name} must be contiguous")
    if x.dtype not in _DTYPES:
        raise ValueError(f"fused_layer_norm: dtype {x.dtype} not supported "
                         "(float32, bfloat16, float16)")
    if not x.is_contiguous():
        raise ValueError("fused_layer_norm: x must be contiguous")
    y = torch.empty_like(x)
    rows = x.numel() // H if H else 0
    if rows == 0:
        return y
    if plan is None:
        ptrs = [t.data_ptr() for t in (x, scale, bias, y) if t is not None]
        plan = (ln_plan(rows, H, x.element_size(), _sm_count(x.device.index))
                if all(p % 16 == 0 for p in ptrs)
                else LnPlan(0, SCALAR_THREADS, 1, rows))
    err = _fn()(x.data_ptr(), scale.data_ptr(),
                bias.data_ptr() if bias is not None else None, y.data_ptr(),
                rows, H, float(eps), int(rms), _DTYPES[x.dtype], *plan,
                torch.cuda.current_stream(x.device).cuda_stream)
    registry.check_launch("fused_layer_norm", err)
    return y
