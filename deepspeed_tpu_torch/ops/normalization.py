"""Fused LayerNorm / RMSNorm, forward and backward.

Counterpart of ``deepspeed_tpu/ops/normalization.py``. ``fused_layer_norm``
runs the CUDA kernel of ``csrc/layer_norm.cu`` on a CUDA tensor and its plain
version, ``reference_layer_norm``, on a CPU tensor. Under autograd on a CUDA
tensor the forward is that kernel and the backward is ``layer_norm_bwd``,
plain torch transcribing JAX ``_fln_bwd`` (``normalization.py:89-113``),
which JAX too computes in jnp outside Pallas. On a CPU tensor autograd
differentiates the plain forward natively.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import registry

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


def _fn():
    fn = registry.library("layer_norm").dstt_layer_norm_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
            bias: Optional[torch.Tensor], eps: float,
            rms: bool) -> torch.Tensor:
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
    ptrs = [t.data_ptr() for t in (x, scale, bias, y) if t is not None]
    vec = int(H % (16 // x.element_size()) == 0
              and all(p % 16 == 0 for p in ptrs))
    err = _fn()(x.data_ptr(), scale.data_ptr(),
                bias.data_ptr() if bias is not None else None, y.data_ptr(),
                rows, H, float(eps), int(rms),
                _DTYPES[x.dtype], vec,
                torch.cuda.current_stream(x.device).cuda_stream)
    registry.check_launch("fused_layer_norm", err)
    return y
