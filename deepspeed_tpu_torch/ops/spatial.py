"""Spatial (diffusers) ops: GroupNorm over NHWC tokens and the spatial
attention.

Counterpart of ``deepspeed_tpu/ops/spatial.py``. ``fused_group_norm``
launches the CUDA kernels of ``csrc/group_norm.cu`` on a CUDA tensor and
runs its plain version, ``reference_group_norm`` (two passes in fp32, JAX
:121-131), on a CPU tensor. The kernel follows the plain version's exact
statistics, not the TPU kernel's one-pass variance (``spatial.py:65``).
``diffusers_attention`` has no kernel of its own: it is the port's flash
forward with ``causal=False`` over the flattened spatial tokens, self or
cross attention (T != S).
"""

from __future__ import annotations

import ctypes

import torch

from . import registry
from .flash_attention import flash_attention

LANES = 128            # the most groups, as in JAX
STATS_ROWS = 64        # rows of one statistics unit (RC in the kernel)
APPLY_ROWS = 64        # rows a normalising block writes (RA)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check(x: torch.Tensor, num_groups: int) -> None:
    if x.dim() != 3:
        raise ValueError(f"fused_group_norm: x must be (B, HW, C), got "
                         f"{tuple(x.shape)}")
    C = x.shape[2]
    if C % num_groups:
        raise ValueError(f"C={C} not divisible by num_groups={num_groups}")
    if num_groups > LANES:
        raise ValueError(f"num_groups must be <= {LANES}")


def reference_group_norm(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, num_groups: int,
                         eps: float = 1e-5) -> torch.Tensor:
    """Plain version (torch GroupNorm semantics, NHWC tokens): mean, then
    the mean of squared deviations, in fp32; output in x's dtype."""
    B, HW, C = x.shape
    cg = C // num_groups
    xg = x.float().reshape(B, HW, num_groups, cg)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((xg - mean) / torch.sqrt(var + eps)).reshape(B, HW, C)
    return (y * scale.float() + bias.float()).to(x.dtype)


def fused_group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over spatial tokens: x (B, HW, C), per-channel affine
    ``scale`` / ``bias`` (C,) in fp32 or x's dtype. Statistics per (batch,
    group) across all HW positions and the group's C / num_groups
    channels."""
    _check(x, num_groups)
    if x.device.type == "cpu":
        return reference_group_norm(x, scale, bias, num_groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_group_norm: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"fused_group_norm: dtype {x.dtype} not supported "
                         "(float32, bfloat16, float16)")
    B, HW, C = x.shape
    for name, t in (("scale", scale), ("bias", bias)):
        if (t.shape != (C,) or t.device != x.device
                or t.dtype not in (x.dtype, torch.float32)):
            raise ValueError(f"fused_group_norm: {name} must be ({C},) "
                             f"float32 or {x.dtype} on {x.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if scale.dtype != bias.dtype:
        raise ValueError("fused_group_norm: scale and bias must share a "
                         "dtype")
    for name, t in (("x", x), ("scale", scale), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"fused_group_norm: {name} must be contiguous")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    # the widest access (<= 16 bytes of x) that divides a group and that
    # every pointer is aligned to
    cg = C // num_groups
    vec = 16 // x.element_size()
    while vec > 1 and (cg % vec or any(
            t.data_ptr() % (vec * t.element_size())
            for t in (x, y, scale, bias))):
        vec //= 2
    chunks = -(-HW // STATS_ROWS)
    part = torch.empty(B, num_groups, chunks, 2, dtype=torch.float32,
                       device=x.device)
    fn = registry.library("group_norm").dstt_group_norm_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
        [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
             part.data_ptr(), B, HW, C, num_groups, STATS_ROWS, APPLY_ROWS,
             float(eps), _DTYPES[x.dtype], vec,
             int(scale.dtype == torch.float32 and x.dtype != torch.float32),
             torch.cuda.current_stream(x.device).cuda_stream)
    registry.check_launch("fused_group_norm", err)
    return y


def diffusers_attention(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Spatial self / cross attention: q (B, HWq, N, D), k / v (B, HWk, N,
    D) -> (B, HWq, N, D). The non-causal flash forward over the flattened
    spatial tokens."""
    return flash_attention(q, k, v, causal=False)
