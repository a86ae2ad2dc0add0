"""Per-group symmetric quantization (int8 / int4) and fake quantization.

Counterpart of ``deepspeed_tpu/ops/quantization.py``. ``quantize_symmetric``
launches the CUDA kernel of ``csrc/quantization.cu`` on a CUDA tensor and
runs its plain version, ``reference_quantize_symmetric``, on a CPU tensor.
``dequantize_symmetric`` is plain torch, as JAX leaves it to jnp.
``fake_quantize`` quantizes and dequantizes under autograd with a
straight-through gradient (JAX's ``custom_vjp``, :76-102).

The convention is JAX's eager ``reference_quantize_symmetric``: both
divisions (absmax / qmax and x / scale) are IEEE divisions, and rounding is
half to even, so q and the scales equal it bit for bit. Under ``jit`` XLA
turns the division by the constant qmax into a product with its reciprocal,
which moves some scales by one ulp; the port does not follow that rewrite.
Inputs are taken to be finite.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import registry

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check(x: torch.Tensor, bits: int, group_size: int) -> int:
    """JAX's checks (bits 4 or 8, a flat x of whole groups); returns the
    group count."""
    if bits not in (4, 8):
        raise ValueError(f"quantize_symmetric: bits must be 4 or 8, got "
                         f"{bits}")
    if x.dim() != 1:
        raise ValueError(f"quantize_symmetric: x must be flat (n,), got "
                         f"{tuple(x.shape)}")
    n = x.shape[0]
    if group_size <= 0 or n % group_size:
        raise ValueError(f"quantize_symmetric: {n} % {group_size} != 0")
    return n // group_size


def reference_quantize_symmetric(x: torch.Tensor, bits: int = 8,
                                 group_size: int = 128
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (int8 q (n,), fp32 scales (groups,)). qmax is a full
    tensor, not a Python number, so that no backend turns the division
    into a product with its reciprocal."""
    groups = _check(x, bits, group_size)
    qmax = float(2 ** (bits - 1) - 1)
    x2 = x.reshape(groups, group_size).float()
    absmax = x2.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax == 0, torch.ones_like(absmax),
                        absmax / torch.full_like(absmax, qmax))
    q = torch.clamp(torch.round(x2 / scale), -qmax - 1, qmax)
    return q.to(torch.int8).reshape(-1), scale[:, 0]


def quantize_symmetric(x: torch.Tensor, bits: int = 8, group_size: int = 128
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-group symmetric quantization of a flat x (n,), n % group_size ==
    0, any float dtype: (int8 q (n,), fp32 scales (groups,)). int4 values
    stay unpacked in int8, in [-8, 7]."""
    groups = _check(x, bits, group_size)
    if x.device.type == "cpu":
        return reference_quantize_symmetric(x, bits, group_size)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_symmetric: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"quantize_symmetric: dtype {x.dtype} not supported "
                         "(float32, bfloat16, float16)")
    if not x.is_contiguous():
        raise ValueError("quantize_symmetric: x must be contiguous")
    q = torch.empty(x.shape[0], dtype=torch.int8, device=x.device)
    scales = torch.empty(groups, dtype=torch.float32, device=x.device)
    if groups == 0:
        return q, scales
    vec = int(group_size % (16 // x.element_size()) == 0
              and x.data_ptr() % 16 == 0)
    fn = registry.library("quantization").dstt_quantize_symmetric
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] + \
        [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), q.data_ptr(), scales.data_ptr(), groups,
             group_size, bits, _DTYPES[x.dtype], vec,
             torch.cuda.current_stream(x.device).cuda_stream)
    registry.check_launch("quantize_symmetric", err)
    return q, scales


def dequantize_symmetric(q: torch.Tensor, scales: torch.Tensor,
                         group_size: int = 128) -> torch.Tensor:
    """fp32 (n,) = q * its group's scale."""
    groups = q.shape[-1] // group_size
    return (q.reshape(groups, group_size).float()
            * scales[:, None]).reshape(-1)


class _FakeQuantize(torch.autograd.Function):
    """Quantize, dequantize, cast back to x's dtype; the backward passes the
    gradient straight through."""

    @staticmethod
    def forward(ctx, x, bits, group_size):
        flat = x.reshape(-1)
        pad = (-flat.shape[0]) % group_size
        if pad:
            flat = torch.nn.functional.pad(flat, (0, pad))
        q, s = quantize_symmetric(flat.contiguous(), bits, group_size)
        deq = dequantize_symmetric(q, s, group_size)
        if pad:
            deq = deq[:x.numel()]
        return deq.reshape(x.shape).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def fake_quantize(x: torch.Tensor, bits: int = 8,
                  group_size: int = 128) -> torch.Tensor:
    """Quantize-dequantize roundtrip (MoQ ``fake_quantizer.cu``) of x of any
    shape, padded with zeros to whole groups, with a straight-through
    gradient estimator."""
    return _FakeQuantize.apply(x, bits, group_size)
