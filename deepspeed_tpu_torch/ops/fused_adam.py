"""Fused Adam / AdamW over flat buffers.

Counterpart of ``deepspeed_tpu/ops/fused_adam.py``. ``fused_adam_flat``
launches the CUDA kernel of ``csrc/fused_adam.cu`` on CUDA tensors and runs
its plain version, ``reference_adam_flat``, on CPU tensors. It keeps the JAX
signature and semantics (``fused_adam.py:29-86``) but updates ``params``,
``exp_avg`` and ``exp_avg_sq`` in place (JAX aliases them through
``input_output_aliases``) and returns them. Beyond JAX's arguments it takes
what the optimizer needs so that one launch updates a whole model and the
host never waits on the card:

* ``param_copy``: a bf16 / fp16 buffer that receives the updated params
  (the model's working copy beside the fp32 master);
* ``grad_scale``: a one-element fp32 device tensor multiplying the
  gradient (the clip coefficient, and the fp16 loss unscale);
* ``skip``: a one-element bool device tensor; when set, nothing is written
  (the fp16 overflow skip).

``step`` is the 1-based count the bias correction uses; it and ``lr`` are
host numbers.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import registry

_GRAD_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_COPY_DTYPES = {torch.bfloat16: 1, torch.float16: 2}


def reference_adam_flat(params: torch.Tensor, grads: torch.Tensor,
                        exp_avg: torch.Tensor, exp_avg_sq: torch.Tensor,
                        step: int, lr: float = 1e-3, beta1: float = 0.9,
                        beta2: float = 0.999, eps: float = 1e-8,
                        weight_decay: float = 0.0,
                        bias_correction: bool = True,
                        adam_w_mode: bool = True,
                        param_copy: Optional[torch.Tensor] = None,
                        grad_scale: Optional[torch.Tensor] = None,
                        skip: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version, in place: JAX ``reference_adam_flat`` plus the
    ``param_copy`` / ``grad_scale`` / ``skip`` operands."""
    g = grads.float()
    if grad_scale is not None:
        g = g * grad_scale.float()
    p = params.float()
    if weight_decay != 0.0 and not adam_w_mode:
        g = g + weight_decay * p
    m = beta1 * exp_avg + (1 - beta1) * g
    v = beta2 * exp_avg_sq + (1 - beta2) * g * g
    if bias_correction:
        update = (m / (1 - beta1 ** step)) / (
            torch.sqrt(v / (1 - beta2 ** step)) + eps)
    else:
        update = m / (torch.sqrt(v) + eps)
    if weight_decay != 0.0 and adam_w_mode:
        update = update + weight_decay * p
    p = p - lr * update
    outs = [(params, p), (exp_avg, m), (exp_avg_sq, v)]
    if param_copy is not None:
        outs.append((param_copy, p))
    for dst, new in outs:
        if skip is not None:      # skipped: every buffer keeps its value
            new = torch.where(skip.reshape(()), dst.float(), new)
        dst.copy_(new)
    return params, exp_avg, exp_avg_sq


_last_route = None


def vector_route(*operands: Optional[torch.Tensor]) -> bool:
    """Whether the kernel takes 4-element vectors: every buffer aligned to
    them (16 bytes of fp32, 8 of a 16-bit type); else the scalar route."""
    return all(t.data_ptr() % (4 * t.element_size()) == 0
               for t in operands if t is not None)


def last_route() -> Optional[str]:
    """The route of the last kernel launch: "vector" or "scalar" (None
    before any)."""
    return _last_route


def _fn():
    fn = registry.library("fused_adam").dstt_fused_adam
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int64]
                   + [ctypes.c_float] * 9 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def fused_adam_flat(params: torch.Tensor, grads: torch.Tensor,
                    exp_avg: torch.Tensor, exp_avg_sq: torch.Tensor,
                    step: int, lr: float = 1e-3, beta1: float = 0.9,
                    beta2: float = 0.999, eps: float = 1e-8,
                    weight_decay: float = 0.0, bias_correction: bool = True,
                    adam_w_mode: bool = True,
                    param_copy: Optional[torch.Tensor] = None,
                    grad_scale: Optional[torch.Tensor] = None,
                    skip: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Adam step on flat buffers, in place: params / exp_avg /
    exp_avg_sq (n,) fp32, grads (n,) fp32 / bf16 / fp16. Returns (params,
    exp_avg, exp_avg_sq)."""
    if params.device.type == "cpu":
        return reference_adam_flat(params, grads, exp_avg, exp_avg_sq, step,
                                   lr, beta1, beta2, eps, weight_decay,
                                   bias_correction, adam_w_mode, param_copy,
                                   grad_scale, skip)
    if params.device.type != "cuda":
        raise ValueError(f"fused_adam_flat: unsupported device "
                         f"{params.device}")
    n = params.numel()
    for name, t in (("params", params), ("exp_avg", exp_avg),
                    ("exp_avg_sq", exp_avg_sq)):
        if t.dtype != torch.float32 or t.shape != (n,):
            raise ValueError(f"fused_adam_flat: {name} must be ({n},) "
                             f"float32, got {tuple(t.shape)} {t.dtype}")
    if grads.dtype not in _GRAD_DTYPES or grads.shape != (n,):
        raise ValueError(f"fused_adam_flat: grads must be ({n},) float32, "
                         f"bfloat16 or float16, got {tuple(grads.shape)} "
                         f"{grads.dtype}")
    if param_copy is not None and (param_copy.dtype not in _COPY_DTYPES
                                   or param_copy.shape != (n,)):
        raise ValueError(f"fused_adam_flat: param_copy must be ({n},) "
                         "bfloat16 or float16")
    if grad_scale is not None and (grad_scale.numel() != 1
                                   or grad_scale.dtype != torch.float32):
        raise ValueError("fused_adam_flat: grad_scale must be one float32")
    if skip is not None and (skip.numel() != 1 or skip.dtype != torch.bool):
        raise ValueError("fused_adam_flat: skip must be one bool")
    tensors = [t for t in (params, grads, exp_avg, exp_avg_sq, param_copy,
                           grad_scale, skip) if t is not None]
    for t in tensors:
        if t.device != params.device or not t.is_contiguous():
            raise ValueError("fused_adam_flat: every operand must be "
                             f"contiguous on {params.device}")
    global _last_route
    vec = int(vector_route(params, grads, exp_avg, exp_avg_sq, param_copy))
    err = _fn()(params.data_ptr(), grads.data_ptr(), exp_avg.data_ptr(),
                exp_avg_sq.data_ptr(),
                param_copy.data_ptr() if param_copy is not None else None,
                n, float(lr), float(beta1), float(1 - beta1), float(beta2),
                float(1 - beta2), float(eps), float(weight_decay),
                float(1 - beta1 ** step) if bias_correction else 1.0,
                float(1 - beta2 ** step) if bias_correction else 1.0,
                int(adam_w_mode),
                grad_scale.data_ptr() if grad_scale is not None else None,
                skip.data_ptr() if skip is not None else None,
                _GRAD_DTYPES[grads.dtype],
                _COPY_DTYPES.get(param_copy.dtype, 1)
                if param_copy is not None else 1,
                vec, torch.cuda.current_stream(params.device).cuda_stream)
    registry.check_launch("fused_adam", err)
    _last_route = "vector" if vec else "scalar"
    return params, exp_avg, exp_avg_sq
