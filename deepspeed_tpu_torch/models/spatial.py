"""Spatial (diffusers-family) model blocks: the UNet / VAE consumer of the
spatial ops.

Counterpart of ``deepspeed_tpu/models/spatial.py``, with the same names and
the same NHWC layout (conv weights HWIO, linear weights (in, out)):

  * ``resnet_block``    GroupNorm -> silu -> conv3x3, twice, + skip (1x1
    ``shortcut`` conv when given): diffusers ResnetBlock2D
  * ``attention_block`` GroupNorm -> q, k, v over the flattened H*W tokens
    -> single-head non-causal attention (head_dim = C) -> proj + residual
  * ``mid_block``       resnet -> attention -> resnet (UNet / VAE mid block)

Routing is by the tensor's device: on a CUDA tensor ``group_norm`` launches
the GroupNorm kernel and the attention the flash forward; on a CPU tensor
both run their plain versions. ``plain=True`` runs the plain versions on
any device (JAX's ``use_kernel=False``, whose attention is
``dot_product_attention``). ``conv2d`` is ``F.conv2d`` on a channels-last
view, library work as ``lax.conv`` is in JAX.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Union

import torch
import torch.nn.functional as F

from ..ops.spatial import (diffusers_attention, fused_group_norm,
                           reference_group_norm)
from .transformer import dot_product_attention


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int, eps: float = 1e-6,
               plain: bool = False) -> torch.Tensor:
    """(B, H, W, C) GroupNorm over the (B, H*W, C) token layout."""
    B, H, W, C = x.shape
    fn = reference_group_norm if plain else fused_group_norm
    return fn(x.reshape(B, H * W, C), scale, bias, groups,
              eps=eps).reshape(B, H, W, C)


def _same_pads(size: int, k: int, stride: int):
    """XLA's "SAME" padding of one spatial dim: (low, high)."""
    total = max((math.ceil(size / stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: int = 1, padding: str = "SAME") -> torch.Tensor:
    """NHWC conv; w: (kh, kw, Cin, Cout); padding "SAME" (XLA's split:
    the odd pixel goes high) or "VALID"."""
    kh, kw = w.shape[0], w.shape[1]
    if padding == "SAME":
        (hl, hh), (wl, wh) = (_same_pads(x.shape[1], kh, stride),
                              _same_pads(x.shape[2], kw, stride))
    elif padding == "VALID":
        hl = hh = wl = wh = 0
    else:
        raise ValueError(f"conv2d: padding must be 'SAME' or 'VALID', got "
                         f"{padding!r}")
    if hl != hh or wl != wh:
        x = F.pad(x, (0, 0, wl, wh, hl, hh))
        hl = wl = 0
    # NCHW views of channels-last memory: no copy of the activation
    weight = w.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
    out = F.conv2d(x.permute(0, 3, 1, 2), weight, stride=stride,
                   padding=(hl, wl)).permute(0, 2, 3, 1)
    if b is not None:
        out = out + b
    return out


def resnet_block(x: torch.Tensor, p: Dict[str, Any], groups: int = 8,
                 plain: bool = False) -> torch.Tensor:
    """diffusers ResnetBlock2D: GN -> silu -> conv, GN -> silu -> conv, +
    skip (1x1-conv'd when the block has a ``shortcut``)."""
    h = group_norm(x, p["norm1"]["scale"], p["norm1"]["bias"], groups,
                   plain=plain)
    h = conv2d(F.silu(h), p["conv1"]["w"], p["conv1"]["b"])
    h = group_norm(h, p["norm2"]["scale"], p["norm2"]["bias"], groups,
                   plain=plain)
    h = conv2d(F.silu(h), p["conv2"]["w"], p["conv2"]["b"])
    skip = x
    if "shortcut" in p:
        skip = conv2d(x, p["shortcut"]["w"], p["shortcut"]["b"])
    return skip + h


def attention_block(x: torch.Tensor, p: Dict[str, Any], groups: int = 8,
                    plain: bool = False) -> torch.Tensor:
    """diffusers AttentionBlock: GN -> single-head attention over the H*W
    tokens -> proj, + residual (the VAE mid-block attention)."""
    B, H, W, C = x.shape
    h = group_norm(x, p["norm"]["scale"], p["norm"]["bias"], groups,
                   plain=plain)
    tokens = h.reshape(B, H * W, C)
    q, k, v = ((tokens @ p[n]["w"] + p[n]["b"]).reshape(B, H * W, 1, C)
               for n in ("q", "k", "v"))
    if plain:
        attn = dot_product_attention(q, k, v, None, causal=False)
    else:
        attn = diffusers_attention(q, k, v)
    out = attn.reshape(B, H * W, C) @ p["proj"]["w"] + p["proj"]["b"]
    return x + out.reshape(B, H, W, C)


def mid_block(x: torch.Tensor, p: Dict[str, Any], groups: int = 8,
              plain: bool = False) -> torch.Tensor:
    """UNet / VAE mid block: resnet -> attention -> resnet."""
    x = resnet_block(x, p["resnet1"], groups, plain)
    x = attention_block(x, p["attn"], groups, plain)
    return resnet_block(x, p["resnet2"], groups, plain)


def init_mid_block(seed_or_generator: Union[int, torch.Generator],
                   channels: int, k: int = 3, device=None,
                   dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Random mid block as JAX's ``init_mid_block`` draws it (weights
    N(0, 0.1^2), zero biases, unit norm scales; conv weights (kh, kw, Cin,
    Cout)), from a ``torch.Generator`` (an int seeds one on the CPU) on its
    own device, then moved to ``device`` (default: the GPU, which must
    exist) in ``dtype``. The values differ
    from JAX's; the parity tests carry JAX's weights across instead."""
    from ..inference.engine import resolve_device

    dev = resolve_device(device)
    gen = (seed_or_generator if isinstance(seed_or_generator, torch.Generator)
           else torch.Generator().manual_seed(int(seed_or_generator)))
    C, std = channels, 0.1

    def put(t):
        return t.to(device=dev, dtype=dtype)

    def normal(shape):
        return put(torch.randn(shape, generator=gen, device=gen.device)
                   * std)

    def conv(kh):
        return {"w": normal((kh, kh, C, C)), "b": put(torch.zeros(C))}

    def lin():
        return {"w": normal((C, C)), "b": put(torch.zeros(C))}

    def norm():
        return {"scale": put(torch.ones(C)), "bias": put(torch.zeros(C))}

    def resnet():
        return {"norm1": norm(), "conv1": conv(k), "norm2": norm(),
                "conv2": conv(k)}

    return {"resnet1": resnet(),
            "attn": {"norm": norm(), "q": lin(), "k": lin(), "v": lin(),
                     "proj": lin()},
            "resnet2": resnet()}
