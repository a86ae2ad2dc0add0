"""Weights between the JAX package and the port.

Both packages keep one parameter tree layout: a nested dict whose layer
leaves are stacked on a leading layer axis (JAX ``transformer.init_params``
:142, ``init_layer_params`` :182). The JAX tree travels as numpy arrays (the
port never imports JAX), so conversion is a leaf-for-leaf copy.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .core import is_quantized, tree_map


def _to_tensor(a: Any, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16: the ml_dtypes array widens exactly to fp32
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(np_params: Dict[str, Any], cfg=None, device="cpu",
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """The JAX param pytree (numpy leaves, layer axis first) -> the port's
    params on ``device``; floating leaves cast to ``dtype`` (default
    ``cfg.dtype``; with neither, each leaf keeps its numpy dtype). Quantized
    sites (``{"q8"|"q4", "s"}``) come over as they are: int8 / uint8
    values, fp32 scales. A tree with no ``cfg`` (the spatial mid block's:
    nested dicts, no layer axis) converts the same way."""
    if dtype is None and cfg is not None:
        dtype = cfg.dtype

    def walk(node):
        if is_quantized(node):
            return {k: _to_tensor(v, device, None) for k, v in node.items()}
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _to_tensor(node, device, dtype)

    return walk(np_params)


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of ``params_from_jax``: the port's params -> numpy leaves
    (bfloat16 leaves widen exactly to float32, which JAX takes and casts;
    quantized values and scales keep their dtypes)."""
    def leaf(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return tree_map(leaf, params)
