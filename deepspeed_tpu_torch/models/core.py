"""Model bundle and parameter helpers.

Counterpart of ``deepspeed_tpu/models/core.py``. Parameters are a nested
dict of tensors with the JAX package's tree layout (layer leaves stacked on a
leading layer axis), so the two packages' weights convert leaf for leaf
(``models/convert.py``). The logical-axis table of the JAX package drives
its sharding rules; the serving slice runs on one device and has none.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Optional

import torch


@dataclasses.dataclass
class Model:
    """A model bundle: ``init(generator)`` -> params on the generator's
    device, its config, and for training ``loss_fn(params, batch)`` -> the
    scalar loss the engine differentiates, with ``eval_loss_fn`` its
    eval-mode variant (JAX ``core.Model``)."""

    init: Callable[..., Any]
    config: Any = None
    name: str = "model"
    loss_fn: Optional[Callable[..., Any]] = None
    eval_loss_fn: Optional[Callable[..., Any]] = None


def tree_leaves(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif tree is not None:
        yield tree


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def param_count(params: Any) -> int:
    return sum(int(p.numel()) for p in tree_leaves(params))


def tree_bytes(params: Any) -> int:
    return sum(int(p.numel()) * p.element_size() for p in tree_leaves(params))


QUANTIZED_KEYS = ("q8", "q4")


def is_quantized(node: Any) -> bool:
    """A weight-only-quantized site: ``{"q8"|"q4": ints, "s": fp32}``."""
    return isinstance(node, dict) and any(k in node for k in QUANTIZED_KEYS)


def cast_floating(tree: Any, dtype: torch.dtype) -> Any:
    """Cast floating leaves to ``dtype`` (precision plumbing). A quantized
    site is left as it is: its scales stay fp32."""
    if is_quantized(tree):
        return tree
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree
