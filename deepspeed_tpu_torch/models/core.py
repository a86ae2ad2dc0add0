"""Model bundle and parameter helpers.

Counterpart of ``deepspeed_tpu/models/core.py``. Parameters are a nested
dict of tensors with the JAX package's tree layout (layer leaves stacked on a
leading layer axis), so the two packages' weights convert leaf for leaf
(``models/convert.py``). The logical-axis table of the JAX package drives
its sharding rules; the serving slice runs on one device and has none.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Optional, Tuple

import torch


@dataclasses.dataclass
class Model:
    """A model bundle: ``init(generator)`` -> params on the generator's
    device, its config, and for training ``loss_fn(params, batch)`` -> the
    scalar loss the engine differentiates, with ``eval_loss_fn`` its
    eval-mode variant (JAX ``core.Model``). ``streams_layers``: ``init``
    also takes ``sink=`` (where each layer of the stack goes as it is
    drawn, ``transformer.init_layer_params``) and ``device="meta"`` (shapes
    only), as parameter offload needs (JAX ``init_layer_block``)."""

    init: Callable[..., Any]
    config: Any = None
    name: str = "model"
    loss_fn: Optional[Callable[..., Any]] = None
    eval_loss_fn: Optional[Callable[..., Any]] = None
    streams_layers: bool = False


def tree_leaves(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif tree is not None:
        yield tree


def tree_items(tree: Any, prefix: Tuple[str, ...] = ()
               ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs in ``tree_leaves`` order; a path is the tuple of
    dict keys down to the leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, prefix + (k,))
    elif tree is not None:
        yield prefix, tree


def tree_get(tree: Any, path: Tuple[str, ...]) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def tree_set(tree: dict, path: Tuple[str, ...], value: Any) -> None:
    """Set the leaf at ``path``, making the dicts on the way."""
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


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
