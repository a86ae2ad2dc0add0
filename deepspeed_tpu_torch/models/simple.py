"""Tiny fixture model for the engine's tests.

Counterpart of ``deepspeed_tpu/models/simple.py`` (``simple_model`` :14,
``random_batches`` :42), the model JAX's ZeRO tests train: a stack of
linear + ReLU layers and an MSE head, batch ``{"x": (B, H), "y": (B, 1)}``.
``init`` draws its own weights from the generator; to train from the JAX
init, pass its params (numpy leaves) as ``params``. ``random_batches``
draws the same kind of data with numpy from a seed (JAX draws it with
``jax.random``, so the values differ).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .convert import params_from_jax
from .core import Model


def simple_model(hidden_dim: int = 10, nlayers: int = 2,
                 params: Optional[Dict[str, Any]] = None,
                 dtype: torch.dtype = torch.float32) -> Model:
    """Linear stack + MSE head. ``params``: the JAX init as numpy leaves,
    which ``init`` then returns on the generator's device."""

    def init(generator: torch.Generator):
        dev = generator.device
        if params is not None:
            return params_from_jax(params, device=dev, dtype=dtype)
        out = {f"linear_{i}": {
            "w": torch.randn(hidden_dim, hidden_dim, generator=generator,
                             device=dev) * 0.1,
            "b": torch.zeros(hidden_dim, device=dev)}
            for i in range(nlayers)}
        out["head"] = {"w": torch.randn(hidden_dim, 1, generator=generator,
                                        device=dev) * 0.1,
                       "b": torch.zeros(1, device=dev)}
        return {k: {n: t.to(dtype) for n, t in v.items()}
                for k, v in out.items()}

    def apply(p, batch):
        h = batch["x"].to(dtype)
        for i in range(nlayers):
            h = torch.relu(h @ p[f"linear_{i}"]["w"] + p[f"linear_{i}"]["b"])
        return h @ p["head"]["w"] + p["head"]["b"]

    def loss_fn(p, batch):
        pred = apply(p, batch)
        return torch.mean(torch.square(pred.float() - batch["y"].float()))

    return Model(init=init, loss_fn=loss_fn, name="simple")


def random_batches(seed: int, n: int, batch_size: int,
                   hidden_dim: int = 10) -> List[Dict[str, np.ndarray]]:
    """Synthetic regression batches: y = x @ arange(H) / H + noise."""
    rng = np.random.default_rng(seed)
    w_true = (np.arange(hidden_dim, dtype=np.float32) / hidden_dim)[:, None]
    out = []
    for _ in range(n):
        x = rng.normal(size=(batch_size, hidden_dim)).astype(np.float32)
        y = x @ w_true + 0.01 * rng.normal(size=(batch_size, 1)).astype(
            np.float32)
        out.append({"x": x, "y": y})
    return out
