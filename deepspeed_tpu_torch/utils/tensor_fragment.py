"""Whole leaves of the params, grads and optimizer state under ZeRO.

Counterpart of ``deepspeed_tpu/utils/tensor_fragment.py``
(``safe_get_full_fp32_param`` :31, ``safe_get_full_param`` :41,
``safe_get_full_optimizer_state`` :46, ``safe_get_full_grad`` :62). A rank
holds only its range of a partitioned buffer, so each call gathers the
buffer from every rank (a collective: every rank calls it) and returns the
leaf at ``path`` ('/'-joined keys, e.g. ``"layers/attn/wq"``) as numpy.
Under optimizer offload the state comes from the host tier's CPU tensors
or the NVMe tier's files, moved to the device the group reduces; under
parameter offload from the executor's blocks (world 1).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.core import tree_get


def _leaf(tree, path: str) -> np.ndarray:
    t = tree_get(tree, tuple(path.split("/"))).detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _state(engine, name: str) -> Optional[torch.Tensor]:
    """The rank's shard of the optimizer buffer ``name`` (master, exp_avg,
    exp_avg_sq) on the shard's device, wherever the tier keeps it."""
    st = engine.opt_state
    if st.exp_avg is None and st.offload is not None:
        buf = st.offload.read_state(st.n)[name]
    else:
        buf = getattr(st, name)
    return None if buf is None else buf.to(engine.zero.shard.device)


def _offloaded(engine, kind: str, path: str) -> np.ndarray:
    """A whole leaf of a parameter-offload engine (the stack's from the
    host or its files)."""
    t = engine._param_offload.leaf(kind, tuple(path.split("/")))
    return t.detach().float().cpu().numpy()


def safe_get_full_fp32_param(engine, path: str) -> np.ndarray:
    """The fp32 master of a param (the param widened when there is no
    master)."""
    if engine._param_offload is not None:
        return _offloaded(engine, "master", path)
    master = _state(engine, "master")
    if master is None:
        return _leaf(engine.params, path).astype(np.float32)
    return _leaf(engine.zero.full_tree(master), path)


def safe_get_full_param(engine, path: str) -> np.ndarray:
    """The param in the compute dtype (bf16 widened to fp32)."""
    return _leaf(engine.params, path)


def safe_get_full_optimizer_state(engine, path: str, state_name: str
                                  ) -> Optional[np.ndarray]:
    """Adam's first ('exp_avg' / 'mu') or second ('exp_avg_sq' / 'nu')
    moment of a param; None for another name."""
    name = {"exp_avg": "exp_avg", "mu": "exp_avg", "exp_avg_sq":
            "exp_avg_sq", "nu": "exp_avg_sq"}.get(state_name)
    if name is None:
        return None
    if engine._param_offload is not None:
        return _offloaded(engine, {"exp_avg": "m", "exp_avg_sq": "v"}[name],
                          path)
    return _leaf(engine.zero.full_tree(_state(engine, name)), path)


def safe_get_full_grad(engine, path: str) -> Optional[np.ndarray]:
    """The grads accumulated since the last step (between ``backward`` and
    ``step``; None outside), averaged over the ranks: JAX's staged grads,
    the sum over micro-batches of the grads of ``loss * scale / gas``."""
    if engine._staged_count == 0:
        return None
    zero = engine.zero
    if zero.acc is not None:
        shard = zero.acc
    else:
        full = (engine._grad_acc if engine._grad_acc is not None
                else zero.grad_whole).float().clone()
        shard = zero.reduce_grads(full)
    return _leaf(zero.full_tree(shard), path)
