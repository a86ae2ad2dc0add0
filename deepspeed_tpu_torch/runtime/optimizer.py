"""The mixed-precision Adam / AdamW / LAMB optimizer over one flat buffer.

Counterpart of ``deepspeed_tpu/runtime/optimizer.py``: ``build_optimizer``
turns the config's ``optimizer`` section into a ``MixedPrecisionOptimizer``
with optax's semantics (JAX ``build_optax_transform`` :161-171), and
``apply`` is one step of it:

* the global grad norm in fp32, and clipping by
  ``min(max_norm / (norm + 1e-6), 1)`` (JAX :48-65);
* an fp32 master copy of bf16 / fp16 params (JAX :187-246);
* Adam with eps outside ``sqrt(v_hat)``, bias correction at the
  incremented count, and the lr of the schedule at the count before it;
  ``adamw`` decays every leaf (optax's mask is None), ``adam`` with weight
  decay adds ``wd * p`` to the gradient, ``fusedadam`` defaults to
  ``adam_w_mode=True``;
* an fp16 overflow skips the update, and the skipped step does not advance
  the count the schedule and the bias correction read (optax's inner count
  reverts), while the outer count does.

The port keeps state in place where JAX returns a new tree: ``init`` lays
every param out in ONE flat buffer of the compute dtype and hands back the
params as views of it (``state.params``), with a flat grad buffer whose
views are the params' ``.grad`` (autograd accumulates into it in place).
Master weights and both moments are flat fp32 buffers, so one launch of the
fused Adam kernel (``ops/fused_adam.py``) updates the whole model and also
writes the 16-bit working copy; the clip coefficient and the fp16 unscale
reach it as a device scalar and the overflow as a device flag, so the host
never waits on the card. The host learns whether an fp16 step was skipped
at the next step, from a copy of the flag that has long landed by then.

``lamb`` follows ``optax.lamb`` as the JAX engine builds it (JAX
:172-173): the Adam update above (bias-corrected, eps default 1e-8), plus
``wd * p`` on every leaf, then a trust ratio ``||p|| / ||u||`` per leaf
(per stacked leaf: all layers' ``wq`` are one leaf), set to 1 where either
norm is 0 and not clamped, and ``p -= lr * ratio * u``; clipping, the fp16
skip and the two counts as for Adam. One launch of the LAMB phase-1 kernel
(``ops/fused_lamb.py``) covers the whole model, over a block plan whose
blocks never straddle a leaf; phase 2 is one in-place torch op per leaf.

The other optimizer types of the JAX package (onebitlamb, adagrad, sgd,
lion and the onebit / zero-one families) raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from ..config.config import Config
from ..models.core import tree_leaves, tree_map
from ..ops.fused_adam import fused_adam_flat, reference_adam_flat
from ..ops.fused_lamb import LambSegments, lamb_step
from ..utils.logging import logger
from .lr_schedules import as_schedule_fn, build_lr_schedule

_LOW = (torch.bfloat16, torch.float16)
_PORTED = ("adam", "adamw", "fusedadam", "lamb")


class StepStats(NamedTuple):
    grad_norm: torch.Tensor       # () fp32, of the unscaled, unclipped grads
    skipped: torch.Tensor         # () bool: the update was skipped
    lr: float                     # the schedule at the outer count


def flat_views(flat: torch.Tensor, like: Any) -> Any:
    """The tree of ``like`` as views of consecutive slices of ``flat``."""
    offset = 0

    def view(t: torch.Tensor) -> torch.Tensor:
        nonlocal offset
        n = t.numel()
        out = flat[offset:offset + n].view(t.shape)
        offset += n
        return out

    return tree_map(view, like)


@dataclasses.dataclass
class OptimizerState:
    """Flat buffers: ``param_flat`` / ``grad_flat`` (n,) of the compute
    dtype, whose views are ``params`` / ``grads``; ``master`` (n,) fp32
    when the params are 16-bit; the Adam moments (n,) fp32; for LAMB the
    update buffer (n,) fp32 and the leaves' block plan. ``count``: steps
    attempted (JAX's outer count); ``inner_count``: steps applied."""

    params: Any
    param_flat: torch.Tensor
    grads: Any
    grad_flat: torch.Tensor
    master: Optional[torch.Tensor]
    exp_avg: torch.Tensor
    exp_avg_sq: torch.Tensor
    count: int = 0
    inner_count: int = 0
    pending_skip: Optional[Tuple[torch.Tensor, Any]] = None
    lamb_update: Optional[torch.Tensor] = None
    segments: Optional[LambSegments] = None

    @property
    def n(self) -> int:
        return self.param_flat.numel()


class MixedPrecisionOptimizer:
    """Adam / AdamW, or LAMB with ``lamb``, with fp32 master weights,
    global-norm clipping and the fp16 skip (see the module docstring).
    ``plain`` runs the kernels' plain versions on any device: the reference
    the kernels are held against."""

    def __init__(self, lr_schedule: Any = 1e-3, grad_clip: float = 0.0,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, adam_w_mode: bool = True,
                 keep_master_weights: bool = True, plain: bool = False,
                 lamb: bool = False):
        self.lr_schedule: Callable = as_schedule_fn(lr_schedule)
        self.grad_clip = grad_clip
        self.betas = (float(betas[0]), float(betas[1]))
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)
        self.adam_w_mode = bool(adam_w_mode)
        self.keep_master_weights = keep_master_weights
        self.plain = plain
        self.lamb = lamb

    def init(self, params: Any) -> OptimizerState:
        """Copy ``params`` (one floating dtype, one device) into a flat
        buffer; the returned state's ``params`` are views of it, leaves that
        require grad, each with its ``.grad`` a view of the zeroed flat grad
        buffer."""
        leaves = list(tree_leaves(params))
        if not leaves:
            raise ValueError("no parameters to optimize")
        dtype, dev = leaves[0].dtype, leaves[0].device
        for t in leaves:
            if t.dtype != dtype or t.device != dev:
                raise ValueError("every parameter must share one floating "
                                 f"dtype and device, got {t.dtype} on "
                                 f"{t.device} beside {dtype} on {dev}")
        if not dtype.is_floating_point:
            raise ValueError(f"parameters must be floating, got {dtype}")
        n = sum(t.numel() for t in leaves)
        param_flat = torch.empty(n, dtype=dtype, device=dev)
        grad_flat = torch.zeros(n, dtype=dtype, device=dev)
        views = flat_views(param_flat, params)
        grads = flat_views(grad_flat, params)
        with torch.no_grad():
            for view, src, g in zip(tree_leaves(views), leaves,
                                    tree_leaves(grads)):
                view.copy_(src)
                view.requires_grad_(True)
                view.grad = g
        master = (param_flat.float() if self.keep_master_weights
                  and dtype in _LOW else None)
        lamb = {}
        if self.lamb:
            lamb = dict(
                lamb_update=torch.zeros(n, dtype=torch.float32, device=dev),
                segments=LambSegments.from_sizes([t.numel()
                                                  for t in leaves]))
        return OptimizerState(
            params=views, param_flat=param_flat, grads=grads,
            grad_flat=grad_flat, master=master,
            exp_avg=torch.zeros(n, dtype=torch.float32, device=dev),
            exp_avg_sq=torch.zeros(n, dtype=torch.float32, device=dev),
            **lamb)

    @staticmethod
    def _drain(state: OptimizerState) -> None:
        """Fold the previous step's overflow flag into ``inner_count``."""
        if state.pending_skip is None:
            return
        flag, event = state.pending_skip
        if event is not None:
            event.synchronize()
        if not bool(flag):
            state.inner_count += 1
        state.pending_skip = None

    def skipped_steps(self, state: OptimizerState) -> int:
        self._drain(state)
        return state.count - state.inner_count

    @torch.no_grad()
    def apply(self, state: OptimizerState,
              grads: Optional[torch.Tensor] = None,
              skip: Optional[torch.Tensor] = None,
              grad_scale: Optional[torch.Tensor] = None,
              overflow_check: bool = False) -> StepStats:
        """One step, in place. ``grads``: flat (n,) in any float dtype
        (default ``state.grad_flat``), already averaged over micro-batches;
        ``grad_scale``: a device scalar multiplying them first (the fp16
        unscale); ``skip``: a device bool, set when the update must not
        land; ``overflow_check``: also skip when any grad is inf or NaN
        (read off the norm, which is then not finite)."""
        grads = state.grad_flat if grads is None else grads
        if grads.shape != (state.n,):
            raise ValueError(f"grads must be flat ({state.n},), got "
                             f"{tuple(grads.shape)}")
        self._drain(state)
        norm = torch.linalg.vector_norm(grads, dtype=torch.float32)
        scale = grad_scale
        if scale is not None:
            norm = norm * scale
        if overflow_check:
            overflow = ~torch.isfinite(norm)
            skip = overflow if skip is None else skip.reshape(()) | overflow
        if self.grad_clip and self.grad_clip > 0:
            coef = torch.clamp(self.grad_clip / (norm + 1e-6), max=1.0)
            scale = coef if scale is None else scale * coef
        target = state.master if state.master is not None else state.param_flat
        if target.dtype != torch.float32:
            raise ValueError("Adam and LAMB keep fp32 params: 16-bit params "
                             "need keep_master_weights")
        kw = dict(lr=float(self.lr_schedule(state.inner_count)),
                  beta1=self.betas[0], beta2=self.betas[1], eps=self.eps,
                  weight_decay=self.weight_decay, bias_correction=True,
                  param_copy=(state.param_flat if state.master is not None
                              else None),
                  grad_scale=(scale.reshape(1).float() if scale is not None
                              else None),
                  skip=skip.reshape(1) if skip is not None else None)
        if self.lamb:
            # optax.lamb: per-leaf trust ratio, no clamp
            lamb_step(target, grads, state.exp_avg, state.exp_avg_sq,
                      state.lamb_update, state.segments,
                      state.inner_count + 1, max_coeff=float("inf"),
                      min_coeff=0.0, plain=self.plain, **kw)
        else:
            adam = reference_adam_flat if self.plain else fused_adam_flat
            adam(target, grads, state.exp_avg, state.exp_avg_sq,
                 state.inner_count + 1, adam_w_mode=self.adam_w_mode, **kw)
        lr = float(self.lr_schedule(state.count))
        state.count += 1
        if skip is None:
            state.inner_count += 1
            skipped = torch.zeros((), dtype=torch.bool, device=grads.device)
        else:
            skipped = skip.reshape(())
            flag = torch.empty((), dtype=torch.bool, pin_memory=skip.is_cuda)
            flag.copy_(skipped, non_blocking=True)
            event = None
            if skip.is_cuda:
                event = torch.cuda.Event()
                event.record()
            state.pending_skip = (flag, event)
        return StepStats(grad_norm=norm, skipped=skipped, lr=lr)


def build_optimizer(config: Config,
                    lr_schedule: Any = None) -> MixedPrecisionOptimizer:
    """Config ``optimizer`` section -> ``MixedPrecisionOptimizer``."""
    if lr_schedule is None and config.scheduler is not None:
        lr_schedule = build_lr_schedule(config.scheduler.type,
                                        config.scheduler.params)
    params = dict(config.optimizer.params)
    if lr_schedule is None:
        lr_schedule = float(params.get("lr", 1e-3))
    name = config.optimizer.type.lower()
    if name == "cpuadam":
        raise ValueError(
            "optimizer 'cpuadam' is the host-offloaded Adam: it needs "
            "zero_optimization.offload_optimizer.device='cpu'")
    if name not in _PORTED:
        raise NotImplementedError(
            f"optimizer '{config.optimizer.type}' is not ported to "
            f"deepspeed_tpu_torch yet (ported: {', '.join(_PORTED)})")
    adam_w_mode = (True if name == "adamw"
                   else params.get("adam_w_mode", name != "adam"))
    logger.info(f"Built optimizer '{config.optimizer.type}' "
                f"(grad_clip={config.gradient_clipping})")
    # lamb: DeepSpeed's FusedLamb keys max_coeff / min_coeff /
    # bias_correction are ignored, as the JAX engine's optax.lamb ignores
    # them (no clamp, bias correction always on)
    return MixedPrecisionOptimizer(
        lr_schedule, grad_clip=config.gradient_clipping,
        betas=tuple(params.get("betas", (0.9, 0.999))),
        eps=params.get("eps", 1e-8),
        weight_decay=params.get("weight_decay", 0.0),
        adam_w_mode=adam_w_mode, lamb=name == "lamb")
