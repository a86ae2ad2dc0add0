"""The mixed-precision Adam / AdamW / LAMB optimizer over one flat buffer.

Counterpart of ``deepspeed_tpu/runtime/optimizer.py``: ``build_optimizer``
turns the config's ``optimizer`` section into a ``MixedPrecisionOptimizer``
with optax's semantics (JAX ``build_optax_transform`` :161-171), and
``apply`` is one step of it:

* the global grad norm (``grad_norm``: fp32, its squares summed in
  float64 on the CPU), and clipping by
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

Under ZeRO (``parallel/zero.py``) the fp32 master and the moments cover
only the rank's shard: ``init_shard`` builds them over the shard's
compute-dtype buffer, ``apply`` takes the shard's grads, and with
``partitioned`` the squared grad norm of the shard is all-reduced over the
data-parallel group before the square root (under expert parallelism at
stage 0, only the expert banks' part, over the expert-parallel group:
``expert_norm``), so every rank clips by the global norm and reads the
fp16 overflow off it (a rank whose grads are not finite makes the sum not
finite on every rank). LAMB's shard is made of
parts of leaves (``ZeroPartition.rank_segments``): its segments carry their
leaf's id, and phase 2 all-reduces the per-leaf sums of ||p||^2 and
||u||^2 before it takes each trust ratio, so every rank uses the ratio of
the whole leaf.

``zerooneadam`` (JAX ``zero_one_adam_transform`` :96-139) is its own flat
update, plain torch as in JAX (which has no kernel for it): momentum every
step, the variance only on ``zero_one_var_step``'s schedule and frozen
after ``var_freeze_step``, no bias correction, then ``p -= lr * u``.
``onebitadam`` and ``onebitlamb`` update as Adam and LAMB do; the three
differ from them in the engine's gradient exchange (``comm/compressed.py``).

With an offload tier (``runtime/offload.py``: host memory, ``runtime/swap``:
NVMe) the master and the moments live off the card; ``apply`` still takes
the norm, the clip coefficient and the fp16 overflow on the device, reads
them in one host sync, and the tier runs ``host_adam_flat`` (the plain
Adam's arithmetic without temporaries) over the shard in sub-groups on the
host (JAX ``engine.py:793-830``, ``:1135-1151``).

The other optimizer types of the JAX package (adagrad, sgd, lion) raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import comm
from ..config.config import Config
from ..models.core import tree_leaves, tree_map
from ..ops.fused_adam import fused_adam_flat, reference_adam_flat
from ..ops.fused_lamb import LambSegments, lamb_step
from ..utils.logging import logger
from .lr_schedules import as_schedule_fn, build_lr_schedule
from .offload import host_adam_flat

_LOW = (torch.bfloat16, torch.float16)
_PORTED = ("adam", "adamw", "fusedadam", "cpuadam", "lamb", "onebitadam",
           "onebitlamb", "zerooneadam")
ADAM_FAMILY = ("adam", "adamw", "fusedadam", "cpuadam")
ONEBIT = ("onebitadam", "onebitlamb", "zerooneadam")


class StepStats(NamedTuple):
    grad_norm: torch.Tensor       # () fp32, of the unscaled, unclipped grads
    skipped: torch.Tensor         # () bool: the update was skipped
    lr: float                     # the schedule at the outer count


def grad_norm(grads: torch.Tensor) -> torch.Tensor:
    """The 2-norm of flat grads, an fp32 scalar on their device. On the CPU
    the squares are summed in float64: torch's fp32 CPU norm sums in fp32
    (1e-5 relative off at 1e6 elements, 4e-4 at 1e7); on the card its tree
    reduction stays within a few fp32 roundings."""
    if grads.device.type == "cpu":
        return torch.linalg.vector_norm(grads, dtype=torch.float64).float()
    return torch.linalg.vector_norm(grads, dtype=torch.float32)


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
    """Flat buffers: ``shard_param`` (n,) of the compute dtype, the params
    the update writes (the whole model, or the rank's shard under ZeRO);
    ``master`` (n,) fp32 when the params are 16-bit; the Adam moments (n,)
    fp32; for LAMB the update buffer (n,) fp32 and the leaves' block plan.
    ``init`` also keeps the whole model's ``param_flat`` / ``grad_flat``
    (``shard_param`` is ``param_flat``), whose views are ``params`` /
    ``grads``. ``count``: steps attempted (JAX's outer count);
    ``inner_count``: steps applied. ``partitioned``: the grads ``apply``
    gets are the rank's shard, so the norm is all-reduced.
    ``expert_norm``: (start, group) when the grads from ``start`` on are a
    rank's expert banks held whole by each rank of its expert-data group
    (ZeRO stage 0 under expert parallelism): their squares are all-reduced
    over the expert-parallel ``group``, so each bank counts once.
    ``offload``: the tier that holds the state off the card (the
    host-memory tier's master and moments are CPU tensors here; the NVMe
    tier's are None, they live in its files)."""

    shard_param: torch.Tensor
    master: Optional[torch.Tensor]
    exp_avg: Optional[torch.Tensor]
    exp_avg_sq: Optional[torch.Tensor]
    params: Any = None
    param_flat: Optional[torch.Tensor] = None
    grads: Any = None
    grad_flat: Optional[torch.Tensor] = None
    partitioned: bool = False
    count: int = 0
    inner_count: int = 0
    pending_skip: Optional[Tuple[torch.Tensor, Any]] = None
    lamb_update: Optional[torch.Tensor] = None
    segments: Optional[LambSegments] = None
    offload: Any = None
    expert_norm: Optional[Tuple[int, Any]] = None

    @property
    def n(self) -> int:
        return self.shard_param.numel()


class MixedPrecisionOptimizer:
    """Adam / AdamW, LAMB with ``lamb``, or 0/1 Adam with ``zero_one`` (its
    ``var_freeze_step`` and ``var_update_scaler``), with fp32 master
    weights, global-norm clipping and the fp16 skip (see the module
    docstring). ``plain`` runs the kernels' plain versions on any device:
    the reference the kernels are held against."""

    def __init__(self, lr_schedule: Any = 1e-3, grad_clip: float = 0.0,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, adam_w_mode: bool = True,
                 keep_master_weights: bool = True, plain: bool = False,
                 lamb: bool = False,
                 zero_one: Optional[Tuple[int, int]] = None):
        self.lr_schedule: Callable = as_schedule_fn(lr_schedule)
        self.grad_clip = grad_clip
        self.betas = (float(betas[0]), float(betas[1]))
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)
        self.adam_w_mode = bool(adam_w_mode)
        self.keep_master_weights = keep_master_weights
        self.plain = plain
        self.lamb = lamb
        self.zero_one = zero_one

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
        state = self.init_shard(param_flat,
                                leaf_sizes=[t.numel() for t in leaves])
        state.params, state.param_flat = views, param_flat
        state.grads, state.grad_flat = grads, grad_flat
        return state

    def init_shard(self, shard_param: torch.Tensor, partitioned: bool = False,
                   leaf_sizes: Optional[List[int]] = None,
                   layout: Optional[Tuple[List[int], List[int], int]] = None,
                   offload: Any = None) -> OptimizerState:
        """The state over a flat compute-dtype buffer the update writes in
        place: the fp32 master (a copy of it, when it is 16-bit) and zeroed
        moments, or the ``offload`` tier's. LAMB needs the leaves the buffer
        holds: ``leaf_sizes`` when they are whole and in order, else
        ``layout`` = (sizes, leaf ids, number of leaves) of the runs that
        tile it (``ZeroPartition.rank_segments``)."""
        n, dev = shard_param.numel(), shard_param.device
        lamb = {}
        if self.lamb:
            if layout is not None:
                segments = LambSegments.from_layout(*layout)
            elif leaf_sizes is not None and not partitioned:
                segments = LambSegments.from_sizes(leaf_sizes)
            else:
                raise ValueError("LAMB needs the leaves of its buffer: "
                                 "leaf_sizes, or a layout when it is a "
                                 "partitioned shard")
            lamb = dict(
                lamb_update=torch.zeros(n, dtype=torch.float32, device=dev),
                segments=segments)
        if offload is not None:
            if self.lamb or self.zero_one:
                raise NotImplementedError(
                    "offload_optimizer with LAMB or the 1-bit optimizers: "
                    "the offload tiers run the Adam family only")
            return OptimizerState(
                shard_param=shard_param, master=offload.master,
                exp_avg=offload.exp_avg, exp_avg_sq=offload.exp_avg_sq,
                partitioned=partitioned, offload=offload)
        master = (shard_param.float() if self.keep_master_weights
                  and shard_param.dtype in _LOW else None)
        return OptimizerState(
            shard_param=shard_param, master=master,
            exp_avg=torch.zeros(n, dtype=torch.float32, device=dev),
            exp_avg_sq=torch.zeros(n, dtype=torch.float32, device=dev),
            partitioned=partitioned, **lamb)

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
        (default ``state.grad_flat``), already averaged over micro-batches
        and ranks;
        ``grad_scale``: a device scalar multiplying them first (the fp16
        unscale); ``skip``: a device bool, set when the update must not
        land; ``overflow_check``: also skip when any grad is inf or NaN
        (read off the norm, which is then not finite)."""
        grads = state.grad_flat if grads is None else grads
        if grads.shape != (state.n,):
            raise ValueError(f"grads must be flat ({state.n},), got "
                             f"{tuple(grads.shape)}")
        self._drain(state)
        if state.expert_norm is not None:
            at, group = state.expert_norm
            banks = comm.all_reduce(grad_norm(grads[at:]).square(),
                                    group=group, log_name="grad_norm")
            norm = (grad_norm(grads[:at]).square() + banks).sqrt()
        else:
            norm = grad_norm(grads)
        if state.partitioned:
            sq = comm.all_reduce(norm.square(), log_name="grad_norm")
            norm = sq.sqrt()
        scale = grad_scale
        if scale is not None:
            norm = norm * scale
        if overflow_check:
            overflow = ~torch.isfinite(norm)
            skip = overflow if skip is None else skip.reshape(()) | overflow
        if self.grad_clip and self.grad_clip > 0:
            coef = torch.clamp(self.grad_clip / (norm + 1e-6), max=1.0)
            scale = coef if scale is None else scale * coef
        if state.offload is not None:
            return self._apply_offload(state, grads, norm, scale, skip)
        target = state.master if state.master is not None \
            else state.shard_param
        if target.dtype != torch.float32:
            raise ValueError("Adam and LAMB keep fp32 params: 16-bit params "
                             "need keep_master_weights")
        kw = dict(lr=float(self.lr_schedule(state.inner_count)),
                  beta1=self.betas[0], beta2=self.betas[1], eps=self.eps,
                  weight_decay=self.weight_decay, bias_correction=True,
                  param_copy=(state.shard_param if state.master is not None
                              else None),
                  grad_scale=(scale.reshape(1).float() if scale is not None
                              else None),
                  skip=skip.reshape(1) if skip is not None else None)
        if self.lamb:
            # optax.lamb: per-leaf trust ratio, no clamp
            reduce = ((lambda t: comm.all_reduce(t, log_name="lamb_norms"))
                      if state.partitioned else None)
            lamb_step(target, grads, state.exp_avg, state.exp_avg_sq,
                      state.lamb_update, state.segments,
                      state.inner_count + 1, max_coeff=float("inf"),
                      min_coeff=0.0, plain=self.plain, reduce=reduce, **kw)
        elif self.zero_one:
            del kw["bias_correction"]
            zero_one_adam_flat(
                target, grads, state.exp_avg, state.exp_avg_sq,
                var_hit=zero_one_var_step(state.inner_count, *self.zero_one),
                **kw)
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

    def _apply_offload(self, state: OptimizerState, grads: torch.Tensor,
                       norm: torch.Tensor, scale: Optional[torch.Tensor],
                       skip: Optional[torch.Tensor]) -> StepStats:
        """The offload tiers' step: the clip / unscale coefficient and the
        skip flag cross to the host in one sync, then the tier updates the
        shard sub-group by sub-group with ``host_adam_flat`` on CPU
        tensors (skipped steps change nothing)."""
        vals = torch.zeros(2, dtype=torch.float32, device=grads.device)
        if scale is not None:
            vals[0] = scale.reshape(())
        if skip is not None:
            vals[1] = skip.reshape(())
        vals = vals.cpu()
        host_scale = vals[0:1].clone() if scale is not None else None
        skipped = bool(vals[1])
        lr = float(self.lr_schedule(state.inner_count))
        step = state.inner_count + 1
        kw = dict(lr=lr, beta1=self.betas[0], beta2=self.betas[1],
                  eps=self.eps, weight_decay=self.weight_decay,
                  bias_correction=True, adam_w_mode=self.adam_w_mode,
                  grad_scale=host_scale)

        def update(master, g, m, v, param_copy, scratch):
            host_adam_flat(master, g, m, v, step, scratch,
                           param_copy=param_copy, **kw)

        if not skipped:
            state.offload.step(state.shard_param, grads, update)
            state.inner_count += 1
        lr_outer = float(self.lr_schedule(state.count))
        state.count += 1
        return StepStats(grad_norm=norm,
                         skipped=torch.tensor(skipped, device=grads.device),
                         lr=lr_outer)


# ---------------------------------------------------------------------------
# 0/1 Adam (JAX runtime/optimizer.py:68-139)
# ---------------------------------------------------------------------------


def _zero_one_phase_table(scaler: int, max_phases: int = 40) -> np.ndarray:
    """Last variance-update step of each phase of 0/1 Adam's schedule
    (JAX ``_zero_one_phase_table``): phase k updates every 2^k steps, for
    ``scaler`` hits after phase k-1's last one."""
    last = [scaler]
    for k in range(1, max_phases):
        first = ((last[-1] // 2 ** k) + 1) * 2 ** k
        last.append(first + (scaler - 1) * 2 ** k)
    return np.asarray(last, np.int64)


def zero_one_var_step(count: int, var_update_scaler: int,
                      var_freeze_step: int) -> bool:
    """Whether 0-based step ``count`` updates 0/1 Adam's variance (JAX
    ``zero_one_var_step``): never after ``var_freeze_step``."""
    s = int(count) + 1
    table = _zero_one_phase_table(int(var_update_scaler))
    k = int(np.searchsorted(table, s))
    return s % (1 << k) == 0 and s <= var_freeze_step


def zero_one_adam_flat(params: torch.Tensor, grads: torch.Tensor,
                       exp_avg: torch.Tensor, exp_avg_sq: torch.Tensor,
                       var_hit: bool, lr: float, beta1: float = 0.9,
                       beta2: float = 0.999, eps: float = 1e-8,
                       weight_decay: float = 0.0,
                       param_copy: Optional[torch.Tensor] = None,
                       grad_scale: Optional[torch.Tensor] = None,
                       skip: Optional[torch.Tensor] = None) -> None:
    """One 0/1 Adam step in place on flat fp32 buffers (JAX
    ``zero_one_adam_transform`` then ``scale_by_schedule``): m always, v
    only when ``var_hit``, u = m / (sqrt(v) + eps) + wd * p without bias
    correction, p -= lr * u; ``param_copy`` / ``grad_scale`` / ``skip`` as
    for ``reference_adam_flat``."""
    g = grads.float()
    if grad_scale is not None:
        g = g * grad_scale.float()
    p = params.float()
    m = beta1 * exp_avg + (1 - beta1) * g
    v = beta2 * exp_avg_sq + (1 - beta2) * (g * g) if var_hit else exp_avg_sq
    u = m / (torch.sqrt(v) + eps)
    if weight_decay != 0.0:
        u = u + weight_decay * p
    p = p - lr * u
    outs = [(params, p), (exp_avg, m), (exp_avg_sq, v)]
    if param_copy is not None:
        outs.append((param_copy, p))
    for dst, new in outs:
        if skip is not None:
            new = torch.where(skip.reshape(()), dst.float(), new)
        if new is not dst:
            dst.copy_(new)


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
    offload = config.zero_optimization.offload_optimizer.device
    if name == "cpuadam" and offload != "cpu":
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
    zero_one = None
    if name == "zerooneadam":
        zero_one = (int(params.get("var_update_scaler", 16)),
                    int(params.get("var_freeze_step", 100000)))
    return MixedPrecisionOptimizer(
        lr_schedule, grad_clip=config.gradient_clipping,
        betas=tuple(params.get("betas", (0.9, 0.999))),
        eps=params.get("eps", 1e-8),
        weight_decay=params.get("weight_decay", 0.0),
        adam_w_mode=adam_w_mode, lamb=name in ("lamb", "onebitlamb"),
        zero_one=zero_one)
