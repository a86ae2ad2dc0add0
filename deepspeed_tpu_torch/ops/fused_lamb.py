"""Fused LAMB over flat buffers: the phase-1 kernel and the phase-2 update.

Counterpart of ``deepspeed_tpu/ops/fused_lamb.py``. LAMB is Adam plus a
trust ratio ``||p|| / ||u||`` per tensor, so a step has two phases, as in
JAX and DeepSpeed's multi-tensor FusedLamb:

* phase 1 (``lamb_phase1``): one read of p / g / m / v per element writes
  the new moments, the update u and per-block partial sums of p^2 and u^2.
  The CUDA kernel of ``csrc/fused_lamb.cu`` on CUDA tensors, its plain
  version ``reference_lamb_phase1`` on CPU tensors;
* phase 2 (``lamb_phase2``, plain torch as JAX's jnp phase 2,
  ``fused_lamb.py:97-105``): the segment norms from the partials, the
  trust ratio (1 where a norm is 0, clamped to [min_coeff, max_coeff]) and
  ``p -= lr * ratio * u``, one in-place op per segment, then the 16-bit
  working copy.

A ``LambSegments`` plan cuts the flat buffer into blocks of at most
``BLOCK`` elements that never straddle a segment, so one phase-1 launch
covers a whole model and each segment (an optimizer leaf) gets its own
exact norms; JAX's ``fused_lamb_flat`` over one tensor is the one-segment
case. Under ZeRO a rank's shard holds parts of leaves: its segments are
those parts (and the padding between them), each carrying its leaf's id
(``LambSegments.from_layout``). Phase 2 then adds the segments' sums into
one row a leaf, hands that (2, n_leaves + 1) fp64 tensor to ``reduce``
(the engine's all-reduce over the data-parallel group) and takes every
segment's trust ratio from its whole leaf. ``fused_lamb_flat`` keeps
JAX's signature and defaults (eps 1e-6, the clamp [0.01, 10]) and updates
params, exp_avg and exp_avg_sq in place (JAX donates the moments) and
returns them. Beyond JAX's arguments the segmented
step takes what the optimizer needs so the host never waits on the card:
``grad_scale`` (a one-element fp32 device tensor multiplying the gradient:
the clip coefficient and the fp16 unscale), ``skip`` (a one-element bool
device tensor: when set neither phase changes p, m or v) and
``param_copy`` (a bf16 / fp16 buffer that receives the updated params).
The update u is a second fp32 buffer of the params' size, kept between the
phases (at OPT-1.3B 5.3 GB): recomputing it in phase 2 from m, v and p
would move the same bytes in a second kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import registry

BLOCK = 1024 * 8

_GRAD_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@dataclasses.dataclass(frozen=True, eq=False)
class LambSegments:
    """Segments of sizes ``sizes`` laid out back to back in a flat buffer,
    cut into blocks of at most ``BLOCK`` elements, none straddling a
    segment. ``block_start`` / ``block_len`` (nblocks,), ``seg_end``
    (nseg,): one past each segment's last block."""

    sizes: Tuple[int, ...]
    block_start: np.ndarray   # (nblocks,) int64
    block_len: np.ndarray     # (nblocks,) int32
    seg_end: np.ndarray       # (nseg,) int64
    # (nseg,) int64: the leaf of each segment (n_leaves for padding), or
    # None when every segment is a leaf of its own
    leaf: Optional[np.ndarray] = None
    n_leaves: int = 0
    _cache: Dict = dataclasses.field(default_factory=dict, repr=False)

    @classmethod
    def from_layout(cls, sizes: Sequence[int], leaf_ids: Sequence[int],
                    n_leaves: int) -> "LambSegments":
        """Segments that are parts of ``n_leaves`` leaves: ``leaf_ids[i]``
        is segment i's leaf (-1 for padding, whose ratio is never used).
        Segments of one leaf share its trust ratio."""
        ids = np.asarray(leaf_ids, np.int64)
        if len(ids) != len(sizes) or (len(ids) and ids.max() >= n_leaves):
            raise ValueError("one leaf id below n_leaves a segment")
        base = cls.from_sizes(sizes)
        if n_leaves == len(ids) and np.array_equal(ids, np.arange(len(ids))):
            return base
        return dataclasses.replace(
            base, leaf=np.where(ids < 0, n_leaves, ids), n_leaves=n_leaves,
            _cache={})

    @classmethod
    def from_sizes(cls, sizes: Sequence[int]) -> "LambSegments":
        sizes = tuple(int(s) for s in sizes)
        if not sizes or min(sizes) < 1:
            raise ValueError(f"segment sizes must be positive, got {sizes}")
        starts, lens, ends = [], [], []
        offset = 0
        for size in sizes:
            first = np.arange(0, size, BLOCK, dtype=np.int64)
            starts.append(offset + first)
            lens.append(np.minimum(BLOCK, size - first).astype(np.int32))
            ends.append(sum(len(s) for s in starts))
            offset += size
        return cls(sizes=sizes, block_start=np.concatenate(starts),
                   block_len=np.concatenate(lens),
                   seg_end=np.asarray(ends, np.int64))

    @property
    def n(self) -> int:
        return sum(self.sizes)

    @property
    def nblocks(self) -> int:
        return len(self.block_len)

    def device_arrays(self, device: torch.device) -> Dict[str, torch.Tensor]:
        key = str(device)
        if key not in self._cache:
            arrs = dict(
                start=torch.from_numpy(self.block_start).to(device),
                len=torch.from_numpy(self.block_len).to(device),
                seg_end=torch.from_numpy(self.seg_end - 1).to(device))
            if self.leaf is not None:
                # (nseg, n_leaves + 1): a segment's row selects its leaf;
                # a matmul adds the segments of each leaf in a fixed order
                arrs["leaf"] = torch.from_numpy(self.leaf).to(device)
                arrs["onehot"] = torch.nn.functional.one_hot(
                    arrs["leaf"], self.n_leaves + 1).double()
            self._cache[key] = arrs
        return self._cache[key]

    def views(self, flat: torch.Tensor):
        """The segments of ``flat`` as 1-D views."""
        return torch.split(flat, list(self.sizes))


def _corrections(step: int, beta1: float, beta2: float,
                 bias_correction: bool) -> Tuple[float, float]:
    if not bias_correction:
        return 1.0, 1.0
    return 1.0 - beta1 ** step, 1.0 - beta2 ** step


def reference_lamb_phase1(params: torch.Tensor, grads: torch.Tensor,
                          exp_avg: torch.Tensor, exp_avg_sq: torch.Tensor,
                          update: torch.Tensor, segments: LambSegments,
                          step: int, beta1: float = 0.9,
                          beta2: float = 0.999, eps: float = 1e-6,
                          weight_decay: float = 0.0,
                          bias_correction: bool = True,
                          grad_scale: Optional[torch.Tensor] = None,
                          skip: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain version of the phase-1 kernel, in place on exp_avg,
    exp_avg_sq and update; returns the (nblocks, 2) partial sums of p^2
    and u^2."""
    g = grads.float()
    if grad_scale is not None:
        g = g * grad_scale.float()
    p = params.float()
    m = beta1 * exp_avg + (1 - beta1) * g
    v = beta2 * exp_avg_sq + (1 - beta2) * g * g
    bc1, bc2 = _corrections(step, beta1, beta2, bias_correction)
    u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    if weight_decay != 0.0:
        u = u + weight_decay * p
    lengths = torch.from_numpy(segments.block_len.astype(np.int64)).to(
        params.device)
    partials = torch.stack([
        torch.segment_reduce(p * p, "sum", lengths=lengths),
        torch.segment_reduce(u * u, "sum", lengths=lengths)], dim=1)
    if skip is not None:         # skipped: m, v kept; u and partials 0
        s = skip.reshape(())
        m = torch.where(s, exp_avg, m)
        v = torch.where(s, exp_avg_sq, v)
        u = torch.where(s, torch.zeros_like(u), u)
        partials = torch.where(s, torch.zeros_like(partials), partials)
    exp_avg.copy_(m)
    exp_avg_sq.copy_(v)
    update.copy_(u)
    return partials


def _fn():
    fn = registry.library("fused_lamb").dstt_lamb_phase1
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int]
                   + [ctypes.c_float] * 8 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def lamb_phase1(params: torch.Tensor, grads: torch.Tensor,
                exp_avg: torch.Tensor, exp_avg_sq: torch.Tensor,
                update: torch.Tensor, segments: LambSegments, step: int,
                beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-6,
                weight_decay: float = 0.0, bias_correction: bool = True,
                grad_scale: Optional[torch.Tensor] = None,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Phase 1 over the segments' blocks, in place on exp_avg, exp_avg_sq
    and update (all (n,) fp32, like params; grads (n,) fp32 / bf16 /
    fp16): the kernel on CUDA tensors, the plain version on CPU tensors.
    Returns the (nblocks, 2) fp32 partial sums of p^2 and u^2."""
    if params.device.type == "cpu":
        return reference_lamb_phase1(params, grads, exp_avg, exp_avg_sq,
                                     update, segments, step, beta1, beta2,
                                     eps, weight_decay, bias_correction,
                                     grad_scale, skip)
    if params.device.type != "cuda":
        raise ValueError(f"lamb_phase1: unsupported device {params.device}")
    n = segments.n
    for name, t in (("params", params), ("exp_avg", exp_avg),
                    ("exp_avg_sq", exp_avg_sq), ("update", update)):
        if t.dtype != torch.float32 or t.shape != (n,):
            raise ValueError(f"lamb_phase1: {name} must be ({n},) float32, "
                             f"got {tuple(t.shape)} {t.dtype}")
    if grads.dtype not in _GRAD_DTYPES or grads.shape != (n,):
        raise ValueError(f"lamb_phase1: grads must be ({n},) float32, "
                         f"bfloat16 or float16, got {tuple(grads.shape)} "
                         f"{grads.dtype}")
    if grad_scale is not None and (grad_scale.numel() != 1
                                   or grad_scale.dtype != torch.float32):
        raise ValueError("lamb_phase1: grad_scale must be one float32")
    if skip is not None and (skip.numel() != 1 or skip.dtype != torch.bool):
        raise ValueError("lamb_phase1: skip must be one bool")
    for t in (params, grads, exp_avg, exp_avg_sq, update, grad_scale, skip):
        if t is not None and (t.device != params.device
                              or not t.is_contiguous()):
            raise ValueError("lamb_phase1: every operand must be contiguous "
                             f"on {params.device}")
    # 4-element vectors: 16 bytes of fp32, 8 of a 16-bit type
    vec = int(all(t.data_ptr() % (4 * t.element_size()) == 0
                  for t in (params, grads, exp_avg, exp_avg_sq, update)))
    arrs = segments.device_arrays(params.device)
    partials = torch.empty(segments.nblocks, 2, dtype=torch.float32,
                           device=params.device)
    bc1, bc2 = _corrections(step, beta1, beta2, bias_correction)
    err = _fn()(params.data_ptr(), grads.data_ptr(), exp_avg.data_ptr(),
                exp_avg_sq.data_ptr(), update.data_ptr(),
                arrs["start"].data_ptr(), arrs["len"].data_ptr(),
                partials.data_ptr(), segments.nblocks, float(beta1),
                float(1 - beta1), float(beta2), float(1 - beta2), float(eps),
                float(weight_decay), float(bc1), float(bc2),
                grad_scale.data_ptr() if grad_scale is not None else None,
                skip.data_ptr() if skip is not None else None,
                _GRAD_DTYPES[grads.dtype], vec,
                torch.cuda.current_stream(params.device).cuda_stream)
    registry.check_launch("fused_lamb", err)
    return partials


def lamb_phase2(params: torch.Tensor, update: torch.Tensor,
                partials: torch.Tensor, segments: LambSegments, lr: float,
                max_coeff: float = 10.0, min_coeff: float = 0.01,
                param_copy: Optional[torch.Tensor] = None,
                reduce: Optional[Callable[[torch.Tensor], Any]] = None
                ) -> torch.Tensor:
    """Phase 2, in place on params (and ``param_copy``): each segment's
    norms from its blocks' partials (summed in fp64 in block order), added
    up per leaf where segments are parts of leaves and then passed to
    ``reduce`` (in place: the sums over every rank's parts), the trust ratio
    ``||p|| / ||u||`` (1 where either norm is 0, clamped to [min_coeff,
    max_coeff]) and ``p -= lr * ratio * u``. Returns the (nseg,) ratios."""
    arrs = segments.device_arrays(params.device)
    ends = arrs["seg_end"]
    # a scan along the inner dim: (nblocks, 2) scanned along dim 0 runs as
    # two sequential scans on the card (15 ms at OPT-1.3B's 160 K blocks).
    # torch.segment_reduce over the blocks, as the plain phase 1 sums its
    # elements, gives the same sums, but runs one thread per segment and
    # column: 2.1 ms more device time a step at OPT-1.3B on an H100
    # (scripts/profile_torch_serving.py --scenario sparse_train)
    csum = partials.double().t().contiguous().cumsum(1)[:, ends]
    sums = torch.diff(csum, dim=1, prepend=torch.zeros_like(csum[:, :1]))
    if segments.leaf is not None:
        per_leaf = sums @ arrs["onehot"]
        if reduce is not None:
            reduce(per_leaf)
        sums = per_leaf[:, arrs["leaf"]]
    elif reduce is not None:
        reduce(sums)
    p_norm, u_norm = sums.sqrt().float().unbind(0)
    ratio = torch.where((p_norm > 0.0) & (u_norm > 0.0),
                        torch.clamp(p_norm / u_norm, min_coeff, max_coeff),
                        torch.ones_like(p_norm))
    coef = -(lr * ratio)
    for i, (p, u) in enumerate(zip(segments.views(params),
                                   segments.views(update))):
        p.addcmul_(u, coef[i])
    if param_copy is not None:
        param_copy.copy_(params)
    return ratio


def lamb_step(params: torch.Tensor, grads: torch.Tensor,
              exp_avg: torch.Tensor, exp_avg_sq: torch.Tensor,
              update: torch.Tensor, segments: LambSegments, step: int,
              lr: float, beta1: float = 0.9, beta2: float = 0.999,
              eps: float = 1e-6, weight_decay: float = 0.0,
              bias_correction: bool = True, max_coeff: float = 10.0,
              min_coeff: float = 0.01,
              param_copy: Optional[torch.Tensor] = None,
              grad_scale: Optional[torch.Tensor] = None,
              skip: Optional[torch.Tensor] = None,
              plain: bool = False,
              reduce: Optional[Callable[[torch.Tensor], Any]] = None
              ) -> torch.Tensor:
    """One segmented LAMB step in place: phase 1 (its kernel, or with
    ``plain`` / on a CPU tensor its plain version) and phase 2 (``reduce``:
    see ``lamb_phase2``). Returns the per-segment trust ratios."""
    phase1 = reference_lamb_phase1 if plain else lamb_phase1
    partials = phase1(params, grads, exp_avg, exp_avg_sq, update, segments,
                      step, beta1, beta2, eps, weight_decay, bias_correction,
                      grad_scale, skip)
    return lamb_phase2(params, update, partials, segments, lr, max_coeff,
                       min_coeff, param_copy, reduce)


def fused_lamb_flat(params: torch.Tensor, grads: torch.Tensor,
                    exp_avg: torch.Tensor, exp_avg_sq: torch.Tensor,
                    step: int, lr: float = 1e-3, beta1: float = 0.9,
                    beta2: float = 0.999, eps: float = 1e-6,
                    weight_decay: float = 0.0, bias_correction: bool = True,
                    max_coeff: float = 10.0, min_coeff: float = 0.01
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One LAMB step on one flat fp32 tensor (one trust ratio), in place:
    JAX ``fused_lamb_flat``'s signature and semantics. Returns (params,
    exp_avg, exp_avg_sq)."""
    segments = LambSegments.from_sizes([params.numel()])
    update = torch.empty_like(params, dtype=torch.float32)
    lamb_step(params, grads, exp_avg, exp_avg_sq, update, segments, step, lr,
              beta1, beta2, eps, weight_decay, bias_correction, max_coeff,
              min_coeff)
    return params, exp_avg, exp_avg_sq


def reference_lamb_flat(params: torch.Tensor, grads: torch.Tensor,
                        exp_avg: torch.Tensor, exp_avg_sq: torch.Tensor,
                        step: int, lr: float = 1e-3, beta1: float = 0.9,
                        beta2: float = 0.999, eps: float = 1e-6,
                        weight_decay: float = 0.0,
                        bias_correction: bool = True,
                        max_coeff: float = 10.0, min_coeff: float = 0.01
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """JAX ``reference_lamb_flat`` (whole-tensor norms, no blocks), in
    place; returns (params, exp_avg, exp_avg_sq). The two norms accumulate
    in fp64: an fp32 accumulation over a large buffer drifts (by 1% at 64 Mi
    elements in PyTorch's CPU reduction)."""
    g = grads.float()
    p = params.float()
    m = beta1 * exp_avg + (1 - beta1) * g
    v = beta2 * exp_avg_sq + (1 - beta2) * g * g
    bc1, bc2 = _corrections(step, beta1, beta2, bias_correction)
    u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    if weight_decay != 0.0:
        u = u + weight_decay * p
    p_norm = torch.linalg.vector_norm(p, dtype=torch.float64).float()
    u_norm = torch.linalg.vector_norm(u, dtype=torch.float64).float()
    ratio = torch.where((p_norm > 0.0) & (u_norm > 0.0),
                        torch.clamp(p_norm / u_norm, min_coeff, max_coeff),
                        torch.ones_like(p_norm))
    params.copy_(p - lr * ratio * u)
    exp_avg.copy_(m)
    exp_avg_sq.copy_(v)
    return params, exp_avg, exp_avg_sq
