"""Spatial (diffusers) ops: GroupNorm over NHWC tokens and the spatial
attention.

Counterpart of ``deepspeed_tpu/ops/spatial.py``. ``fused_group_norm``
launches the CUDA kernels of ``csrc/group_norm.cu`` on a CUDA tensor and
runs its plain version, ``reference_group_norm`` (two passes in fp32, JAX
:121-131), on a CPU tensor. The kernels follow the plain version's exact
two-pass statistics, not the TPU kernel's one-pass variance
(``spatial.py:65``). On the card ``gn_plan`` picks the route from shapes
and pointer alignment alone: ``gn_resident_kernel``, one launch that holds
each block's rows of x in shared memory across a barrier of the batch
row's blocks (x read once, y written once), when those rows fit
``GN_SMEM_BYTES``; else the streaming pair ``gn_stats_kernel`` +
``gn_apply_kernel``. ``diffusers_attention`` has no kernel of its own: it
is the port's flash forward with ``causal=False`` over the flattened
spatial tokens, self or cross attention (T != S).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import registry
from .decode_attention import _sm_count
from .flash_attention import flash_attention

LANES = 128            # the most groups, as in JAX
# the streaming route (gn_stats_kernel + gn_apply_kernel)
STATS_ROWS = 64        # rows of one statistics unit (RC in the kernel)
APPLY_ROWS = 64        # rows a normalising block writes (RA)
STREAMING_THREADS = 256
# the resident route (gn_resident_kernel): the bytes of x a block may hold
# in shared memory (its static 22 KB of partials, merge tiles and
# mbarriers fit beside them in the 227 KB a block can have), the threads a
# block may have (its launch bounds), the threads it is planned with where
# a row's vectors allow (512 ran 2-4% ahead of 1024 at the VAE mid block on
# the H100), the batch rows a call may have and the streams that get their
# own row of arrival counters (kMaxRows, kSlots)
GN_SMEM_BYTES = 200 * 1024
GN_THREADS = 1024
GN_BLOCK_THREADS = 512
GN_MAX_ROWS = 256
GN_STREAM_SLOTS = 128
# A block of a batch row costs a step of every block's merge chain and a
# share of the barrier, so a batch row takes at least GN_MIN_BLOCK_BYTES of
# x a block and at most GN_MAX_ROW_BLOCKS blocks, unless its rows need more
# to fit; timed over block counts by scripts/gn_kernels_ab.py on the H100
# (PERF.md): JAX's test shapes run fastest at 8-16 KB a block, one batch
# row of 4 MB at 48-64 blocks (128 blocks: 23% slower)
GN_MIN_BLOCK_BYTES = 8 * 1024
GN_MAX_ROW_BLOCKS = 64

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


class GnPlan(NamedTuple):
    """Launch shape of ``dstt_group_norm_fwd``. ``route`` "resident":
    ``gn_resident_kernel`` on ``blocks`` blocks a batch row of ``threads``
    threads, block j holding rows [j * rows, (j + 1) * rows) of its batch
    row, ``lanes`` rows a step (thread t: vector t % (C / vec) of rows t //
    (C / vec), + lanes, ...). "streaming": ``gn_apply_kernel`` on
    ``blocks`` blocks a batch row of ``rows`` rows (after
    ``gn_stats_kernel``), ``lanes`` 0. ``vec`` elements an access."""
    route: str
    blocks: int
    rows: int
    vec: int
    lanes: int
    threads: int


def gn_plan(B: int, HW: int, C: int, G: int, itemsize: int, sms: int,
            vec_cap: Optional[int] = None) -> GnPlan:
    """The route and launch shape of a GroupNorm of x (B, HW, C) with
    ``itemsize``-byte elements in G groups on a card of ``sms`` SMs, from
    host integers only. ``vec_cap``: the widest access, in elements of each
    operand, that every operand pointer is aligned to (default 16 bytes'
    worth: all aligned). ``vec`` is the widest power of two up to 16 bytes
    that divides C / G and is within ``vec_cap``.

    Resident when every pointer is 16-byte aligned, a row is a multiple of
    16 bytes (the bulk copies'), B <= min(sms, GN_MAX_ROWS), the C / vec
    vectors of a row fit GN_THREADS threads and each batch row's rows,
    split over at most sms // B blocks, fit GN_SMEM_BYTES a block. A batch
    row then takes a block for each GN_MIN_BLOCK_BYTES of its x, at most
    GN_MAX_ROW_BLOCKS unless it needs more to fit, and at most sms // B
    (``gn_resident_plan``): the SD v1.5 VAE mid block in 16 bits, 4 MB a
    batch row, takes 33 blocks of 125 rows.
    Else streaming: over-capacity shapes (the SD v1.5 VAE decoder's 512 x
    512 up block, 67 MB in bf16; fp32 at the mid block's 64 x 64 latent),
    views not 16-byte aligned, rows not a multiple of 16 bytes."""
    full = 16 // itemsize
    cap = full if vec_cap is None else vec_cap
    cg = C // G
    vec = full
    while vec > 1 and (cg % vec or vec > cap):
        vec //= 2
    streaming = GnPlan("streaming", -(-HW // APPLY_ROWS), APPLY_ROWS, vec,
                       0, STREAMING_THREADS)
    if (cap < full or (C * itemsize) % 16 or B > min(sms, GN_MAX_ROWS)
            or C // vec > GN_THREADS):
        return streaming
    row_bytes = HW * C * itemsize
    per_row = min(sms // B, max(-(-row_bytes // GN_SMEM_BYTES),
                                min(GN_MAX_ROW_BLOCKS,
                                    -(-row_bytes // GN_MIN_BLOCK_BYTES))))
    plan = gn_resident_plan(HW, C, vec, per_row)
    if plan.rows * C * itemsize > GN_SMEM_BYTES:
        return streaming
    return plan


def gn_resident_plan(HW: int, C: int, vec: int, per_row: int) -> GnPlan:
    """The resident launch shape of a batch row of HW rows split over up
    to ``per_row`` blocks (``gn_plan``'s choice, or another to time): rows
    a block, as many rows a step as GN_BLOCK_THREADS threads cover (at
    least one, at most its rows), whole warps."""
    ncv = C // vec
    rows = -(-HW // per_row)
    lanes = min(max(1, GN_BLOCK_THREADS // ncv), rows)
    return GnPlan("resident", -(-HW // rows), rows, vec, lanes,
                  -(-lanes * ncv // 32) * 32)


def plan_block_rows(plan: GnPlan, HW: int):
    """The rows [start, stop) of each block of a batch row under ``plan``
    (the resident kernel's split; the streaming apply blocks' likewise)."""
    return [(j * plan.rows, min(HW, (j + 1) * plan.rows))
            for j in range(plan.blocks)]


def vec_cap(*tensors: torch.Tensor) -> int:
    """The widest power-of-two access, in elements of each tensor, up to 16
    bytes of the first, that every tensor's pointer is aligned to."""
    cap = 16 // tensors[0].element_size()
    while cap > 1 and any(t.data_ptr() % (cap * t.element_size())
                          for t in tensors):
        cap //= 2
    return cap


_slots: Dict[Tuple[int, int], int] = {}
_slots_lock = threading.Lock()


def _stream_slot(device: torch.device, stream: int) -> int:
    """The row of arrival counters of (device, stream): each stream its own,
    so two streams' resident calls never share a counter."""
    key = (device.index, stream)
    with _slots_lock:
        slot = _slots.get(key)
        if slot is None:
            slot = sum(1 for d, _ in _slots if d == device.index)
            if slot >= GN_STREAM_SLOTS:
                raise RuntimeError(
                    f"fused_group_norm: more than {GN_STREAM_SLOTS} streams "
                    f"on {device} (the resident kernel's arrival counters)")
            _slots[key] = slot
        return slot


def _fn():
    return registry.function(
        "group_norm", "dstt_group_norm_fwd",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_float]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _check(x: torch.Tensor, num_groups: int) -> None:
    if x.dim() != 3:
        raise ValueError(f"fused_group_norm: x must be (B, HW, C), got "
                         f"{tuple(x.shape)}")
    C = x.shape[2]
    if C % num_groups:
        raise ValueError(f"C={C} not divisible by num_groups={num_groups}")
    if num_groups > LANES:
        raise ValueError(f"num_groups must be <= {LANES}")


def reference_group_norm(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, num_groups: int,
                         eps: float = 1e-5) -> torch.Tensor:
    """Plain version (torch GroupNorm semantics, NHWC tokens): mean, then
    the mean of squared deviations, in fp32; output in x's dtype."""
    B, HW, C = x.shape
    cg = C // num_groups
    xg = x.float().reshape(B, HW, num_groups, cg)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((xg - mean) / torch.sqrt(var + eps)).reshape(B, HW, C)
    return (y * scale.float() + bias.float()).to(x.dtype)


def fused_group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over spatial tokens: x (B, HW, C), per-channel affine
    ``scale`` / ``bias`` (C,) in fp32 or x's dtype. Statistics per (batch,
    group) across all HW positions and the group's C / num_groups
    channels."""
    _check(x, num_groups)
    if x.device.type == "cpu":
        return reference_group_norm(x, scale, bias, num_groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_group_norm: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"fused_group_norm: dtype {x.dtype} not supported "
                         "(float32, bfloat16, float16)")
    B, HW, C = x.shape
    for name, t in (("scale", scale), ("bias", bias)):
        if (t.shape != (C,) or t.device != x.device
                or t.dtype not in (x.dtype, torch.float32)):
            raise ValueError(f"fused_group_norm: {name} must be ({C},) "
                             f"float32 or {x.dtype} on {x.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if scale.dtype != bias.dtype:
        raise ValueError("fused_group_norm: scale and bias must share a "
                         "dtype")
    for name, t in (("x", x), ("scale", scale), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"fused_group_norm: {name} must be contiguous")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    return _launch(x, scale, bias, y, num_groups, eps)


def _launch(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            y: torch.Tensor, num_groups: int, eps: float,
            plan: Optional[GnPlan] = None) -> torch.Tensor:
    """One call of the kernels under ``plan`` (default: ``gn_plan``); a
    test or a timing script sets the streaming plan on a shape the resident
    kernel takes."""
    B, HW, C = x.shape
    if plan is None:
        plan = gn_plan(B, HW, C, num_groups, x.element_size(),
                       _sm_count(x.device.index), vec_cap(x, y, scale, bias))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    resident = plan.route == "resident"
    if resident:
        part = torch.empty(B, num_groups, plan.blocks, 2,
                           dtype=torch.float32, device=x.device)
        slot = _stream_slot(x.device, stream)
    else:
        part = torch.empty(B, num_groups, -(-HW // STATS_ROWS), 2,
                           dtype=torch.float32, device=x.device)
        slot = 0
    err = _fn()(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                y.data_ptr(), part.data_ptr(), B, HW, C, num_groups,
                int(resident), plan.rows, plan.blocks, plan.lanes,
                plan.threads, slot, STATS_ROWS, float(eps),
                _DTYPES[x.dtype], plan.vec,
                int(scale.dtype == torch.float32
                    and x.dtype != torch.float32), stream)
    registry.check_launch("fused_group_norm", err)
    return y


def diffusers_attention(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Spatial self / cross attention: q (B, HWq, N, D), k / v (B, HWk, N,
    D) -> (B, HWq, N, D). The non-causal flash forward over the flattened
    spatial tokens."""
    return flash_attention(q, k, v, causal=False)
