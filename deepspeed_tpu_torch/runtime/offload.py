"""Optimizer state in host memory (ZeRO-Offload), and the sub-group
pipeline both offload tiers run.

Counterpart of the JAX engine's host tier (``runtime/engine.py:633-645``:
master and moments in ``pinned_host``; ``:793-830``: grads and params to the
host, the update there under ``compute_on("device_host")``, params back).
Here the rank's fp32 master and both Adam moments are ordinary CPU tensors
(``HostOptimizerState``): PyTorch's pinned-memory allocator rounds each
block up to a power of two, so only the staging buffers are pinned.

``SubGroupPipeline.step`` walks the shard in sub-groups (lists of spans of
the shard) as a three-stage pipeline on a side CUDA stream:

    copy group i+1's grads into a pinned staging buffer    (device -> host)
    update group i on the host                              (CPU tensors)
    copy group i-1's params from pinned staging into the shard (host -> device)

with two staging buffers of each kind. The host update is
``host_adam_flat``: ``reference_adam_flat``'s operations in its order, each
in place or into three fp32 scratch rows allocated once (no temporaries, so
no fresh pages from the allocator a call), so the trajectory is the resident
engine's: on the CPU the resident path runs ``reference_adam_flat`` and the
two are equal bit for bit. The NVMe tier (``runtime/swap``) adds the disk to the
same pipeline through ``_acquire`` / ``_release``. On a CPU device the
pipeline runs the groups in order with no staging.

``stats`` holds the last step's split: the host update's seconds, the
copies' device milliseconds (CUDA events on the side stream), the seconds
the host waited for them, and the bytes moved each way.

``PinnedStaging`` is the side stream both offload paths copy on: the
pipeline issues its DMAs through ``run``; parameter offload
(``runtime/param_offload.py``) also moves pageable host tensors through its
chunked ``to_device`` / ``to_host``.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

Span = Tuple[int, int]          # (position in the shard, elements)
Update = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                   torch.Tensor, torch.Tensor], None]


def host_adam_flat(params: torch.Tensor, grads: torch.Tensor,
                   exp_avg: torch.Tensor, exp_avg_sq: torch.Tensor,
                   step: int, scratch: torch.Tensor, lr: float = 1e-3,
                   beta1: float = 0.9, beta2: float = 0.999,
                   eps: float = 1e-8, weight_decay: float = 0.0,
                   bias_correction: bool = True, adam_w_mode: bool = True,
                   param_copy: Optional[torch.Tensor] = None,
                   grad_scale: Optional[torch.Tensor] = None) -> None:
    """``reference_adam_flat`` (fp32 ``params``, no ``skip``) without
    temporaries: the same operations on the same operands in the same
    order, each in place or into a row of ``scratch`` (fp32, (3, >= n)),
    so the bits are the plain version's."""
    n = params.numel()
    gbuf, a, b = scratch[0, :n], scratch[1, :n], scratch[2, :n]
    g = grads
    l2 = weight_decay != 0.0 and not adam_w_mode
    if g.dtype != torch.float32 or grad_scale is not None or l2:
        g = gbuf.copy_(grads)
        if grad_scale is not None:
            g.mul_(grad_scale.float())
        if l2:
            g.add_(torch.mul(params, weight_decay, out=a))
    exp_avg.mul_(beta1).add_(torch.mul(g, 1 - beta1, out=a))
    exp_avg_sq.mul_(beta2).add_(torch.mul(g, 1 - beta2, out=a).mul_(g))
    if bias_correction:
        torch.div(exp_avg, 1 - beta1 ** step, out=a)
        torch.div(exp_avg_sq, 1 - beta2 ** step, out=b).sqrt_()
    else:
        a.copy_(exp_avg)
        torch.sqrt(exp_avg_sq, out=b)
    a.div_(b.add_(eps))
    if weight_decay != 0.0 and adam_w_mode:
        a.add_(torch.mul(params, weight_decay, out=b))
    params.sub_(a.mul_(lr))
    if param_copy is not None:
        param_copy.copy_(params)


def gather_spans(src: torch.Tensor, spans: List[Span],
                 out: Optional[torch.Tensor] = None,
                 non_blocking: bool = False) -> torch.Tensor:
    """``src``'s spans one after the other, into ``out`` (a view of
    ``src`` when there is one span and no ``out``)."""
    if out is None:
        if len(spans) == 1:
            pos, n = spans[0]
            return src[pos:pos + n]
        out = torch.empty(sum(n for _, n in spans), dtype=src.dtype,
                          device=src.device)
    at = 0
    for pos, n in spans:
        out[at:at + n].copy_(src[pos:pos + n], non_blocking=non_blocking)
        at += n
    return out


def scatter_spans(dst: torch.Tensor, spans: List[Span], src: torch.Tensor,
                  non_blocking: bool = False) -> None:
    """The inverse of ``gather_spans``: ``src``'s consecutive runs into
    ``dst``'s spans."""
    at = 0
    for pos, n in spans:
        dst[pos:pos + n].copy_(src[at:at + n], non_blocking=non_blocking)
        at += n


# bytes of a pageable copy's chunk (two pinned buffers of it a direction)
STAGE_CHUNK = 64 << 20


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


class PinnedStaging:
    """Copies between the host and the card on a side stream. ``run(fn)``
    issues ``fn``'s copies there and returns the events around them.
    ``to_device`` / ``to_host`` move a contiguous pageable CPU tensor
    through two pinned byte buffers a direction, ``chunk`` bytes at a time:
    the host copies a chunk into (out of) one buffer while the other's DMA
    runs. One pageable ``copy_`` of a llama-7b layer's fp32 state runs at a
    sixth of this loop's rate to the card and a third back
    (``scripts/staging_copy_bench.py``). On a CPU device, plain copies.
    Counts: ``copies`` (copies issued on the side stream), ``wait_s`` (host
    seconds waiting on them), ``host_copy_s`` (host seconds copying
    pageable <-> pinned), ``h2d_bytes`` / ``d2h_bytes``."""

    def __init__(self, device: torch.device, chunk: int = STAGE_CHUNK):
        self.cuda = device.type == "cuda"
        self.chunk = chunk
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self._up: Optional[List[torch.Tensor]] = None
        self._down: Optional[List[torch.Tensor]] = None
        self._up_done: List[Any] = [None, None]
        self._k = 0
        self.reset()

    def reset(self) -> None:
        self.copies = 0
        self.wait_s = 0.0
        self.host_copy_s = 0.0
        self.h2d_bytes = 0
        self.d2h_bytes = 0

    def _pinned(self) -> None:
        if self._up is None:
            mk = lambda: torch.empty(self.chunk, dtype=torch.uint8,  # noqa
                                     pin_memory=True)
            self._up = [mk(), mk()]
            self._down = [mk(), mk()]

    def wait(self, event) -> None:
        t0 = time.perf_counter()
        event.synchronize()
        self.wait_s += time.perf_counter() - t0

    def after(self, event) -> None:
        """The side stream waits for ``event`` (of another stream)."""
        if self.cuda and event is not None:
            self.stream.wait_event(event)

    def run(self, fn: Callable[[], Any], timed: bool = False
            ) -> Tuple[Any, Any]:
        """``fn``'s copies on the side stream; returns the events recorded
        before (None unless ``timed``) and after them."""
        with torch.cuda.stream(self.stream):
            a = None
            if timed:
                a = torch.cuda.Event(enable_timing=True)
                a.record(self.stream)
            fn()
            b = torch.cuda.Event(enable_timing=timed)
            b.record(self.stream)
        self.copies += 1
        return a, b

    def dma(self, dst: torch.Tensor, src: torch.Tensor):
        """One copy (``src`` or ``dst`` pinned or on the card); returns its
        event (None on the CPU)."""
        if not self.cuda:
            dst.copy_(src)
            return None
        return self.run(lambda: dst.copy_(src, non_blocking=True))[1]

    def _host_copy(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        t0 = time.perf_counter()
        dst.copy_(src)
        self.host_copy_s += time.perf_counter() - t0

    def to_device(self, dst: torch.Tensor, src: torch.Tensor):
        """``src`` (pageable CPU) into ``dst`` (the card); returns the event
        of the last DMA."""
        n = src.numel() * src.element_size()
        self.h2d_bytes += n
        if not self.cuda:
            dst.copy_(src)
            return None
        self._pinned()
        s8, d8 = as_bytes(src), as_bytes(dst)
        ev = None
        for lo in range(0, n, self.chunk):
            hi = min(n, lo + self.chunk)
            k, self._k = self._k, self._k ^ 1
            if self._up_done[k] is not None:
                self.wait(self._up_done[k])
            buf = self._up[k][:hi - lo]
            self._host_copy(buf, s8[lo:hi])
            ev = self._up_done[k] = self.dma(d8[lo:hi], buf)
        return ev

    def to_host(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        """``src`` (the card) into ``dst`` (pageable CPU); returns once it
        has landed."""
        n = src.numel() * src.element_size()
        self.d2h_bytes += n
        if not self.cuda:
            dst.copy_(src)
            return
        self._pinned()
        s8, d8 = as_bytes(src), as_bytes(dst)
        pending: List[Tuple[Any, torch.Tensor, torch.Tensor]] = []
        for i, lo in enumerate(range(0, n, self.chunk)):
            hi = min(n, lo + self.chunk)
            if len(pending) == 2:
                self._land(*pending.pop(0))
            buf = self._down[i % 2][:hi - lo]
            pending.append((self.dma(buf, s8[lo:hi]), buf, d8[lo:hi]))
        for p in pending:
            self._land(*p)

    def _land(self, event, buf: torch.Tensor, dst: torch.Tensor) -> None:
        self.wait(event)
        self._host_copy(dst, buf)


class SubGroupPipeline:
    """The three-stage offload pipeline over ``groups`` (each a list of
    spans of the shard), its copies on a ``PinnedStaging`` side stream; the
    pinned buffers, a group's size, are the host update's operands.
    Subclasses hold the state: ``_acquire(gi)`` returns
    group ``gi``'s (master, exp_avg, exp_avg_sq) as CPU fp32 tensors of the
    group's size, ``_release(gi, bufs)`` takes them back after its
    update. The update's scratch, three fp32 rows of a piece's size, is
    allocated once."""

    master: Optional[torch.Tensor] = None
    exp_avg: Optional[torch.Tensor] = None
    exp_avg_sq: Optional[torch.Tensor] = None

    def __init__(self, groups: List[List[Span]],
                 update_chunk: Optional[int] = None):
        if not groups:
            raise ValueError("an offload tier needs at least one sub-group")
        self.groups = groups
        self.group_sizes = [sum(n for _, n in g) for g in groups]
        # the update runs on pieces of at most this many elements of a
        # group (it is elementwise; its scratch is a piece's size)
        self.piece = min(update_chunk or max(self.group_sizes),
                         max(self.group_sizes))
        self.stats: Dict[str, float] = {}
        self._staging: Dict[Tuple[str, torch.dtype], List[torch.Tensor]] = {}
        self._scratch: Optional[torch.Tensor] = None
        self._copier: Optional[PinnedStaging] = None

    # -- the state (subclasses) -------------------------------------------
    def _begin(self) -> None:
        pass

    def _acquire(self, gi: int) -> Tuple[torch.Tensor, ...]:
        raise NotImplementedError

    def _release(self, gi: int, bufs: Tuple[torch.Tensor, ...]) -> None:
        pass

    def _end(self) -> None:
        pass

    # -- helpers ------------------------------------------------------------
    def _pinned(self, kind: str, dtype: torch.dtype) -> List[torch.Tensor]:
        key = (kind, dtype)
        if key not in self._staging:
            n = max(self.group_sizes)
            self._staging[key] = [torch.empty(n, dtype=dtype,
                                              pin_memory=True)
                                  for _ in range(2)]
        return self._staging[key]

    def _update(self, update: Update, bufs: Tuple[torch.Tensor, ...],
                g: torch.Tensor, copy: torch.Tensor) -> None:
        if self._scratch is None:
            self._scratch = torch.empty(3, self.piece, dtype=torch.float32)
        for lo in range(0, g.numel(), self.piece):
            sl = slice(lo, lo + self.piece)
            update(bufs[0][sl], g[sl], bufs[1][sl], bufs[2][sl], copy[sl],
                   self._scratch)

    # -- the step ---------------------------------------------------------
    @torch.no_grad()
    def step(self, shard_param: torch.Tensor, grads: torch.Tensor,
             update: Update) -> None:
        """One optimizer step over the shard: ``update(master, grads,
        exp_avg, exp_avg_sq, param_copy, scratch)`` on each sub-group's CPU
        tensors (``param_copy`` receives the new params in the shard's
        dtype, which then land in ``shard_param``)."""
        t_start = time.perf_counter()
        stats = dict(update_s=0.0, wait_s=0.0, d2h_ms=0.0, h2d_ms=0.0,
                     d2h_bytes=0, h2d_bytes=0)
        self._begin()
        if not grads.is_cuda:
            for gi, spans in enumerate(self.groups):
                bufs = self._acquire(gi)
                g = gather_spans(grads, spans)
                copy = (gather_spans(shard_param, spans) if len(spans) == 1
                        else torch.empty(g.numel(), dtype=shard_param.dtype))
                t0 = time.perf_counter()
                self._update(update, bufs, g, copy)
                stats["update_s"] += time.perf_counter() - t0
                if len(spans) > 1:
                    scatter_spans(shard_param, spans, copy)
                self._release(gi, bufs)
        else:
            self._cuda_step(shard_param, grads, update, stats)
        self._end()
        stats["apply_s"] = time.perf_counter() - t_start
        self.stats = stats

    def _cuda_step(self, shard_param: torch.Tensor, grads: torch.Tensor,
                   update: Update, stats: Dict[str, float]) -> None:
        if self._copier is None:
            self._copier = PinnedStaging(grads.device)
        side = self._copier.stream
        main = torch.cuda.current_stream(grads.device)
        side.wait_stream(main)
        gst = self._pinned("grads", grads.dtype)
        pst = self._pinned("params", shard_param.dtype)
        timed: List[Tuple[str, torch.cuda.Event, torch.cuda.Event]] = []

        def on_side(kind: str, fn) -> Tuple[torch.cuda.Event,
                                            torch.cuda.Event]:
            a, b = self._copier.run(fn, timed=True)
            timed.append((kind, a, b))
            return a, b

        def d2h(gi: int):
            n = self.group_sizes[gi]
            stats["d2h_bytes"] += n * grads.element_size()
            return on_side("d2h_ms", lambda: gather_spans(
                grads, self.groups[gi], gst[gi % 2][:n], non_blocking=True))

        h2d_done: List[Optional[torch.cuda.Event]] = [None, None]
        pending = d2h(0)
        for gi, spans in enumerate(self.groups):
            k, n = gi % 2, self.group_sizes[gi]
            arrived = pending[1]
            if gi + 1 < len(self.groups):
                pending = d2h(gi + 1)         # overlaps this group's update
            bufs = self._acquire(gi)
            t0 = time.perf_counter()
            arrived.synchronize()
            if h2d_done[k] is not None:       # group gi - 2's params left
                h2d_done[k].synchronize()
            t1 = time.perf_counter()
            self._update(update, bufs, gst[k][:n], pst[k][:n])
            stats["wait_s"] += t1 - t0
            stats["update_s"] += time.perf_counter() - t1
            stats["h2d_bytes"] += n * shard_param.element_size()
            h2d_done[k] = on_side("h2d_ms", lambda: scatter_spans(
                shard_param, spans, pst[k][:n], non_blocking=True))[1]
            self._release(gi, bufs)
        t0 = time.perf_counter()
        side.synchronize()
        stats["wait_s"] += time.perf_counter() - t0
        main.wait_stream(side)
        for kind, a, b in timed:
            stats[kind] += a.elapsed_time(b)


def contiguous_groups(n: int, sub_group_size: int) -> List[List[Span]]:
    """[0, n) cut into runs of at most ``sub_group_size`` elements."""
    size = max(int(sub_group_size), 1)
    return [[(lo, min(size, n - lo))] for lo in range(0, n, size)]


class HostOptimizerState(SubGroupPipeline):
    """Tier 1: the rank's fp32 master (a copy of the shard, also when the
    params are fp32) and zeroed moments as CPU tensors, updated in
    sub-groups of ``sub_group_size`` elements."""

    def __init__(self, shard_param: torch.Tensor, sub_group_size: int):
        n = shard_param.numel()
        super().__init__(contiguous_groups(n, sub_group_size))
        self.master = torch.empty(n, dtype=torch.float32)
        for (lo, size), in self.groups:
            self.master[lo:lo + size].copy_(shard_param[lo:lo + size])
        self.exp_avg = torch.zeros(n, dtype=torch.float32)
        self.exp_avg_sq = torch.zeros(n, dtype=torch.float32)

    def _acquire(self, gi: int) -> Tuple[torch.Tensor, ...]:
        (lo, n), = self.groups[gi]
        return (self.master[lo:lo + n], self.exp_avg[lo:lo + n],
                self.exp_avg_sq[lo:lo + n])

    def host_bytes(self) -> int:
        return 3 * 4 * self.master.numel()
