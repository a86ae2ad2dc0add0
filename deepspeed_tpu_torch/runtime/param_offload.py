"""ZeRO-3 parameter offload: the layer stack off the card, streamed through
it a block of layers at a time.

Counterpart of ``deepspeed_tpu/runtime/param_offload.py`` (reference
ZeRO-Infinity's parameter swap, ``partitioned_param_swapper.py``). As in
JAX, the train step is a loop the host drives over blocks of layers:

  forward   for g in 0..G-1: block g+1 is fetched on the side stream while
            block g runs (``layers_forward``, under ``no_grad``); only the
            boundary activations x_0..x_G are kept, and the last two blocks
            stay in the card's two slots
  head      the loss, and its grads for the resident params and x_G
            (``head_logits`` + ``cross_entropy_loss`` under autograd)
  backward  for g in G-1..0: block g-1 is fetched (from the third-last
            on); block g is recomputed
            from x_g under autograd and ``torch.autograd.grad`` gives dx_g
            and the block's grads (JAX's ``block_vjp``); then
              fused    (gas 1, no clipping, not fp16): the block's fp32
                       master and moments go to the card, ONE
                       ``fused_adam_flat`` launch updates the block, and
                       the state and the new 16-bit params come back
              deferred (gas > 1, clipping or fp16): the block's grads are
                       added into host fp32 accumulators; at the boundary
                       the grad norm, the clip coefficient and the fp16
                       overflow are taken, then a sweep updates each block
                       the same way (an overflow step touches no state)
  embed     the embedding's grads from dx_0 (``transformer.embed``)

The embedding, the final norm and the head ("resident") stay on the card
with their fp32 state and get one ``fused_adam_flat`` launch a step. Peak
device memory is the resident part, at most two blocks of params (two
slots, ``live`` / ``peak_live`` count the blocks held), one block's grads,
fp32 state and recompute, and the G + 1 boundary activations: it does not
grow with the number of layers beyond the activations.

Layout. The stack's leaves are taken in JAX's flatten order (sorted paths).
Blocks of ``layers_per_block`` layers (``buffer_size`` bytes of params,
at least one layer; the last block holds the remainder) are each ONE flat
buffer per kind, leaf-major: leaf i's (layers, *tail) at ``offsets[i]`` --
the layout of JAX's NVMe block files, and what one Adam launch updates.

Tiers. ``cpu``: per block the 16-bit params and the fp32 master and
moments are pageable CPU tensors. ``nvme``: the 16-bit params live only in
``<nvme_path>/dstpu_param_swap_p0/params.block<g>.bin`` (JAX's names),
read ahead into pinned buffers by the aio handle (``ops/aio.py``) and
written back after each update; the fp32 state stays in host memory (JAX
:425-440). Host <-> card copies go through ``runtime/offload.py``'s
``PinnedStaging`` on its side stream (the fetch stream): pageable tensors
through two pinned chunk buffers a direction, the store's pinned buffers
directly. On a CPU device (the tests) the same loop runs with plain copies
and the kernels' plain versions.

The update. JAX's ``adamw_leaves`` (:590-606) and ``reference_adam_flat``
(the plain version of ``fused_adam_flat``) take the same operations in the
same order (scale the grads, the L2 term, m, v, the bias-corrected ratio,
the decoupled decay, the step); the bias corrections are formed on the host
in float64 and rounded once, where JAX forms them in float32, a difference
the trajectory tolerance covers. Loss scaling, the clip coefficient and the
overflow test follow the port's resident engine (``optimizer.apply``), so on
the CPU a fused step equals the resident stage-3 step bit for bit.

Init. A model with ``streams_layers`` draws its params from the engine's
generator in the resident engine's order, each layer of the stack going to
the host (or its file) as it is drawn (``transformer.init_layer_params``'s
sink), so the stack never sits on the card and the params equal the
resident engine's. Other models are initialised whole on the device and
their stack goes through the same sink a layer at a time.

Accounting: ``last_step_stats`` (wall, its forward / backward / update
split on the host clock, bytes each way, bytes read and written on disk,
seconds the host waited on copies and reads, seconds it spent copying
between pageable and pinned memory, and ``device_busy_s``: CUDA events on
the main stream around each block's compute, the embedding, the head and
each Adam launch, summed), ``stream_bytes_per_step``,
``measure_stream_peak`` and ``overlap_report`` (JAX :1138-1262).
"""

from __future__ import annotations

import math
import os
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..models.core import cast_floating, tree_items, tree_set
from ..models.transformer import (TransformerConfig, cross_entropy_loss,
                                  embed, eval_config, head_logits,
                                  layers_forward)
from ..ops.aio import AIOHandle
from ..ops.fused_adam import fused_adam_flat
from ..utils.logging import logger
from .offload import PinnedStaging, as_bytes
from .optimizer import ADAM_FAMILY, StepStats

Path = Tuple[str, ...]


def check_param_offload(config, world: int) -> None:
    """JAX's ``ValueError`` gates of ``offload_param`` (JAX
    ``engine.py:133-160``), in its words, and the port's refusal at world >
    1. The ``NotImplementedError`` ones (pipeline parallelism, random-LTD,
    pruning) are ``Config.check_ported``'s."""
    zo = config.zero_optimization
    if zo.offload_param.device == "none":
        return
    opt = config.optimizer.type.lower()
    if zo.stage < 3:
        raise ValueError(
            "offload_param requires ZeRO stage 3 (reference constraint: "
            "params are partitioned before offload)")
    if opt in ("onebitadam", "onebitlamb", "zerooneadam"):
        raise ValueError("offload_param is incompatible with 1-bit "
                         "optimizers")
    if opt not in ADAM_FAMILY:
        raise ValueError(
            f"offload_param supports the Adam family only, got "
            f"'{config.optimizer.type}' (the streamed update is swap-aware "
            "AdamW, the reference's restriction too)")
    if zo.offload_optimizer.device != "none":
        raise ValueError(
            "offload_param subsumes optimizer-state offload (its fp32 state "
            "is host-resident already) — leave offload_optimizer.device="
            "'none'")
    if world > 1:
        raise NotImplementedError(
            f"offload_param at world {world} is not ported yet: the port's "
            "executor streams the whole layer stack of one process (JAX "
            "streams each process's addressable regions)")


class _NVMeParamStore:
    """The 16-bit params of each block in a file of its own (JAX
    ``_NVMeParamStore``, :95-157: ``params.block<g>.bin`` under
    ``swap_dir``, the block's leaves back to back). Reads go ahead into two
    pinned read buffers (``prefetch_block``; ``read_block`` waits for one),
    which the side stream copies to the card; the new params come back into
    two pinned write buffers and are written asynchronously (``flush`` waits
    for the writes). Each transfer is split into one piece per aio thread.
    Every read and write raises on failure; nothing is retried."""

    def __init__(self, swap_dir: str, block_bytes: List[int], aio,
                 pinned: bool):
        os.makedirs(swap_dir, exist_ok=True)
        self.swap_dir = swap_dir
        self.block_bytes = block_bytes
        self.threads = max(1, int(getattr(aio, "thread_count", 1)))
        depth = max(int(getattr(aio, "queue_depth", 8)), self.threads)
        n = max(block_bytes)
        mk = lambda: torch.empty(n, dtype=torch.uint8,  # noqa: E731
                                 pin_memory=pinned)
        self._rbuf, self._wbuf = [mk(), mk()], [mk(), mk()]
        self._rh = [AIOHandle(depth, self.threads) for _ in range(2)]
        self._wh = [AIOHandle(depth, self.threads) for _ in range(2)]
        self._writing = [False, False]
        self._reading: Dict[int, int] = {}
        self._dma_out: List[Any] = [None, None]
        self._wk = 0
        self.reset()

    def reset(self) -> None:
        self.read_bytes = 0
        self.write_bytes = 0
        self.wait_s = 0.0

    def file(self, g: int) -> str:
        return os.path.join(self.swap_dir, f"params.block{g:04d}.bin")

    def _pieces(self, n: int) -> List[Tuple[int, int]]:
        step = -(-n // self.threads)
        step = -(-step // 4096) * 4096
        return [(lo, min(n, lo + step)) for lo in range(0, n, step)]

    def _wait(self, handle: AIOHandle) -> None:
        t0 = time.perf_counter()
        handle.wait()
        self.wait_s += time.perf_counter() - t0

    def write_rows(self, g: int, offset: int, data: torch.Tensor) -> None:
        """``data`` (a contiguous CPU tensor) at byte ``offset`` of block
        ``g``'s file, synchronously (the streamed init)."""
        self._wh[0].async_pwrite(as_bytes(data), self.file(g), offset)
        self._wait(self._wh[0])
        self.write_bytes += data.numel() * data.element_size()

    def write_block_host(self, g: int, data: torch.Tensor) -> None:
        """Block ``g``'s whole file from a CPU tensor, synchronously."""
        src = as_bytes(data)
        for lo, hi in self._pieces(src.numel()):
            self._wh[0].async_pwrite(src[lo:hi], self.file(g), lo)
        self._wait(self._wh[0])
        self.write_bytes += src.numel()

    def write_block(self, g: int, src: torch.Tensor, staging: PinnedStaging,
                    after) -> None:
        """Block ``g``'s new params from ``src`` (the card) into a pinned
        write buffer (the side stream, after ``after``), then an async
        write of the file."""
        k, self._wk = self._wk, self._wk ^ 1
        if self._writing[k]:
            self._wait(self._wh[k])
        n = src.numel() * src.element_size()
        buf = self._wbuf[k][:n]
        staging.after(after)
        ev = staging.dma(buf, as_bytes(src))
        staging.d2h_bytes += n
        if ev is not None:
            staging.wait(ev)
        for lo, hi in self._pieces(n):
            self._wh[k].async_pwrite(buf[lo:hi], self.file(g), lo)
        self._writing[k] = True
        self.write_bytes += n

    def prefetch_block(self, g: int) -> None:
        """Start reading block ``g`` into read buffer ``g % 2``."""
        if g in self._reading or not 0 <= g < len(self.block_bytes):
            return
        k = g % 2
        if k in self._reading.values():
            raise RuntimeError(f"param store: read buffer {k} still holds an "
                               "unread block")
        if self._dma_out[k] is not None:
            t0 = time.perf_counter()
            self._dma_out[k].synchronize()
            self.wait_s += time.perf_counter() - t0
            self._dma_out[k] = None
        n = self.block_bytes[g]
        for lo, hi in self._pieces(n):
            self._rh[k].async_pread(self._rbuf[k][lo:hi], self.file(g), lo)
        self._reading[g] = k
        self.read_bytes += n

    def read_block(self, g: int) -> Tuple[torch.Tensor, int]:
        """Block ``g``'s bytes in its read buffer (read now unless it was
        prefetched) and the buffer's index."""
        self.prefetch_block(g)
        k = self._reading.pop(g)
        self._wait(self._rh[k])
        return self._rbuf[k][:self.block_bytes[g]], k

    def released(self, k: int, event) -> None:
        """Read buffer ``k`` is free once ``event`` (its DMA) is done."""
        self._dma_out[k] = event

    def flush(self) -> None:
        for k in (0, 1):
            if self._writing[k]:
                self._wait(self._wh[k])
                self._writing[k] = False

    def close(self, remove: bool = False) -> None:
        self.flush()
        for h in self._rh + self._wh:
            h.close()
        if remove:
            shutil.rmtree(self.swap_dir, ignore_errors=True)


class _LayerSink:
    """Where the streamed init puts the rows of one stack leaf: ``sink[li]
    = layer`` writes layer ``li`` into its block's params (host memory or
    its file) and fp32 master, at once."""

    def __init__(self, ex: "ParamOffloadExecutor", i: int):
        self.ex, self.i = ex, i

    def __setitem__(self, li: int, value: torch.Tensor) -> None:
        ex = self.ex
        g = ex.block_of(li)
        lo = ex.bounds[g][0]
        row = value.to(ex.dtype).to("cpu")
        n = ex.leaf_numel[self.i]
        at = ex.offsets[g][self.i] + (li - lo) * n
        if ex.store is not None:
            ex.store.write_rows(g, at * row.element_size(), row)
        else:
            ex.params[g][at:at + n].copy_(row.reshape(-1))
        ex.master[g][at:at + n].copy_(row.reshape(-1))


class ParamOffloadExecutor:
    """The host-driven segmented train step of ``offload_param.device`` in
    {cpu, nvme} at world 1. Owns the streamed layer params and ALL of the
    optimizer state; the engine delegates its step, eval, checkpoints and
    16-bit export to it."""

    def __init__(self, model, config, optimizer, loss_scaler,
                 device: torch.device, dtype: torch.dtype):
        cfg = model.config
        if not isinstance(cfg, TransformerConfig):
            raise ValueError("offload_param requires a transformer Model")
        self.cfg, self.config, self.device, self.dtype = (cfg, config,
                                                          device, dtype)
        self.cuda = device.type == "cuda"
        zo = config.zero_optimization
        self.tier = zo.offload_param.device
        self.optimizer = optimizer
        self.lr_schedule = optimizer.lr_schedule
        self.gas = config.gradient_accumulation_steps
        self.grad_clip = float(config.gradient_clipping or 0.0)
        self.fp16 = config.fp16.enabled
        self.loss_scaler = loss_scaler
        self.scaler_state = loss_scaler.init(device)
        self.step_count = 0       # applied steps (Adam's bias correction)
        self.attempts = 0         # steps taken, overflow-skipped ones too
        self.last_step_stats: Optional[Dict[str, Any]] = None
        # grad_hook(part, g, grads) -> grads, where part is "block" (block
        # g's flat grads) or "resident" (g = -1), called on each micro
        # batch's grads before the update or the accumulator takes them:
        # a check that holds two engines to each other feeds both the same
        # grads through it (the flash backward's dq is not bit-repeatable)
        self.grad_hook = None
        self.staging = PinnedStaging(device)
        # (start, end) timing events on the main stream around each piece
        # of the step's device work (``device_busy_s``)
        self._busy: List[Tuple[Any, Any]] = []

        gen = torch.Generator(device=device)
        gen.manual_seed(config.seed)
        streamed = getattr(model, "streams_layers", False)
        if streamed:
            tree = model.init(torch.Generator(), device="meta")
            whole = None
        else:
            whole = tree = cast_floating(model.init(gen), dtype)
        self._layout(tree)
        self.store: Optional[_NVMeParamStore] = None
        if self.tier == "nvme":
            self.store = _NVMeParamStore(
                os.path.join(zo.offload_param.nvme_path,
                             "dstpu_param_swap_p0"),
                [n * dtype.itemsize for n in self.block_numel], config.aio,
                pinned=self.cuda)
        self.params = (None if self.store is not None else
                       [torch.empty(n, dtype=dtype)
                        for n in self.block_numel])
        self.master = [torch.empty(n, dtype=torch.float32)
                       for n in self.block_numel]
        sink = lambda path, shape: _LayerSink(  # noqa: E731
            self, self.layer_paths.index(path))
        if streamed:
            resident = model.init(gen, sink=sink)
        else:
            resident = whole
            for path, stack in tree_items(whole["layers"]):
                rows = sink(path, None)
                for li in range(self.num_layers):
                    rows[li] = stack[li]
        del resident["layers"]
        self.m = [torch.zeros(n, dtype=torch.float32)
                  for n in self.block_numel]
        self.v = [torch.zeros(n, dtype=torch.float32)
                  for n in self.block_numel]
        self.acc: Optional[List[torch.Tensor]] = None
        if self.store is not None:
            self.store.flush()
        self._init_resident(resident)
        self.slots = [torch.empty(self.max_block, dtype=dtype, device=device)
                      for _ in range(2)]
        self._slot_block: List[Optional[int]] = [None, None]
        self._slot_free: List[Any] = [None, None]
        self._fetched: List[Any] = [None, None]
        self._dev_state: Optional[List[torch.Tensor]] = None
        self._state_free = None
        self.live = self.peak_live = 0
        state_gb = sum(self.block_numel) * 12 / 1e9
        logger.info(
            f"param offload ({self.tier}): {self.num_layers} layers in "
            f"{self.num_blocks} blocks of {self.layers_per_block} "
            f"({self.max_block * dtype.itemsize / 1e6:.0f} MB a block on the "
            f"card; {state_gb:.2f} GB of fp32 layer state in host memory)")

    # -- layout -------------------------------------------------------------
    def _layout(self, tree: Dict[str, Any]) -> None:
        leaves = sorted(tree_items(tree["layers"]))
        self.layer_paths: List[Path] = [p for p, _ in leaves]
        L = int(leaves[0][1].shape[0])
        self.num_layers = L
        self.leaf_tails = [tuple(t.shape[1:]) for _, t in leaves]
        self.leaf_numel = [math.prod(t) for t in self.leaf_tails]
        per_layer = sum(self.leaf_numel)
        bytes_per_layer = per_layer * self.dtype.itemsize
        buf = int(self.config.zero_optimization.offload_param.buffer_size)
        self.layers_per_block = min(L, max(1, buf // max(bytes_per_layer,
                                                         1)))
        self.num_blocks = -(-L // self.layers_per_block)
        self.bounds = [(g * self.layers_per_block,
                        min((g + 1) * self.layers_per_block, L))
                       for g in range(self.num_blocks)]
        self.offsets: List[List[int]] = []
        self.block_numel: List[int] = []
        for lo, hi in self.bounds:
            offs, at = [], 0
            for n in self.leaf_numel:
                offs.append(at)
                at += (hi - lo) * n
            self.offsets.append(offs)
            self.block_numel.append(at)
        self.max_block = max(self.block_numel)
        self.res_items = sorted((p, tuple(t.shape)) for p, t in
                                tree_items(tree) if p[0] != "layers")
        self.res_numel = [math.prod(s) for _, s in self.res_items]
        self.n_params = sum(self.block_numel) + sum(self.res_numel)

    def block_of(self, li: int) -> int:
        return li // self.layers_per_block

    def leaf_slice(self, g: int, i: int) -> slice:
        lo, hi = self.bounds[g]
        at = self.offsets[g][i]
        return slice(at, at + (hi - lo) * self.leaf_numel[i])

    @torch.no_grad()
    def _init_resident(self, resident: Dict[str, Any]) -> None:
        flat = dict(tree_items(resident))
        self.res_flat = torch.cat([
            flat[p].reshape(-1).to(self.device, self.dtype)
            for p, _ in self.res_items])
        self.res_master = (self.res_flat.float()
                           if self.dtype != torch.float32 else None)
        self.res_m = torch.zeros(self.res_flat.numel(), dtype=torch.float32,
                                 device=self.device)
        self.res_v = torch.zeros_like(self.res_m)
        self.res_acc: Optional[torch.Tensor] = None

    def res_tree(self, flat: torch.Tensor) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for (p, s), t in zip(self.res_items, flat.split(self.res_numel)):
            tree_set(out, p, t.view(s))
        return out

    def block_layers(self, flat: torch.Tensor, g: int
                     ) -> List[Dict[str, Any]]:
        """Block ``g``'s layers as param dicts of views of its flat buffer
        (one split and one unbind a leaf, so the grads come back as one
        flat buffer)."""
        lo, hi = self.bounds[g]
        n = hi - lo
        out: List[Dict[str, Any]] = [{} for _ in range(n)]
        pieces = flat[:self.block_numel[g]].split(
            [n * k for k in self.leaf_numel])
        for path, tail, t in zip(self.layer_paths, self.leaf_tails, pieces):
            for j, row in enumerate(t.view(n, *tail).unbind(0)):
                tree_set(out[j], path, row)
        return out

    # -- fetch ----------------------------------------------------------------
    def _main(self):
        return torch.cuda.current_stream(self.device) if self.cuda else None

    def _record(self):
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(self._main())
        return ev

    def _tick(self):
        """A timing event on the main stream (None on the CPU)."""
        if not self.cuda:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self._main())
        return ev

    def _busy_from(self, start) -> None:
        """The main stream's work since ``start`` (``_tick``) counts as
        device work."""
        if start is not None:
            self._busy.append((start, self._tick()))

    def _fetch(self, g: int) -> None:
        """Block ``g``'s params into slot ``g % 2`` (the side stream, after
        the slot's last use on the main stream)."""
        s = g % 2
        if self._slot_block[s] == g:
            return           # still on the card (the backward's first two)
        if self._slot_block[s] is not None:
            self.live -= 1
        self._slot_block[s] = g
        self.live += 1
        self.peak_live = max(self.peak_live, self.live)
        dst = self.slots[s][:self.block_numel[g]]
        self.staging.after(self._slot_free[s])
        if self.store is not None:
            buf, k = self.store.read_block(g)
            ev = self.staging.dma(as_bytes(dst), buf)
            self.staging.h2d_bytes += buf.numel()
            self.store.released(k, ev)
        else:
            ev = self.staging.to_device(dst, self.params[g])
        self._fetched[s] = ev

    def _prefetch(self, g: int) -> None:
        if self.store is not None:
            self.store.prefetch_block(g)

    def _slot(self, g: int) -> torch.Tensor:
        """Block ``g``'s params on the card, once its copy has landed."""
        s = g % 2
        if self._slot_block[s] != g:
            raise RuntimeError(f"block {g} is not on the card")
        if self.cuda and self._fetched[s] is not None:
            self._main().wait_event(self._fetched[s])
        return self.slots[s][:self.block_numel[g]]

    def _release_slots(self) -> None:
        self._slot_block = [None, None]
        self.live = 0

    # -- the update -----------------------------------------------------------
    def _state_on_card(self, n: int, acc: bool) -> List[torch.Tensor]:
        """Views of the card's fp32 buffers for one block's master and
        moments (and its accumulated grads on the deferred path)."""
        want = 4 if acc else 3
        if self._dev_state is None:
            self._dev_state = []
        while len(self._dev_state) < want:
            self._dev_state.append(torch.empty(
                self.max_block, dtype=torch.float32, device=self.device))
        return [t[:n] for t in self._dev_state[:want]]

    def _adam(self, master, grads, m, v, copy, grad_scale, step, lr):
        p = self.optimizer
        fused_adam_flat(master, grads, m, v, step, lr=lr, beta1=p.betas[0],
                        beta2=p.betas[1], eps=p.eps,
                        weight_decay=p.weight_decay, bias_correction=True,
                        adam_w_mode=p.adam_w_mode, param_copy=copy,
                        grad_scale=grad_scale)

    def _update_block(self, g: int, grads: Optional[torch.Tensor],
                      grad_scale, step: int, lr: float) -> float:
        """Block ``g``'s Adam step on the card: its fp32 master and moments
        (and, deferred, its accumulated grads) over, one launch, the state
        and the new params back. Returns the host seconds it took."""
        t0 = time.perf_counter()
        n = self.block_numel[g]
        bufs = self._state_on_card(n, grads is None)
        ma, m, v = bufs[:3]
        st = self.staging
        st.after(self._state_free)
        events = [st.to_device(ma, self.master[g]),
                  st.to_device(m, self.m[g]), st.to_device(v, self.v[g])]
        if grads is None:
            events.append(st.to_device(bufs[3], self.acc[g]))
            grads = bufs[3]
        if self.cuda:
            self._main().wait_event(events[-1])
        s = g % 2
        if self.dtype == torch.float32:
            copy, new = None, ma
        else:
            copy = new = self.slots[s][:n]
        t = self._tick()
        self._adam(ma, grads, m, v, copy, grad_scale, step, lr)
        self._busy_from(t)
        done = self._slot_free[s] = self._state_free = self._record()
        st.after(done)
        st.to_host(self.master[g], ma)
        st.to_host(self.m[g], m)
        st.to_host(self.v[g], v)
        if self.store is not None:
            self.store.write_block(g, new, st, None)
        elif new is ma:
            self.params[g].copy_(self.master[g])
        else:
            st.to_host(self.params[g], new)
        return time.perf_counter() - t0

    def _update_resident(self, grads, grad_scale, step, lr) -> None:
        master = self.res_master if self.res_master is not None \
            else self.res_flat
        copy = self.res_flat if self.res_master is not None else None
        t = self._tick()
        self._adam(master, grads, self.res_m, self.res_v, copy, grad_scale,
                   step, lr)
        self._busy_from(t)

    @property
    def fused(self) -> bool:
        """The update runs as each block's grads exist (JAX ``_fused``)."""
        return self.gas == 1 and self.grad_clip == 0.0 and not self.fp16

    # -- the train step -------------------------------------------------------
    @staticmethod
    def labels_of(mb: Dict[str, Any]) -> torch.Tensor:
        labels = mb.get("labels")
        if labels is None:
            ids = mb["input_ids"]
            labels = torch.cat([ids[:, 1:], torch.full_like(ids[:, :1],
                                                            -100)], 1)
        return labels

    def _init_acc(self) -> None:
        if self.acc is None:
            self.acc = [torch.zeros(n, dtype=torch.float32)
                        for n in self.block_numel]
            self._host_grads = torch.empty(self.max_block, dtype=self.dtype)
        if self.res_acc is None:
            self.res_acc = torch.zeros_like(self.res_m)

    def _forward(self, mask, cfg, x0: torch.Tensor) -> List[torch.Tensor]:
        """The boundary activations x_0..x_G, streaming the blocks; the
        last block stays in its slot."""
        G = self.num_blocks
        acts = [x0]
        self._prefetch(0)
        self._prefetch(1)
        self._fetch(0)
        x = x0
        with torch.no_grad():
            for g in range(G):
                flat = self._slot(g)
                t = self._tick()
                x = layers_forward(self.block_layers(flat, g), x, cfg, mask)
                self._busy_from(t)
                acts.append(x)
                self._slot_free[g % 2] = self._record()
                if g + 1 < G:
                    self._fetch(g + 1)
                    self._prefetch(g + 2)
        return acts

    def train_step(self, micros: List[Dict[str, Any]]
                   ) -> Tuple[torch.Tensor, StepStats]:
        """One step over the gas micro-batches (dicts of (B, S) tensors on
        the engine's device). Returns the mean micro loss and the step's
        ``StepStats`` (an fp16 overflow step touches no state)."""
        t_start = time.perf_counter()
        self.staging.reset()
        self._busy = []
        if self.store is not None:
            self.store.reset()
        self.attempts += 1
        step = self.step_count + 1
        lr = float(self.lr_schedule(self.step_count))
        lr_outer = float(self.lr_schedule(self.attempts - 1))
        G, cfg, fused = self.num_blocks, self.cfg, self.fused
        if not fused:
            self._init_acc()
        t_upd = 0.0
        t_fwd = 0.0
        losses, sq = [], []
        for mb in micros:
            t0 = time.perf_counter()
            ids, mask = mb["input_ids"], mb.get("attention_mask")
            labels = self.labels_of(mb)
            S = ids.shape[1]
            t = self._tick()
            rf_e = self.res_flat.detach().requires_grad_(True)
            x0 = embed(self.res_tree(rf_e), ids,
                       torch.arange(S, device=ids.device), cfg)
            self._busy_from(t)
            acts = self._forward(mask, cfg, x0.detach())
            t = self._tick()
            rf_h = self.res_flat.detach().requires_grad_(True)
            x_top = acts[G].requires_grad_(True)
            loss = cross_entropy_loss(head_logits(self.res_tree(rf_h), x_top,
                                                  cfg), labels, mask)
            scaled = loss * self.scaler_state.scale if self.fp16 else loss
            d_head, dx = torch.autograd.grad(scaled / self.gas,
                                             [rf_h, x_top])
            self._busy_from(t)
            losses.append(loss.detach().float())
            t_fwd += time.perf_counter() - t0
            for g in range(G - 1, -1, -1):
                flat = self._slot(g)
                t = self._tick()
                bf = flat.detach().requires_grad_(True)
                x_in = acts[g].detach().requires_grad_(True)
                with torch.enable_grad():
                    y = layers_forward(self.block_layers(bf, g), x_in, cfg,
                                       mask)
                dblock, dx = torch.autograd.grad(y, [bf, x_in], dx)
                self._busy_from(t)
                del y, bf, x_in
                if self.grad_hook is not None:
                    dblock = self.grad_hook("block", g, dblock)
                acts[g + 1] = None
                self._slot_free[g % 2] = self._record()
                if g > 0:
                    self._fetch(g - 1)
                    self._prefetch(g - 2)
                if fused:
                    sq.append(torch.linalg.vector_norm(
                        dblock, dtype=torch.float32).square())
                    t_upd += self._update_block(g, dblock, None, step, lr)
                else:
                    t0 = time.perf_counter()
                    host = self._host_grads[:dblock.numel()]
                    self.staging.after(self._record())
                    self.staging.to_host(host, dblock)
                    self.acc[g].add_(host)
                    t_upd += time.perf_counter() - t0
                del dblock
            t = self._tick()
            (d_embed,) = torch.autograd.grad(x0, [rf_e], dx)
            self._busy_from(t)
            d_res = d_head + d_embed
            del acts, x0, dx, d_head, d_embed
            if self.grad_hook is not None:
                d_res = self.grad_hook("resident", -1, d_res)
            if fused:
                sq.append(torch.linalg.vector_norm(
                    d_res, dtype=torch.float32).square())
            else:
                self.res_acc.add_(d_res)
            # the next micro-batch (or step) starts from block 0
            self._release_slots()
        mean = torch.stack(losses).mean()
        if fused:
            norm = torch.stack(sq).sum().sqrt()
            t0 = time.perf_counter()
            self._update_resident(d_res, None, step, lr)
            t_upd += time.perf_counter() - t0
            skipped = False
        else:
            norm, skipped, t = self._deferred_update(step, lr)
            t_upd += t
        if self.store is not None:
            self.store.flush()
        if not skipped:
            self.step_count += 1
        if self.fp16:
            self.scaler_state = self.loss_scaler.update(
                self.scaler_state,
                torch.tensor(skipped, device=self.device))
        if self.cuda:
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t_start
        self._record_stats(wall, t_fwd, t_upd, skipped, float(norm))
        return mean, StepStats(grad_norm=norm,
                               skipped=torch.tensor(skipped,
                                                    device=self.device),
                               lr=lr_outer)

    def _deferred_update(self, step: int, lr: float):
        """The boundary of the deferred path: the grad norm over the host
        accumulators and the resident one, the fp16 unscale and overflow
        test and the clip coefficient (as ``optimizer.apply`` takes them),
        then each block's update. Returns (norm, skipped, host seconds)."""
        t0 = time.perf_counter()
        # each block's squares summed in float64 on the host (the resident
        # engine's ``grad_norm`` of its flat grads does so on the CPU)
        sq = sum(float(torch.linalg.vector_norm(a, dtype=torch.float64)) ** 2
                 for a in self.acc + [self.res_acc.cpu()])
        norm = torch.tensor(math.sqrt(sq), dtype=torch.float32,
                            device=self.device)
        scale = None
        if self.fp16:
            scale = 1.0 / self.scaler_state.scale
            norm = norm * scale
            if not bool(torch.isfinite(norm)):
                for a in self.acc:
                    a.zero_()
                self.res_acc.zero_()
                return norm, True, time.perf_counter() - t0
        if self.grad_clip > 0:
            coef = torch.clamp(self.grad_clip / (norm + 1e-6), max=1.0)
            scale = coef if scale is None else scale * coef
        gs = scale.reshape(1).float() if scale is not None else None
        for g in range(self.num_blocks):
            self._update_block(g, None, gs, step, lr)
        self._update_resident(self.res_acc, gs, step, lr)
        for a in self.acc:
            a.zero_()
        self.res_acc.zero_()
        return norm, False, time.perf_counter() - t0

    def _record_stats(self, wall: float, t_fwd: float, t_upd: float,
                      skipped: bool, norm: float) -> None:
        st, store = self.staging, self.store
        busy = sum(a.elapsed_time(b) for a, b in self._busy) / 1e3
        self.last_step_stats = {
            "wall_s": wall, "forward_s": t_fwd,
            "backward_s": max(wall - t_fwd - t_upd, 0.0),
            "update_s": t_upd,
            "h2d_bytes": st.h2d_bytes, "d2h_bytes": st.d2h_bytes,
            "read_bytes": store.read_bytes if store else 0,
            "write_bytes": store.write_bytes if store else 0,
            "fetch_wait_s": st.wait_s + (store.wait_s if store else 0.0),
            "host_copy_s": st.host_copy_s,
            "device_busy_s": busy if self.cuda else None,
            "side_stream_copies": st.copies,
            "achieved_h2d_gbps": st.h2d_bytes / wall / 1e9,
            "achieved_total_gbps": (st.h2d_bytes + st.d2h_bytes) / wall / 1e9,
            "peak_live_blocks": self.peak_live, "skipped": skipped,
            "grad_norm": norm}

    # -- accounting (JAX :1138-1262) ----------------------------------------
    def stream_bytes_per_step(self, include_update: bool = True
                              ) -> Tuple[int, int]:
        """The bytes one step moves as (to the card, from it), counted from
        the loop: per micro-batch the forward fetches every block and the
        backward all but the last two, which it finds on the card; the
        update moves the fp32 master and moments (12 bytes an element) both
        ways and the new 16-bit params back; the deferred path also brings
        each block's grads back every micro-batch and its fp32 accumulator
        over at the update."""
        item = self.dtype.itemsize
        elems = sum(self.block_numel)
        P = elems * item
        # the backward finds the last two blocks still on the card
        per_micro = P + sum(self.block_numel[:-2]) * item
        # fp32 params come back as the master
        back = P if self.dtype != torch.float32 else 0
        h2d, d2h = self.gas * per_micro, 0
        if self.fused:
            return h2d + 12 * elems, d2h + back + 12 * elems
        d2h += self.gas * P
        if include_update:
            h2d += 16 * elems
            d2h += back + 12 * elems
        return h2d, d2h

    def measure_stream_peak(self, sweeps: int = 2) -> float:
        """GB/s of fetching every block with nothing else running (two
        blocks on the card at most, as in a step)."""
        def sweep():
            for g in range(self.num_blocks):
                self._prefetch(g + 1)
                self._fetch(g)
                self._slot_free[g % 2] = self._record()
            if self.cuda:
                torch.cuda.synchronize(self.device)
            self._release_slots()

        sweep()
        t0 = time.perf_counter()
        for _ in range(sweeps):
            sweep()
        dt = time.perf_counter() - t0
        return sweeps * sum(self.block_numel) * self.dtype.itemsize / dt / 1e9

    def overlap_report(self, micros: List[Dict[str, Any]]) -> Dict[str, Any]:
        """Fetch against compute for one step shape (JAX
        ``overlap_report``): ``t_fetch_s`` the step's bytes to the card at
        the measured peak rate, ``t_compute_s`` the forward and backward
        over one block on the card reused G times (no streaming),
        ``t_step_s`` a real step; ``overlap_efficiency`` = (t_fetch +
        t_compute - t_step) / min(t_fetch, t_compute), clamped to [0, 1]."""
        peak = self.measure_stream_peak()
        self.train_step(micros)
        stats = dict(self.last_step_stats)
        t_step = stats["wall_s"]
        mb = micros[0]
        ids, mask = mb["input_ids"], mb.get("attention_mask")
        self._fetch(0)
        flat = self._slot(0)
        if self.cuda:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        for _ in range(self.gas):
            with torch.no_grad():
                x = embed(self.res_tree(self.res_flat), ids,
                          torch.arange(ids.shape[1], device=ids.device),
                          self.cfg)
            acts = [x]
            for _ in range(self.num_blocks):
                with torch.no_grad():
                    x = layers_forward(self.block_layers(flat, 0), x,
                                       self.cfg, mask)
                acts.append(x)
            dx = torch.ones_like(x)
            for g in range(self.num_blocks - 1, -1, -1):
                bf = flat.detach().requires_grad_(True)
                x_in = acts[g].detach().requires_grad_(True)
                with torch.enable_grad():
                    y = layers_forward(self.block_layers(bf, 0), x_in,
                                       self.cfg, mask)
                _, dx = torch.autograd.grad(y, [bf, x_in], dx)
        if self.cuda:
            torch.cuda.synchronize(self.device)
        t_compute = time.perf_counter() - t0
        self._release_slots()
        t_fetch = stats["h2d_bytes"] / (peak * 1e9)
        eff = (t_fetch + t_compute - t_step) / max(min(t_fetch, t_compute),
                                                   1e-9)
        stats.update(peak_h2d_gbps=peak, t_fetch_s=t_fetch,
                     t_compute_s=t_compute, t_step_s=t_step,
                     overlap_efficiency=max(0.0, min(eff, 1.0)),
                     h2d_utilization=stats["achieved_h2d_gbps"] / peak)
        return stats

    # -- eval -----------------------------------------------------------------
    @torch.no_grad()
    def eval_forward(self, mb: Dict[str, Any]) -> torch.Tensor:
        """The eval loss of one micro-batch, streaming the blocks (JAX
        :1264-1281)."""
        ids, mask = mb["input_ids"], mb.get("attention_mask")
        cfg = eval_config(self.cfg)
        res = self.res_tree(self.res_flat)
        x0 = embed(res, ids, torch.arange(ids.shape[1], device=ids.device),
                   cfg)
        acts = self._forward(mask, cfg, x0)
        self._release_slots()
        return cross_entropy_loss(head_logits(res, acts[-1], cfg),
                                  self.labels_of(mb), mask)

    # -- whole leaves ---------------------------------------------------------
    def block_params(self, g: int) -> torch.Tensor:
        """Block ``g``'s params as a CPU tensor (read from its file on the
        nvme tier)."""
        if self.store is None:
            return self.params[g]
        buf, k = self.store.read_block(g)
        return buf.clone().view(self.dtype)

    def layer_leaf(self, kind: str, i: int) -> torch.Tensor:
        """Stack leaf ``i`` (L, *tail) of ``kind`` (params, master, m, v),
        assembled from the blocks on the host."""
        dtype = self.dtype if kind == "params" else torch.float32
        out = torch.empty((self.num_layers, *self.leaf_tails[i]),
                          dtype=dtype)
        for g, (lo, hi) in enumerate(self.bounds):
            src = (self.block_params(g) if kind == "params"
                   else getattr(self, kind)[g])
            out[lo:hi].copy_(src[self.leaf_slice(g, i)].view(
                hi - lo, *self.leaf_tails[i]))
        return out

    def full_params(self) -> Dict[str, Any]:
        """The whole params tree: the resident leaves (on the card) and the
        stack's leaves assembled on the host."""
        tree = self.res_tree(self.res_flat.detach().clone())
        for i, path in enumerate(self.layer_paths):
            tree_set(tree, ("layers",) + path, self.layer_leaf("params", i))
        return tree

    def leaf(self, kind: str, path: Path) -> torch.Tensor:
        """The whole leaf at ``path`` of ``kind`` (params, master, m, v)."""
        if path[0] == "layers":
            return self.layer_leaf(kind, self.layer_paths.index(path[1:]))
        at = 0
        for (p, shape), n in zip(self.res_items, self.res_numel):
            if p == path:
                buf = (self.res_flat if kind == "params"
                       else self.res_state(kind))
                return buf[at:at + n].view(shape)
            at += n
        raise KeyError(f"no param at {'/'.join(path)}")

    def res_state(self, kind: str) -> torch.Tensor:
        """The resident part's flat fp32 ``master`` / ``m`` / ``v``."""
        if kind == "master":
            return (self.res_master if self.res_master is not None
                    else self.res_flat)
        return {"m": self.res_m, "v": self.res_v}[kind]

    @property
    def skipped_steps(self) -> int:
        return self.attempts - self.step_count

    def close(self, remove: bool = False) -> None:
        if self.store is not None:
            self.store.close(remove)

