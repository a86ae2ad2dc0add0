"""The training engine, data-parallel over ``torch.distributed`` with ZeRO
stages 0-3.

Counterpart of ``deepspeed_tpu/runtime/engine.py`` (``TrainEngine`` and
``initialize``). JAX traces one jitted SPMD step whose shardings make XLA
emit the collectives; here each step is eager PyTorch and the engine runs
the collectives itself (``comm``, NCCL on the card, gloo on the CPU):

  data parallel       -- every rank is given the same global micro-batch and
                         computes on its rows ``[r * mb, (r + 1) * mb)``, as
                         JAX shards the batch over ``data``; each loss is
                         scaled by ``1 / (gas * world)`` (and the fp16 loss
                         scale), so summing the ranks' grads averages them;
                         the returned loss is the mean over the ranks
  ZeRO                -- ``parallel/zero.py``: stages 0-1 all-reduce the
                         grads at the step; stage 2 reduce-scatters each
                         micro-batch's grads into the rank's fp32
                         accumulator, and the whole grad buffer lives only
                         through a backward; stage 3 gathers each layer's
                         params just before the layer runs (forward and
                         backward) and reduce-scatters its grads as the
                         backward leaves it
  forward / backward  -- autograd over ``model.loss_fn``; the flash and norm
                         wrappers carry their backward (the flash backward
                         is two CUDA kernels)
  grad accumulation   -- a Python loop over the gas micro-batches; 16-bit
                         grads are added into an fp32 buffer after each
  update              -- ``MixedPrecisionOptimizer.apply``: one fused Adam
                         (or LAMB phase-1) launch over the rank's shard of
                         the flat fp32 master, with the clip coefficient
                         (from the all-reduced norm), the fp16 unscale and
                         the overflow skip as device scalars; stages 1-3
                         then all-gather the updated params that are held
                         whole
  1-bit optimizers    -- ``onebitadam`` / ``onebitlamb`` / ``zerooneadam``
                         at stages 0-1 (JAX ``_build_onebit_train_step``):
                         each rank's grads (of ``loss / gas``) are averaged
                         densely while ``count < freeze_step`` (and, for
                         0/1 Adam, on its variance steps), else through the
                         error-feedback int8 exchange of
                         ``comm/compressed.py``, in JAX's leaf order; the
                         worker and server residuals are the engine's and
                         are not checkpointed, as in JAX
  offload             -- ``zero_optimization.offload_optimizer.device``
                         ``cpu`` keeps the master and moments in host
                         memory (``runtime/offload.py``), ``nvme`` in swap
                         files (``runtime/swap``); the update runs on the
                         host in sub-groups of ``sub_group_size``
  parameter offload   -- ``zero_optimization.offload_param.device`` ``cpu``
                         / ``nvme`` at stage 3, world 1: no params are
                         built on the card; ``runtime/param_offload.py``
                         keeps the layer stack and all of its state off
                         it, streams blocks of layers through it and owns
                         the step, eval and checkpoints (the staged
                         forward / backward / step raise)
  fp16                -- the dynamic loss scale lives on the device
  checkpoints         -- ``runtime/checkpoint.py``: the JAX package's
                         format 2, written and read by both packages, at any
                         world and stage

``train_batch`` returns the mean of the micro losses as a device tensor and
reads nothing back from the device except at ``steps_per_print`` (and,
under offload, the one scalar sync of the host update). MoE models
(``moe_num_experts > 0``) train with the Adam family at any world, ZeRO
stages 0-3 (``check_moe``): the gating spans every rank's tokens, and with
``parallel.expert_parallel_size`` ep > 1 (stages 0-2) a rank holds only its
E / ep banks and their optimizer state (``parallel/topology.py`` lays the
ranks out as JAX's mesh does; at world > 1 the loss gets the rank's
``moe_groups``).
Not ported yet (they raise): MoE with parameter or optimizer offload,
LAMB or the 1-bit optimizers, expert parallelism at stage 3, Random Token
Selection beyond one rank; parameter offload at world > 1, optimizer
offload beside LAMB or the 1-bit optimizers, the NVMe tier in fp16,
tensor / pipeline / sequence parallelism, activation checkpointing,
dropout /
progressive layer drop / random-LTD, compression, curriculum,
observability, and optimizers other than the Adam family, LAMB and the
1-bit family.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

import torch

from .. import comm
from ..comm.comms_logging import configure_comms_logger
from ..comm.compressed import compressed_allreduce_flat, padded_length
from ..config.config import ONEBIT_OPTIMIZERS, Config, load_config
from ..inference.engine import resolve_device
from ..models.core import (Model, cast_floating, param_count, tree_get,
                           tree_map, tree_set)
from ..models.transformer import expert_axes
from ..parallel.topology import Topology, build_groups
from ..parallel.zero import ZeroParams, ZeroPartition, sharded
from ..utils.logging import log_dist
from .checkpoint import load_engine, save_engine, save_flat_weights
from .dataloader import DeepSpeedDataLoader, RepeatingLoader
from .loss_scaler import LossScaleState, create_loss_scaler
from .lr_schedules import build_lr_schedule
from .offload import HostOptimizerState, gather_spans, scatter_spans
from .optimizer import (MixedPrecisionOptimizer, StepStats, build_optimizer,
                        zero_one_var_step)
from .param_offload import ParamOffloadExecutor, check_param_offload
from .swap import NVMeOptimizerSwapper

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def check_moe(model_cfg: Any, config: Config, world: int) -> None:
    """MoE trains with the Adam family at any world, at ZeRO stages 0-3
    (expert parallelism at 0-2, ``Config.check_ported``). JAX's
    ``ValueError`` for experts that an expert-parallel degree does not
    divide comes first (JAX ``engine.py:263-272``); the rest raise
    ``NotImplementedError`` naming themselves."""
    experts = getattr(model_cfg, "moe_num_experts", 0) or 0
    ep = config.parallel.expert_parallel_size
    if ep > 1 and experts and experts % ep != 0:
        raise ValueError(f"moe_num_experts={experts} must be divisible by "
                         f"expert_parallel_size={ep}")
    if not experts:
        return
    missing = []
    if world > 1 and getattr(model_cfg, "moe_use_rts", False):
        missing.append(f"MoE with moe_use_rts at world {world} (every rank "
                       "would draw its own priorities for the global plan)")
    zero = config.zero_optimization
    if zero.offload_param.device != "none":
        missing.append("MoE with zero_optimization.offload_param (the aux "
                       "loss through the streamed executor)")
    if zero.offload_optimizer.device != "none":
        missing.append("MoE with zero_optimization.offload_optimizer")
    opt = config.optimizer.type.lower()
    if opt == "lamb" or opt in ONEBIT_OPTIMIZERS:
        missing.append(f"MoE with optimizer '{opt}' (MoE trains with the "
                       "Adam family)")
    if missing:
        raise NotImplementedError(
            "not ported to deepspeed_tpu_torch yet: " + "; ".join(missing))


class TrainEngine:
    """Owns the rank's params and optimizer shard (``zero``, ``opt_state``),
    the loss-scale state, and the step."""

    def __init__(self, model: Model, config: Config,
                 optimizer: Optional[MixedPrecisionOptimizer] = None,
                 lr_scheduler=None, training_data=None, collate_fn=None,
                 device: Union[None, str, torch.device] = None):
        check_moe(model.config, config, comm.get_world_size())
        check_param_offload(config, comm.get_world_size())
        config.check_ported()
        if model.loss_fn is None:
            raise ValueError("model.loss_fn is required for training")
        if getattr(model.config, "dropout", 0.0) > 0.0:
            # the JAX engine turns dropout on when the rate is > 0
            raise NotImplementedError("dropout is not ported yet")
        self.device = resolve_device(device)
        self.world, self.rank = comm.get_world_size(), comm.get_rank()
        if (comm.is_initialized()
                and comm.comm_device().type != self.device.type):
            raise ValueError(
                f"the process group reduces {comm.comm_device().type} "
                f"tensors but the engine runs on {self.device}")
        dp = config.parallel.data_parallel_size
        if dp not in (0, self.world):
            raise ValueError(f"parallel.data_parallel_size={dp} but the "
                             f"process group has {self.world} rank(s)")
        self.topology = Topology(self.world,
                                 config.parallel.expert_parallel_size,
                                 self.rank)
        self.moe_groups = None
        self.model = model
        self.config = config.resolve_batch_sizes(self.world)
        configure_comms_logger(self.config.comms_logger,
                               world_size=self.world)
        self.compute_dtype = _DTYPES[self.config.precision_dtype]
        model_dtype = getattr(model.config, "dtype", self.compute_dtype)
        if model_dtype != self.compute_dtype:
            # torch does not promote mixed matmuls as JAX does
            raise ValueError(
                f"the model computes in {model_dtype} but the config trains "
                f"in {self.config.precision_dtype}: create the model with "
                f"dtype={self.compute_dtype}")
        fp16 = self.config.fp16
        self.loss_scaler = create_loss_scaler(
            fp16_enabled=fp16.enabled, dynamic=fp16.dynamic_loss_scale,
            static_scale=fp16.loss_scale or 1.0,
            initial_scale_power=fp16.initial_scale_power,
            scale_window=fp16.loss_scale_window,
            min_scale=fp16.min_loss_scale, hysteresis=fp16.hysteresis)

        self.lr_scheduler = lr_scheduler
        if self.lr_scheduler is None and self.config.scheduler is not None:
            self.lr_scheduler = build_lr_schedule(
                self.config.scheduler.type, self.config.scheduler.params)
        self.optimizer = (optimizer if optimizer is not None else
                          build_optimizer(self.config, self.lr_scheduler))
        self._param_offload: Optional[ParamOffloadExecutor] = None
        self._onebit = None
        self._grad_acc = None
        if self.config.zero_optimization.offload_param.device != "none":
            # the executor draws the params, keeps the layer stack and all
            # of its state off the card, and runs the step
            self._param_offload = ParamOffloadExecutor(
                model, self.config, self.optimizer, self.loss_scaler,
                self.device, self.compute_dtype)
            self.partition = self.zero = self.opt_state = None
            self.scaler_state = self._param_offload.scaler_state
            described = (f"{self._param_offload.n_params / 1e6:.1f}M params, "
                         f"parameter offload to "
                         f"{self._param_offload.tier} in "
                         f"{self._param_offload.num_blocks} blocks")
        else:
            self._build_state()
            described = (f"{param_count(self.zero.params) / 1e6:.1f}M "
                         f"whole params on each rank, "
                         f"{self.partition.describe()}")
        gas = self.gradient_accumulation_steps()

        self.training_dataloader = None
        if training_data is not None:
            # every rank loads the global micro-batch and keeps its rows
            self.training_dataloader = DeepSpeedDataLoader(
                training_data,
                batch_size=self.train_micro_batch_size_per_gpu() * self.world,
                collate_fn=collate_fn, seed=self.config.seed)

        self.global_steps = 0
        self.micro_steps = 0
        self._skipped_base = 0
        self._staged_count = 0
        self._pending_loss: Optional[torch.Tensor] = None
        self._last_lr = float(self.config.optimizer.params.get("lr", 0.0))
        self._window = (time.time(), 0)
        log_dist(f"engine ready: {described}, "
                 f"dtype={self.config.precision_dtype}, device={self.device}, "
                 f"micro_batch={self.train_micro_batch_size_per_gpu()}, "
                 f"gas={gas}")

    def _build_state(self) -> None:
        """The rank's params and optimizer state on the device: every rank
        draws the same initial params from the seed and keeps its part of
        them."""
        model = self.model
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.config.seed)
        params = tree_map(lambda t: t.to(self.device),
                          cast_floating(model.init(gen), self.compute_dtype))
        experts = {}
        if getattr(model.config, "moe_num_experts", 0):
            # the layers' process groups: global gating, and the rank's
            # banks of the same seeded tree under expert parallelism
            self.moe_groups = build_groups(self.topology)
            if self.topology.ep > 1:
                experts = expert_axes(model.config, params)
                lo, hi = self.topology.banks(model.config.moe_num_experts)
                for path, axis in experts.items():
                    tree_set(params, path, tree_get(params, path).narrow(
                        axis, lo, hi - lo))
        zcfg = self.config.zero_optimization
        self.partition = ZeroPartition.build(
            self.config.zero_stage, params, self.world, self.rank,
            zcfg.stage3_param_persistence_threshold,
            topology=self.topology, experts=experts)
        self.zero = ZeroParams(self.partition, params, self.compute_dtype,
                               self.device, self.moe_groups)
        stage3 = sharded(self.config.zero_stage, "params")
        sizes, ids = self.partition.rank_segments(self.rank)
        self.opt_state = self.optimizer.init_shard(
            self.zero.shard, partitioned=self.partition.units[0].parts > 1,
            layout=(sizes, ids, len(self.partition.leaf_pieces())),
            offload=self._make_offload())
        self.opt_state.expert_norm = self.zero.expert_norm()
        if not stage3:
            self.opt_state.params = self.zero.params
            self.opt_state.param_flat = self.zero.whole
            self.opt_state.grads = tree_map(lambda t: t.grad,
                                            self.zero.params)
            self.opt_state.grad_flat = self.zero.grad_whole
        if self.config.optimizer.type.lower() in ONEBIT_OPTIMIZERS:
            self._onebit = self._onebit_state()
        del params
        self.scaler_state: LossScaleState = self.loss_scaler.init(self.device)
        gas = self.gradient_accumulation_steps()
        self._grad_acc = (torch.zeros(self.zero.whole.numel(),
                                      dtype=torch.float32, device=self.device)
                          if gas > 1 and self.compute_dtype != torch.float32
                          and self.zero.acc is None else None)
        self.zero.release_grads()

    # -- config accessors -------------------------------------------------
    @property
    def params(self) -> Any:
        """The whole params: views of the flat buffer at stages 0-2, copies
        gathered from every rank at stage 3 (a collective there), under
        parameter offload the resident leaves with the layer stack
        assembled on the host."""
        if self._param_offload is not None:
            return self._param_offload.full_params()
        return self.zero.full_params()

    def train_batch_size(self) -> int:
        return self.config.train_batch_size

    def train_micro_batch_size_per_gpu(self) -> int:
        return self.config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self) -> int:
        return self.config.gradient_accumulation_steps

    def steps_per_print(self) -> int:
        return self.config.steps_per_print

    def zero_optimization_stage(self) -> int:
        return self.config.zero_stage

    def gradient_clipping(self) -> float:
        return self.config.gradient_clipping

    def fp16_enabled(self) -> bool:
        return self.config.fp16.enabled

    def bfloat16_enabled(self) -> bool:
        return self.config.bf16.enabled

    def wall_clock_breakdown(self) -> bool:
        return self.config.wall_clock_breakdown

    def get_lr(self) -> List[float]:
        if self.lr_scheduler is not None and hasattr(self.lr_scheduler,
                                                     "get_last_lr"):
            return self.lr_scheduler.get_last_lr()
        return [float(self.optimizer.lr_schedule(self.global_steps))]

    def get_global_step(self) -> int:
        return self.global_steps

    @property
    def cur_scale(self) -> float:
        return float(self.scaler_state.scale)

    @property
    def skipped_steps(self) -> int:
        """Overflow-skipped steps (reading it may wait for the last step's
        overflow flag)."""
        return self._skipped_base + self._skipped()

    @skipped_steps.setter
    def skipped_steps(self, value: int) -> None:
        self._skipped_base = value - self._skipped()

    def _skipped(self) -> int:
        if self._param_offload is not None:
            return self._param_offload.skipped_steps
        return self.optimizer.skipped_steps(self.opt_state)

    # -- data -------------------------------------------------------------
    def _tensor(self, x: Any) -> torch.Tensor:
        t = torch.as_tensor(x)
        if not t.is_floating_point() and t.dtype != torch.bool:
            t = t.long()
        if t.device == self.device:
            return t
        if self.device.type == "cuda" and t.device.type == "cpu":
            # pinned + non-blocking: the copy does not wait for the stream
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _to_device(self, batch: Any) -> Any:
        if isinstance(batch, dict):
            return {k: self._to_device(v) for k, v in batch.items()}
        return self._tensor(batch)

    def _local(self, batch: Any) -> Any:
        """This rank's rows of a global micro-batch (world * micro_batch
        rows), on the device."""
        if self.world == 1:
            return self._to_device(batch)
        mb = self.train_micro_batch_size_per_gpu()

        def rows(x):
            x = torch.as_tensor(x)
            if x.shape[0] != mb * self.world:
                raise ValueError(
                    f"a global micro-batch has micro_batch {mb} x world "
                    f"{self.world} = {mb * self.world} rows, got "
                    f"{x.shape[0]}")
            return x[self.rank * mb:(self.rank + 1) * mb]

        return self._to_device(tree_map(rows, batch))

    def _micro_batches(self, data_iter: Optional[Iterable],
                       batch: Optional[Any]) -> List[Dict[str, Any]]:
        gas = self.gradient_accumulation_steps()
        if batch is None:
            source = (data_iter if data_iter is not None
                      else self.training_dataloader)
            if source is None:
                raise ValueError("no data: pass batch=, data_iter=, or "
                                 "training_data")
            it = source if hasattr(source, "__next__") else iter(source)
            micros = [next(it) for _ in range(gas)]
        else:
            first = next(iter(batch.values())) if isinstance(batch, dict) \
                else batch
            if first.shape[0] != gas:
                raise ValueError(
                    f"batch leading dim {first.shape[0]} != "
                    f"gradient_accumulation_steps {gas}; shape must be "
                    "(gas, micro_batch, ...)")
            micros = [tree_map(lambda x, i=i: x[i], batch)
                      for i in range(gas)]
        return [self._local(mb) for mb in micros]

    # -- the step -----------------------------------------------------------
    def _loss(self, batch: Dict[str, Any]) -> torch.Tensor:
        params = (self.zero.step_params()
                  if sharded(self.config.zero_stage, "params")
                  else self.zero.params)
        if self.moe_groups is not None and self.world > 1:
            # one rank's plan is the global one: a loss of two arguments
            # serves there
            return self.model.loss_fn(params, batch,
                                      moe_groups=self.moe_groups)
        return self.model.loss_fn(params, batch)

    def _backward(self, loss: torch.Tensor) -> None:
        """Grads of ``loss * scale / (gas * world)``: into the flat grad
        buffer (stages 0-1; 16-bit grads then move into the fp32
        accumulator), or reduce-scattered into the rank's fp32 accumulator
        (stages 2-3)."""
        scaled = (loss * self.scaler_state.scale if self.fp16_enabled()
                  else loss)
        self.zero.acquire_grads()
        # the 1-bit exchange averages each rank's own grads, as JAX does
        ranks = 1 if self._onebit is not None else self.world
        (scaled / (self.gradient_accumulation_steps() * ranks)).backward()
        self.zero.release_all()
        if self.zero.acc is not None:
            self.zero.reduce_persistent_grads()
            self.zero.release_grads()
        elif self._grad_acc is not None:
            self._grad_acc.add_(self.zero.grad_whole)
            self.zero.grad_whole.zero_()

    def _make_offload(self):
        """The optimizer-state tier of ``offload_optimizer.device``: None
        (on the device), host memory, or NVMe swap files."""
        zcfg = self.config.zero_optimization
        tier = zcfg.offload_optimizer.device
        if tier == "cpu":
            return HostOptimizerState(self.zero.shard, zcfg.sub_group_size)
        if tier == "nvme":
            swapper = NVMeOptimizerSwapper(
                os.path.join(zcfg.offload_optimizer.nvme_path,
                             f"dstpu_swap_p{self.rank}"),
                self.partition, self.rank, zcfg.sub_group_size,
                self.config.aio)
            swapper.init_from_shard(self.zero.shard)
            return swapper
        return None

    def _onebit_state(self) -> Dict[str, Any]:
        """The 1-bit exchange's settings and error-feedback residuals: the
        worker's over the padded flat grads (JAX ``npad``), the server's
        over this rank's chunk of it, and the flat buffer's leaves in JAX's
        order (sorted paths), which sets the chunks."""
        params = self.config.optimizer.params
        unit = self.partition.units[0]
        n = unit.numel
        npad = padded_length(n, self.world)
        order = sorted(((pc.path, pc.offset, pc.numel) for pc in unit.pieces))
        spans = [(off, size) for _, off, size in order]
        zero_one = self.optimizer.zero_one
        return dict(
            n=n, npad=npad, freeze=int(params.get("freeze_step", 100)),
            zero_one=zero_one,
            spans=None if spans == sorted(spans) else spans,
            worker=torch.zeros(npad, dtype=torch.float32,
                               device=self.device),
            server=torch.zeros(npad // self.world, dtype=torch.float32,
                               device=self.device))

    def _onebit_average(self, full: torch.Tensor) -> torch.Tensor:
        """The mean over the ranks of every rank's flat grads ``full`` as an
        fp32 buffer of ``full``'s length: dense during the warm-up (and on
        0/1 Adam's variance steps), else compressed."""
        ob = self._onebit
        count = self.opt_state.count
        dense = count < ob["freeze"] or (
            ob["zero_one"] is not None
            and zero_one_var_step(count, *ob["zero_one"]))
        n, npad, spans = ob["n"], ob["npad"], ob["spans"]
        size = max(full.numel(), npad)
        vec = torch.zeros(size if spans is None else npad,
                          dtype=torch.float32, device=full.device)
        if spans is None:
            vec[:n].copy_(full[:n])
        else:
            gather_spans(full, spans, out=vec[:n])
        if dense:
            comm.all_reduce(vec[:npad], op=comm.ReduceOp.AVG,
                            log_name="onebit_dense_all_reduce")
        else:
            # the residuals are updated in place and the mean overwrites vec
            compressed_allreduce_flat(vec[:npad], ob["worker"], ob["server"],
                                      out=vec[:npad])
        if spans is None:
            return vec[:full.numel()]
        avg = torch.zeros(size, dtype=torch.float32, device=full.device)
        scatter_spans(avg, spans, vec[:n])
        return avg[:full.numel()]

    def _apply(self) -> StepStats:
        """The optimizer step over the rank's accumulated grads (all-reduced
        first at stages 0-1, through the 1-bit exchange for those
        optimizers), the params held whole gathered back, the loss-scale
        update, and the grads zeroed for the next step."""
        if self.zero.acc is not None:
            grads = full = self.zero.acc
        elif self._onebit is not None:
            full = (self._grad_acc if self._grad_acc is not None
                    else self.zero.grad_whole)
            lo, hi = self.partition.rank_range(0, self.rank)
            grads = self._onebit_average(full)[lo:hi]
        else:
            full = (self._grad_acc if self._grad_acc is not None
                    else self.zero.grad_whole)
            grads = self.zero.reduce_grads(full)
        fp16 = self.fp16_enabled()
        stats = self.optimizer.apply(
            self.opt_state, grads,
            grad_scale=1.0 / self.scaler_state.scale if fp16 else None,
            overflow_check=fp16)
        self.zero.gather_persistent()
        self.scaler_state = self.loss_scaler.update(self.scaler_state,
                                                    stats.skipped)
        full.zero_()
        return stats

    def train_batch(self, data_iter: Optional[Iterable] = None,
                    batch: Optional[Any] = None) -> torch.Tensor:
        """One full step over gas global micro-batches, from ``batch``
        (leaves shaped (gas, world * micro_batch, ...)) or from
        ``data_iter`` / the training dataloader. Returns the mean micro loss
        over the ranks, a device tensor."""
        micros = self._micro_batches(data_iter, batch)
        if self._param_offload is not None:
            # the host-driven segmented step streams the layer blocks
            mean, stats = self._param_offload.train_step(micros)
            self.scaler_state = self._param_offload.scaler_state
            self.micro_steps += len(micros)
            self._end_step(stats, mean)
            return mean
        losses = []
        for mb in micros:
            loss = self._loss(mb)
            self._backward(loss)
            losses.append(loss.detach().float())
        stats = self._apply()
        mean = comm.all_reduce(torch.stack(losses).mean(),
                               op=comm.ReduceOp.AVG, log_name="loss")
        self.micro_steps += len(micros)
        self._end_step(stats, mean)
        return mean

    def _end_step(self, stats: StepStats,
                  loss: Optional[torch.Tensor] = None) -> None:
        """Count the step, advance the scheduler, and log the loss (a host
        read) every ``steps_per_print`` steps of ``train_batch``."""
        self.global_steps += 1
        self._last_lr = stats.lr
        if self.lr_scheduler is not None and hasattr(self.lr_scheduler,
                                                     "step"):
            self.lr_scheduler.step()
        start, steps = self._window
        self._window = (start, steps + 1)
        if (loss is not None
                and self.global_steps % self.steps_per_print() == 0):
            wall = time.time() - start
            streamed = ""
            if self._param_offload is not None:
                st = self._param_offload.last_step_stats
                streamed = (f" h2d={st['achieved_h2d_gbps']:.2f}GB/s "
                            f"total={st['achieved_total_gbps']:.2f}GB/s")
            log_dist(f"step={self.global_steps} loss={float(loss):.4f} "
                     f"lr={self._last_lr:.3e} "
                     f"grad_norm={float(stats.grad_norm):.3f} "
                     f"skipped={self.skipped_steps} throughput="
                     f"{(steps + 1) * self.train_batch_size() / wall:.1f} "
                     f"samples/s{streamed}")
            self._window = (time.time(), 0)

    # -- staged forward / backward / step ------------------------------------
    def forward(self, batch: Any) -> torch.Tensor:
        """The loss of this rank's rows of a global micro-batch;
        ``backward()`` then ``step()`` complete the reference's three-call
        protocol."""
        self._no_staged_protocol()
        self._pending_loss = self._loss(self._local(batch))
        return self._pending_loss

    def backward(self, loss: Optional[torch.Tensor] = None) -> None:
        """Accumulate the grads of the loss ``forward`` returned."""
        self._no_staged_protocol()
        if self._pending_loss is None:
            raise RuntimeError("backward() called before forward()")
        self._backward(self._pending_loss)
        self._pending_loss = None
        self._staged_count += 1
        self.micro_steps += 1

    def is_gradient_accumulation_boundary(self) -> bool:
        return self._staged_count >= self.gradient_accumulation_steps()

    def step(self) -> None:
        """Apply the optimizer at the gas boundary."""
        self._no_staged_protocol()
        if not self.is_gradient_accumulation_boundary():
            return
        self._staged_count = 0
        self._end_step(self._apply())

    def _no_staged_protocol(self) -> None:
        if self._param_offload is not None:
            raise RuntimeError(
                "offload_param drives the whole step from train_batch (the "
                "host streaming loop owns fwd/bwd/update) — the staged "
                "forward/backward/step protocol is not available")

    @torch.no_grad()
    def eval_loss(self, batch: Any) -> torch.Tensor:
        """The eval loss of the whole ``batch`` on every rank. Under expert
        parallelism a rank holds only its banks: each computes its rows
        ``[r * n / world, (r + 1) * n / world)`` with the global gating of
        training, and the ranks' losses are averaged (a collective)."""
        if self._param_offload is not None:
            return self._param_offload.eval_forward(self._to_device(batch))
        fn = self.model.eval_loss_fn or self.model.loss_fn
        params = (self.zero.step_params()
                  if sharded(self.config.zero_stage, "params")
                  else self.zero.params)
        if self.moe_groups is not None and self.topology.ep > 1:
            out = fn(params, self._eval_rows(batch),
                     moe_groups=self.moe_groups)
            out = comm.all_reduce(out.float(), op=comm.ReduceOp.AVG,
                                  log_name="eval_loss")
        else:
            out = fn(params, self._to_device(batch))
        self.zero.release_all()
        return out

    def _eval_rows(self, batch: Any) -> Any:
        """This rank's equal share of an eval batch's rows, on the
        device."""
        def rows(x):
            x = torch.as_tensor(x)
            if x.shape[0] % self.world:
                raise ValueError(
                    f"under expert parallelism an eval batch splits over "
                    f"the {self.world} ranks: {x.shape[0]} rows do not")
            n = x.shape[0] // self.world
            return x[self.rank * n:(self.rank + 1) * n]

        return self._to_device(tree_map(rows, batch))

    # -- checkpointing (JAX engine.py:1829 / :1894 / :2010) ------------------
    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[Dict] = None,
                        save_latest: bool = True,
                        async_save: Optional[bool] = None) -> str:
        """Write the params, the optimizer state and the step counters in
        the JAX package's format 2 under ``save_dir/tag`` (default
        ``global_step<N>``); each rank writes its own part. Returns the tag
        directory. A collective: every rank calls it."""
        if async_save is None:
            async_save = self.config.checkpoint.async_save
        return save_engine(self, save_dir, tag, client_state, save_latest,
                           async_save)

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                        load_optimizer_states: bool = True,
                        load_lr_scheduler_states: bool = True,
                        verify: bool = False
                        ) -> Tuple[Optional[str], Dict]:
        """Restore from a format-2 checkpoint written by either package, at
        any world and stage; ``verify`` re-hashes the shards first and falls
        back to the newest tag that verifies. Returns (load_dir, client
        state), or (None, {}) when there is nothing to load."""
        return load_engine(self, load_dir, tag, load_optimizer_states,
                           load_lr_scheduler_states, verify)

    def save_16bit_model(self, save_dir: str,
                         save_filename: str = "model_fp16.npz") -> str:
        """The whole params in the compute dtype as the JAX package's flat
        npz (rank 0 writes; a collective at stage 3)."""
        path = os.path.join(save_dir, save_filename)
        params = self.params
        if self.rank == 0:
            os.makedirs(save_dir, exist_ok=True)
            save_flat_weights(params, path)
        comm.barrier()
        return path


def initialize(args=None, model: Optional[Model] = None, optimizer=None,
               model_parameters=None, training_data=None, lr_scheduler=None,
               config=None, collate_fn=None,
               device: Union[None, str, torch.device] = None
               ) -> Tuple[TrainEngine, Any, Any, Any]:
    """Counterpart of ``deepspeed_tpu.initialize``: returns (engine,
    optimizer, training dataloader, lr scheduler). Runs on CUDA unless
    ``device="cpu"``."""
    if model is None:
        raise ValueError("model is required (a deepspeed_tpu_torch.models."
                         "Model bundle)")
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    engine = TrainEngine(model=model, config=load_config(config),
                         optimizer=optimizer, lr_scheduler=lr_scheduler,
                         training_data=training_data, collate_fn=collate_fn,
                         device=device)
    loader = engine.training_dataloader
    if loader is not None:
        loader = RepeatingLoader(loader)
    return engine, engine.optimizer, loader, engine.lr_scheduler
