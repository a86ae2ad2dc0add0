"""The single-device training engine.

Counterpart of ``deepspeed_tpu/runtime/engine.py`` (``TrainEngine`` and
``initialize``) on one GPU. JAX traces one jitted step; here each step is
eager PyTorch:

  forward / backward  -- autograd over ``model.loss_fn``; the flash and norm
                         wrappers carry their backward (the flash backward
                         is two CUDA kernels)
  grad accumulation   -- a Python loop over the gas micro-batches, each
                         loss scaled by ``1 / gas`` (and the fp16 loss
                         scale); grads accumulate in the optimizer's flat
                         grad buffer, in fp32 across micro-batches (16-bit
                         grads are added into an fp32 buffer after each)
  update              -- ``MixedPrecisionOptimizer.apply``: one fused Adam
                         (or LAMB phase-1) launch over the flat fp32
                         master, with the clip
                         coefficient, the fp16 unscale and the overflow skip
                         as device scalars
  fp16                -- the dynamic loss scale lives on the device

``train_batch`` returns the mean of the micro losses as a device tensor and
reads nothing back from the device except at ``steps_per_print``.

On one device there is no data-parallel group, so ZeRO stages 0-3 all do
the same math (JAX ``tests/unit/test_engine.py:55`` holds its stages to the
same trajectory) and are accepted. Not ported yet (they raise):
checkpointing (``save_checkpoint``, ``load_checkpoint``,
``save_16bit_model``), offload, world size > 1, activation checkpointing,
dropout / progressive layer drop / random-LTD, compression, curriculum,
observability, and optimizers other than the Adam family and LAMB.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

import torch

from ..config.config import Config, load_config
from ..inference.engine import resolve_device
from ..models.core import Model, cast_floating, param_count, tree_map
from ..utils.logging import log_dist
from .dataloader import DeepSpeedDataLoader, RepeatingLoader
from .loss_scaler import LossScaleState, create_loss_scaler
from .lr_schedules import build_lr_schedule
from .optimizer import MixedPrecisionOptimizer, StepStats, build_optimizer

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


class TrainEngine:
    """Owns the params (views of the optimizer's flat buffer), the
    optimizer and loss-scale state, and the step."""

    def __init__(self, model: Model, config: Config,
                 optimizer: Optional[MixedPrecisionOptimizer] = None,
                 lr_scheduler=None, training_data=None, collate_fn=None,
                 device: Union[None, str, torch.device] = None):
        config.check_ported()
        if model.loss_fn is None:
            raise ValueError("model.loss_fn is required for training")
        if getattr(model.config, "dropout", 0.0) > 0.0:
            # the JAX engine turns dropout on when the rate is > 0
            raise NotImplementedError("dropout is not ported yet")
        self.device = resolve_device(device)
        self.model = model
        self.config = config.resolve_batch_sizes(1)
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

        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.config.seed)
        params = tree_map(lambda t: t.to(self.device),
                          cast_floating(model.init(gen), self.compute_dtype))
        self.opt_state = self.optimizer.init(params)
        del params
        self.scaler_state: LossScaleState = self.loss_scaler.init(self.device)
        gas = self.gradient_accumulation_steps()
        self._grad_acc = (torch.zeros(self.opt_state.n, dtype=torch.float32,
                                      device=self.device)
                          if gas > 1 and self.compute_dtype != torch.float32
                          else None)

        self.training_dataloader = None
        if training_data is not None:
            self.training_dataloader = DeepSpeedDataLoader(
                training_data,
                batch_size=self.train_micro_batch_size_per_gpu(),
                collate_fn=collate_fn, seed=self.config.seed)

        self.global_steps = 0
        self.micro_steps = 0
        self._skipped_base = 0
        self._staged_count = 0
        self._pending_loss: Optional[torch.Tensor] = None
        self._last_lr = float(self.config.optimizer.params.get("lr", 0.0))
        self._window = (time.time(), 0)
        log_dist(f"engine ready: {param_count(self.params) / 1e6:.1f}M "
                 f"params, zero_stage={self.config.zero_stage}, "
                 f"dtype={self.config.precision_dtype}, device={self.device}, "
                 f"micro_batch={self.train_micro_batch_size_per_gpu()}, "
                 f"gas={gas}")

    # -- config accessors -------------------------------------------------
    @property
    def params(self) -> Any:
        return self.opt_state.params

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
        return self._skipped_base + self.optimizer.skipped_steps(
            self.opt_state)

    @skipped_steps.setter
    def skipped_steps(self, value: int) -> None:
        self._skipped_base = value - self.optimizer.skipped_steps(
            self.opt_state)

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
        return [self._to_device(mb) for mb in micros]

    # -- the step -----------------------------------------------------------
    def _loss(self, batch: Dict[str, Any]) -> torch.Tensor:
        return self.model.loss_fn(self.params, batch)

    def _backward(self, loss: torch.Tensor) -> None:
        """Grads of ``loss * scale / gas`` into the flat grad buffer; 16-bit
        grads then move into the fp32 accumulator."""
        scaled = (loss * self.scaler_state.scale if self.fp16_enabled()
                  else loss)
        (scaled / self.gradient_accumulation_steps()).backward()
        if self._grad_acc is not None:
            self._grad_acc.add_(self.opt_state.grad_flat)
            self.opt_state.grad_flat.zero_()

    def _apply(self) -> StepStats:
        """The optimizer step over the accumulated grads, the loss-scale
        update, and the grads zeroed for the next step."""
        grads = (self._grad_acc if self._grad_acc is not None
                 else self.opt_state.grad_flat)
        fp16 = self.fp16_enabled()
        stats = self.optimizer.apply(
            self.opt_state, grads,
            grad_scale=1.0 / self.scaler_state.scale if fp16 else None,
            overflow_check=fp16)
        self.scaler_state = self.loss_scaler.update(self.scaler_state,
                                                    stats.skipped)
        grads.zero_()
        return stats

    def train_batch(self, data_iter: Optional[Iterable] = None,
                    batch: Optional[Any] = None) -> torch.Tensor:
        """One full step over gas micro-batches, from ``batch`` (leaves
        shaped (gas, micro_batch, ...)) or from ``data_iter`` / the
        training dataloader. Returns the mean micro loss, a device
        tensor."""
        micros = self._micro_batches(data_iter, batch)
        losses = []
        for mb in micros:
            loss = self._loss(mb)
            self._backward(loss)
            losses.append(loss.detach().float())
        stats = self._apply()
        mean = torch.stack(losses).mean()
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
            log_dist(f"step={self.global_steps} loss={float(loss):.4f} "
                     f"lr={self._last_lr:.3e} "
                     f"grad_norm={float(stats.grad_norm):.3f} "
                     f"skipped={self.skipped_steps} throughput="
                     f"{(steps + 1) * self.train_batch_size() / wall:.1f} "
                     "samples/s")
            self._window = (time.time(), 0)

    # -- staged forward / backward / step ------------------------------------
    def forward(self, batch: Any) -> torch.Tensor:
        """The micro-batch loss; ``backward()`` then ``step()`` complete the
        reference's three-call protocol."""
        self._pending_loss = self._loss(self._to_device(batch))
        return self._pending_loss

    def backward(self, loss: Optional[torch.Tensor] = None) -> None:
        """Accumulate the grads of the loss ``forward`` returned."""
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
        if not self.is_gradient_accumulation_boundary():
            return
        self._staged_count = 0
        self._end_step(self._apply())

    @torch.no_grad()
    def eval_loss(self, batch: Any) -> torch.Tensor:
        fn = self.model.eval_loss_fn or self.model.loss_fn
        return fn(self.params, self._to_device(batch))

    # -- checkpointing: the ZeRO / checkpoint slice --------------------------
    def save_checkpoint(self, *args, **kwargs):
        raise NotImplementedError("checkpointing is not ported yet")

    def load_checkpoint(self, *args, **kwargs):
        raise NotImplementedError("checkpointing is not ported yet")

    def save_16bit_model(self, *args, **kwargs):
        raise NotImplementedError("checkpointing is not ported yet")


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
