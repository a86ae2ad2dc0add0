"""Learning-rate schedules.

Counterpart of ``deepspeed_tpu/runtime/lr_schedules.py``: the families
LRRangeTest, OneCycle, WarmupLR, WarmupDecayLR and WarmupCosineLR with the
same parameter names, each a pure ``step -> lr`` function (``lr_at``) plus
the reference's stateful surface (``step()``, ``get_lr()``,
``state_dict()``). JAX evaluates the schedule inside its jitted step in
float32; here it is host math in Python floats, and the optimizer hands the
result to the Adam kernel as a host float.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Union

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
WARMUP_COSINE_LR = "WarmupCosineLR"

VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR,
                      WARMUP_COSINE_LR]


def _clip(x: float, lo: float, hi: float) -> float:
    return min(max(x, lo), hi)


class _Schedule:
    """Base: a stateful step counter over a pure ``lr_at(step)``."""

    def __init__(self, last_batch_iteration: int = -1):
        self.last_batch_iteration = last_batch_iteration

    def lr_at(self, step) -> float:
        raise NotImplementedError

    def step(self, last_batch_iteration: Optional[int] = None) -> None:
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration

    def get_lr(self) -> List[float]:
        return [float(self.lr_at(max(self.last_batch_iteration, 0)))]

    def get_last_lr(self) -> List[float]:
        return self.get_lr()

    def state_dict(self) -> Dict[str, Any]:
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.last_batch_iteration = sd["last_batch_iteration"]

    def __call__(self, step) -> float:
        return self.lr_at(step)


class LRRangeTest(_Schedule):
    """Linearly (or staircase) growing lr for range tests."""

    def __init__(self, lr_range_test_min_lr: float = 1e-3,
                 lr_range_test_step_size: int = 2000,
                 lr_range_test_step_rate: float = 1.0,
                 lr_range_test_staircase: bool = False,
                 last_batch_iteration: int = -1, **_ignored):
        super().__init__(last_batch_iteration)
        self.min_lr = lr_range_test_min_lr
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase

    def lr_at(self, step) -> float:
        interval = step / self.step_size
        if self.staircase:
            interval = math.floor(interval)
        return self.min_lr * (1.0 + interval * self.step_rate)


class OneCycle(_Schedule):
    """Two-phase cycle, then decay."""

    def __init__(self, cycle_min_lr: float, cycle_max_lr: float,
                 decay_lr_rate: float = 0.0,
                 cycle_first_step_size: int = 2000,
                 cycle_second_step_size: Optional[int] = None,
                 cycle_first_stair_count: int = 0,
                 cycle_second_stair_count: Optional[int] = None,
                 decay_step_size: int = 0, cycle_momentum: bool = True,
                 cycle_min_mom: float = 0.8, cycle_max_mom: float = 0.9,
                 decay_mom_rate: float = 0.0, last_batch_iteration: int = -1,
                 **_ignored):
        super().__init__(last_batch_iteration)
        self.cycle_min_lr = cycle_min_lr
        self.cycle_max_lr = cycle_max_lr
        self.decay_lr_rate = decay_lr_rate
        self.first_size = cycle_first_step_size
        self.second_size = (cycle_second_step_size
                            if cycle_second_step_size is not None
                            else cycle_first_step_size)
        self.decay_step_size = max(decay_step_size, 1)
        self.cycle_momentum = cycle_momentum
        self.cycle_min_mom = cycle_min_mom
        self.cycle_max_mom = cycle_max_mom
        self.decay_mom_rate = decay_mom_rate

    def _phase(self, step: float):
        up = min(step, self.first_size) / self.first_size
        down = _clip((step - self.first_size) / self.second_size, 0.0, 1.0)
        decay_steps = max(step - (self.first_size + self.second_size), 0.0)
        return up - down, decay_steps / self.decay_step_size

    def lr_at(self, step) -> float:
        step = float(step)
        cycle, decay = self._phase(step)
        if step <= self.first_size + self.second_size:
            return self.cycle_min_lr + (self.cycle_max_lr
                                        - self.cycle_min_lr) * cycle
        return self.cycle_min_lr / (1.0 + self.decay_lr_rate * decay)

    def mom_at(self, step) -> float:
        step = float(step)
        cycle, decay = self._phase(step)
        if step <= self.first_size + self.second_size:
            return self.cycle_max_mom - (self.cycle_max_mom
                                         - self.cycle_min_mom) * cycle
        return self.cycle_max_mom * (1.0 + self.decay_mom_rate * decay)


class WarmupLR(_Schedule):
    """warmup_min_lr -> warmup_max_lr over warmup_num_steps (log or
    linear), then constant."""

    def __init__(self, warmup_min_lr: float = 0.0,
                 warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                 warmup_type: str = "log", last_batch_iteration: int = -1,
                 **_ignored):
        super().__init__(last_batch_iteration)
        self.warmup_min_lr = warmup_min_lr
        self.warmup_max_lr = warmup_max_lr
        self.warmup_num_steps = max(warmup_num_steps, 2)
        if warmup_type not in ("log", "linear"):
            raise ValueError(f"warmup_type must be 'log' or 'linear', got "
                             f"{warmup_type}")
        self.warmup_type = warmup_type
        self.inverse_log_warm_up = 1.0 / math.log(self.warmup_num_steps)

    def _gamma(self, step: float) -> float:
        if self.warmup_type == "log":
            g = self.inverse_log_warm_up * math.log(max(step, 1.0) + 1.0)
        else:
            g = step / self.warmup_num_steps
        return min(g, 1.0)

    def lr_at(self, step) -> float:
        return self.warmup_min_lr + (self.warmup_max_lr
                                     - self.warmup_min_lr) * self._gamma(
                                         float(step))


class WarmupDecayLR(WarmupLR):
    """WarmupLR, then linear decay to 0 at total_num_steps."""

    def __init__(self, total_num_steps: int, warmup_min_lr: float = 0.0,
                 warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                 warmup_type: str = "log", last_batch_iteration: int = -1,
                 **_ignored):
        super().__init__(warmup_min_lr, warmup_max_lr, warmup_num_steps,
                         warmup_type, last_batch_iteration)
        self.total_num_steps = total_num_steps

    def lr_at(self, step) -> float:
        step = float(step)
        if step < self.warmup_num_steps:
            return super().lr_at(step)
        span = max(self.total_num_steps - self.warmup_num_steps, 1.0)
        return self.warmup_max_lr * _clip(
            (self.total_num_steps - step) / span, 0.0, 1.0)


class WarmupCosineLR(WarmupLR):
    """Warmup, then cosine decay to cos_min_ratio * warmup_max_lr."""

    def __init__(self, total_num_steps: int, warmup_min_lr: float = 0.0,
                 warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                 cos_min_ratio: float = 0.0001, warmup_type: str = "linear",
                 last_batch_iteration: int = -1, **_ignored):
        super().__init__(warmup_min_lr, warmup_max_lr, warmup_num_steps,
                         warmup_type, last_batch_iteration)
        self.total_num_steps = total_num_steps
        self.cos_min_ratio = cos_min_ratio

    def lr_at(self, step) -> float:
        step = float(step)
        if step < self.warmup_num_steps:
            return WarmupLR.lr_at(self, step)
        span = max(self.total_num_steps - self.warmup_num_steps, 1.0)
        progress = _clip((step - self.warmup_num_steps) / span, 0.0, 1.0)
        cos = 0.5 * (1.0 + math.cos(math.pi * progress))
        min_lr = self.cos_min_ratio * self.warmup_max_lr
        return min_lr + (self.warmup_max_lr - min_lr) * cos


_SCHEDULES = {
    LR_RANGE_TEST: LRRangeTest,
    ONE_CYCLE: OneCycle,
    WARMUP_LR: WarmupLR,
    WARMUP_DECAY_LR: WarmupDecayLR,
    WARMUP_COSINE_LR: WarmupCosineLR,
}


def build_lr_schedule(type_name: str, params: Dict[str, Any]) -> _Schedule:
    """Build from the config ``scheduler`` section."""
    if type_name not in _SCHEDULES:
        raise ValueError(f"unknown scheduler '{type_name}' (valid: "
                         f"{VALID_LR_SCHEDULES})")
    return _SCHEDULES[type_name](**params)


def constant_schedule(lr: float) -> Callable[[Any], float]:
    return lambda step: float(lr)


ScheduleLike = Union[_Schedule, Callable, float]


def as_schedule_fn(schedule: ScheduleLike) -> Callable:
    """Normalize a schedule / callable / float to a ``step -> lr``
    function."""
    if isinstance(schedule, (int, float)):
        return constant_schedule(float(schedule))
    return schedule
