"""Static and dynamic loss scaling for fp16 training.

Counterpart of ``deepspeed_tpu/runtime/loss_scaler.py``. The state is three
device scalars (scale, consecutive good steps, remaining hysteresis) and
``update`` is pure ``torch.where`` arithmetic on them, so the scale follows
overflows on the device without the host reading anything:

    state = scaler.init(device)
    scaled_loss = loss * state.scale
    overflow = has_overflow(grads)               # device bool
    state = scaler.update(state, overflow)

On overflow the scale halves once the hysteresis is spent; after
``scale_window`` consecutive clean steps it doubles; it never falls below
``min_scale``.
"""

from __future__ import annotations

from typing import Any, Iterable, NamedTuple, Union

import torch


class LossScaleState(NamedTuple):
    scale: torch.Tensor          # () fp32
    good_steps: torch.Tensor     # () int32: consecutive non-overflow steps
    hysteresis: torch.Tensor     # () int32: overflows tolerated before backoff


def _state(scale: float, good: int, hyst: int, device) -> LossScaleState:
    return LossScaleState(
        scale=torch.tensor(scale, dtype=torch.float32, device=device),
        good_steps=torch.tensor(good, dtype=torch.int32, device=device),
        hysteresis=torch.tensor(hyst, dtype=torch.int32, device=device))


class LossScalerBase:
    def init(self, device: Union[str, torch.device] = "cpu") -> LossScaleState:
        raise NotImplementedError

    def update(self, state: LossScaleState, has_overflow: torch.Tensor
               ) -> LossScaleState:
        raise NotImplementedError

    def scale_loss(self, loss: torch.Tensor, state: LossScaleState
                   ) -> torch.Tensor:
        return loss * state.scale

    def unscale_grads(self, grads: Any, state: LossScaleState) -> Any:
        inv = 1.0 / state.scale
        return [(g * inv).to(g.dtype) for g in grads]


class LossScaler(LossScalerBase):
    """Static scaling: the scale never changes."""

    def __init__(self, scale: float = 1.0):
        self.cur_scale = scale

    def init(self, device="cpu") -> LossScaleState:
        return _state(self.cur_scale, 0, 1, device)

    def update(self, state, has_overflow) -> LossScaleState:
        return state._replace(good_steps=state.good_steps + 1)


class DynamicLossScaler(LossScalerBase):
    """Backoff on overflow with hysteresis, growth after ``scale_window``
    clean steps."""

    def __init__(self, init_scale: float = 2.0 ** 16,
                 scale_factor: float = 2.0, scale_window: int = 1000,
                 min_scale: float = 1.0, delayed_shift: int = 1,
                 consecutive_hysteresis: bool = False):
        self.init_scale = init_scale
        self.scale_factor = scale_factor
        self.scale_window = scale_window
        self.min_scale = min_scale
        self.delayed_shift = max(delayed_shift, 1)
        self.consecutive_hysteresis = consecutive_hysteresis

    def init(self, device="cpu") -> LossScaleState:
        return _state(self.init_scale, 0, self.delayed_shift, device)

    def update(self, state, has_overflow) -> LossScaleState:
        over = torch.as_tensor(has_overflow, device=state.scale.device)
        spent = state.hysteresis <= 1
        backoff = torch.clamp(state.scale / self.scale_factor,
                              min=self.min_scale)
        window_done = (state.good_steps + 1) % self.scale_window == 0
        grow = state.scale * self.scale_factor
        scale = torch.where(over & spent, backoff,
                            torch.where(~over & window_done, grow,
                                        state.scale))
        good = torch.where(over, torch.zeros_like(state.good_steps),
                           state.good_steps + 1)
        shift = torch.full_like(state.hysteresis, self.delayed_shift)
        if self.consecutive_hysteresis:
            # only consecutive overflows consume hysteresis
            hyst = torch.where(over, torch.clamp(state.hysteresis - 1, min=1),
                               shift)
        else:
            hyst = torch.where(over & ~spent, state.hysteresis - 1,
                               state.hysteresis)
            hyst = torch.where(over & spent, shift, hyst)
        return LossScaleState(scale=scale, good_steps=good, hysteresis=hyst)


def has_overflow(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """Device bool: any grad entry is inf or NaN."""
    flags = [~torch.isfinite(g).all() for g in grads]
    if not flags:
        return torch.tensor(False)
    return torch.stack(flags).any()


def create_loss_scaler(fp16_enabled: bool, dynamic: bool = True,
                       static_scale: float = 1.0,
                       initial_scale_power: int = 16,
                       scale_window: int = 1000, min_scale: float = 1.0,
                       hysteresis: int = 2) -> LossScalerBase:
    """Build from the fp16 config section."""
    if not fp16_enabled:
        return LossScaler(1.0)
    if dynamic:
        return DynamicLossScaler(init_scale=2.0 ** initial_scale_power,
                                 scale_window=scale_window,
                                 min_scale=min_scale,
                                 delayed_shift=hysteresis)
    return LossScaler(static_scale)
