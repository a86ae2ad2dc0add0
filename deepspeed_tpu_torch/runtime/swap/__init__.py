"""Optimizer state on NVMe (counterpart of ``deepspeed_tpu/runtime/swap``)."""

from .optimizer_swapper import NVMeOptimizerSwapper, keystr  # noqa: F401

__all__ = ["NVMeOptimizerSwapper", "keystr"]
