"""Per-collective latency / size / bandwidth logging.

Counterpart of ``deepspeed_tpu/comm/comms_logging.py`` (``CommsLogger``,
``calc_bw_log``, ``configure_comms_logger``). The JAX logger keeps a census of
collectives traced into a compiled program; every collective of the port is
an eager call, so each one is recorded with its host-timed latency
(``comm.timed_op`` waits for the device around the call while the logger is
on). Bandwidth follows the reference's ``get_bw``: all-reduce bus bandwidth
2(n-1)/n, all-gather and reduce-scatter (n-1)/n of n times the per-rank
message, all-to-all (n-1)/n.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

from ..utils.logging import log_dist


def calc_bw_log(comm_op: str, size_bytes: int, duration_s: float,
                n: int) -> tuple:
    """Returns (msg_size_bytes, algbw_Gbps, busbw_Gbps)."""
    duration_s = max(duration_s, 1e-9)
    tput = size_bytes / duration_s
    if comm_op in ("all_to_all",):
        busbw = tput * ((n - 1) / max(n, 1))
    elif comm_op in ("all_gather", "reduce_scatter"):
        size_bytes *= n
        tput = size_bytes / duration_s
        busbw = tput * ((n - 1) / max(n, 1))
    elif comm_op in ("all_reduce",):
        tput *= 2
        busbw = tput * ((n - 1) / max(n, 1))
    else:  # broadcast / p2p
        busbw = tput
    return size_bytes, tput * 8 / 1e9, busbw * 8 / 1e9


class CommsLogger:
    """Records (op, message bytes, latency) per call. ``comms_dict[name]
    [msg_size]`` holds the latencies (ms) of the calls of that size;
    ``summary()`` folds them into count / bytes / latency per op."""

    def __init__(self, enabled: bool = False, verbose: bool = False,
                 prof_all: bool = True, debug: bool = False,
                 prof_ops: Optional[List[str]] = None, world_size: int = 1):
        self.enabled = enabled
        self.verbose = verbose
        self.prof_all = prof_all
        self.debug = debug
        self.prof_ops = prof_ops or []
        self.world_size = max(world_size, 1)
        self.comms_dict: Dict[str, Dict[int, List[float]]] = defaultdict(
            lambda: defaultdict(list))

    def configure(self, config) -> None:
        self.enabled = config.enabled
        self.verbose = config.verbose
        self.prof_all = config.prof_all
        self.debug = config.debug
        self.prof_ops = list(config.prof_ops)

    def start_profiling_comms(self) -> None:
        self.prof_all = True

    def stop_profiling_comms(self) -> None:
        self.prof_all = False

    def reset(self) -> None:
        self.comms_dict.clear()

    def wants(self, record_name: str) -> bool:
        return self.enabled and (self.prof_all
                                 or record_name in self.prof_ops)

    def append(self, raw_name: str, record_name: str, latency_s: float,
               msg_size: int, ranks: Optional[int] = None) -> None:
        """Record one call of ``raw_name`` (the collective) under
        ``record_name`` (its log name), over a group of ``ranks`` (default
        the world)."""
        if not self.prof_all and record_name not in self.prof_ops:
            return
        size, algbw, busbw = calc_bw_log(raw_name, msg_size, latency_s,
                                         ranks or self.world_size)
        self.comms_dict[record_name][msg_size].append(latency_s * 1000.0)
        if self.verbose:
            log_dist(f"comm op: {record_name} | time (ms): "
                     f"{latency_s * 1000:.2f} | msg size: {_fmt_size(size)} "
                     f"| algbw (Gbps): {algbw:.2f} | busbw (Gbps): "
                     f"{busbw:.2f}")

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per op: calls, message bytes in all, latency in all (ms)."""
        out = {}
        for name, sizes in self.comms_dict.items():
            out[name] = {
                "count": sum(len(v) for v in sizes.values()),
                "bytes": sum(size * len(v) for size, v in sizes.items()),
                "ms": sum(sum(v) for v in sizes.values())}
        return out

    def log_summary(self) -> None:
        lines = []
        if self.comms_dict:
            lines.append(f"{'Comm. Op':<20}{'Message Size':<20}{'Count':<10}"
                         f"{'Total Latency(ms)':<20}{'Avg Latency(ms)':<20}")
            for record_name, sizes in self.comms_dict.items():
                lines.append(record_name)
                for size, lats in sorted(sizes.items()):
                    total = sum(lats)
                    lines.append(f"{'':<20}{_fmt_size(size):<20}"
                                 f"{len(lats):<10}{total:<20.2f}"
                                 f"{total / len(lats):<20.2f}")
        log_dist("\n".join(lines) if lines
                 else "comms logger: no events recorded")


def _fmt_size(num_bytes: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(num_bytes) < 1024.0:
            return f"{num_bytes:.1f} {unit}"
        num_bytes /= 1024.0
    return f"{num_bytes:.1f} PB"


_COMMS_LOGGER: Optional[CommsLogger] = None


def get_comms_logger() -> Optional[CommsLogger]:
    return _COMMS_LOGGER


def configure_comms_logger(config=None, world_size: int = 1) -> CommsLogger:
    global _COMMS_LOGGER
    if _COMMS_LOGGER is None:
        _COMMS_LOGGER = CommsLogger(world_size=world_size)
    if config is not None:
        _COMMS_LOGGER.configure(config)
    _COMMS_LOGGER.world_size = max(world_size, 1)
    return _COMMS_LOGGER
