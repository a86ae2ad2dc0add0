"""``deepspeed_tpu_torch.comm``: the collective API over ``torch.distributed``.

Counterpart of ``deepspeed_tpu/comm/comm.py``. The JAX collectives take a
mesh-axis name and lower to ``jax.lax`` inside ``shard_map``; the port's take a
tensor and an optional process group, as ``torch.distributed`` does, and run
eagerly on NCCL (CUDA tensors) or gloo (CPU tensors):

* ``init_distributed(device, init_method, rank, world_size, timeout)`` starts
  the default process group: NCCL for a CUDA device, gloo for the CPU, picked
  by the device it is given (never by probing for a GPU). Rank and world
  size default to the ``RANK`` / ``WORLD_SIZE`` environment variables and the
  rendezvous to ``MASTER_ADDR`` / ``MASTER_PORT``, the JAX package's
  contract.
* ``all_reduce`` and ``broadcast`` work in place; ``all_gather``,
  ``reduce_scatter`` and ``all_to_all`` work along dim 0 (the flat-buffer
  convention) and write into ``out`` when it is given. Without a process
  group each is the one-participant identity, as the JAX calls are outside a
  mapped context.
* Every collective goes through ``timed_op``: while the comms logger is on,
  it waits for the device before and after the call and records the op, the
  per-rank message bytes and the latency.
"""

from __future__ import annotations

import datetime
import functools
import os
import time
from enum import Enum
from typing import Any, Callable, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from ..utils.logging import logger
from .comms_logging import get_comms_logger


class ReduceOp(Enum):
    """Reference: comm/comm.py:33-42."""

    SUM = 0
    PRODUCT = 1
    MIN = 2
    MAX = 3
    BAND = 4
    BOR = 5
    BXOR = 6
    AVG = 7
    UNUSED = 8


_TORCH_OPS = {ReduceOp.SUM: "SUM", ReduceOp.AVG: "SUM",
              ReduceOp.PRODUCT: "PRODUCT", ReduceOp.MIN: "MIN",
              ReduceOp.MAX: "MAX", ReduceOp.BAND: "BAND",
              ReduceOp.BOR: "BOR", ReduceOp.BXOR: "BXOR"}

# the tensor collectives under the names this torch has: newer releases
# rename them *_single and mark the old names deprecated (same arguments)
_ALL_GATHER = (getattr(dist, "all_gather_single", None)
               or dist.all_gather_into_tensor)
_REDUCE_SCATTER = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)

_DEVICE: Optional[torch.device] = None


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def init_distributed(device: Union[str, torch.device] = "cuda",
                     init_method: Optional[str] = None, rank: int = -1,
                     world_size: int = -1,
                     timeout: Optional[float] = None,
                     distributed_port: int = 29500,
                     verbose: bool = True) -> None:
    """Start the default process group for ``device``'s collectives: NCCL
    on CUDA (each process takes the GPU ``LOCAL_RANK``, else ``rank`` modulo
    the GPU count), gloo on the CPU. ``timeout``: seconds a collective may
    wait for the other ranks before it raises. A second call is a no-op."""
    global _DEVICE
    if is_initialized():
        return
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"init_distributed: unsupported device {dev}")
    world = int(os.environ.get("WORLD_SIZE", world_size if world_size > 0
                               else 1))
    if rank < 0:
        if "RANK" not in os.environ and world > 1:
            raise RuntimeError(
                f"world size {world} > 1 but neither a RANK environment "
                "variable nor a rank argument was given: every process "
                "would claim rank 0 and the rendezvous would hang")
        rank = int(os.environ.get("RANK", 0))
    if init_method is None:
        addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
        port = os.environ.get("MASTER_PORT", str(distributed_port))
        init_method = f"tcp://{addr}:{port}"
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: NCCL needs a CUDA GPU and "
                               "none is available; pass device='cpu' for "
                               "gloo")
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    if verbose:
        logger.info(f"init_process_group({backend}, {init_method}, "
                    f"rank={rank}, world_size={world})")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, **kw)
    _DEVICE = dev


def destroy_process_group() -> None:
    global _DEVICE
    if is_initialized():
        dist.destroy_process_group()
    _DEVICE = None


def comm_device() -> torch.device:
    """The device whose tensors the process group reduces (the CPU when
    there is no group)."""
    return _DEVICE if _DEVICE is not None else torch.device("cpu")


def get_rank(group=None) -> int:
    return dist.get_rank(group) if is_initialized() else 0


def get_world_size(group=None) -> int:
    return dist.get_world_size(group) if is_initialized() else 1


def barrier(group=None) -> None:
    if is_initialized():
        dist.barrier(group)


def new_group(ranks) -> Any:
    """A process group of ``ranks`` (global ranks, in the order that sets
    each member's group rank) for the collectives' ``group=``. A
    collective: every rank of the world calls it for every group, in the
    same order, members or not. Without a process group: None."""
    if not is_initialized():
        return None
    return dist.new_group(ranks=sorted(ranks))


# ---------------------------------------------------------------------------
# timed_op wrapper (reference comm.py:104-144)
# ---------------------------------------------------------------------------


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def timed_op(fn: Callable) -> Callable:
    """The comms-logger seam: with a process group and the logger on for
    this op's log name (``log_name=``, default the op's name), wait for the
    device, run the collective, wait again, and record the latency and the
    per-rank message bytes (a reduce-scatter's is its output chunk)."""

    @functools.wraps(fn)
    def wrapper(tensor: torch.Tensor, *args, log_name: Optional[str] = None,
                **kwargs):
        clog = get_comms_logger()
        name = log_name or fn.__name__
        if not is_initialized() or clog is None or not clog.wants(name):
            return fn(tensor, *args, **kwargs)
        nbytes = tensor.numel() * tensor.element_size()
        group = kwargs.get("group")
        ranks = get_world_size(group)
        if fn.__name__ == "reduce_scatter":
            nbytes //= ranks
        _sync(tensor)
        t0 = time.perf_counter()
        out = fn(tensor, *args, **kwargs)
        _sync(tensor)
        clog.append(fn.__name__, name, time.perf_counter() - t0, nbytes,
                    ranks=ranks)
        return out

    return wrapper


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _dist_op(op: ReduceOp):
    if op not in _TORCH_OPS:
        raise NotImplementedError(f"ReduceOp {op} is not supported")
    return getattr(dist.ReduceOp, _TORCH_OPS[op])


@timed_op
def all_reduce(tensor: torch.Tensor, op: ReduceOp = ReduceOp.SUM,
               group=None) -> torch.Tensor:
    """In place over the group; AVG is SUM over the world size (gloo has no
    AVG)."""
    if not is_initialized():
        return tensor
    dist.all_reduce(tensor, op=_dist_op(op), group=group)
    if op == ReduceOp.AVG:
        tensor.div_(get_world_size(group))
    return tensor


@timed_op
def all_gather(tensor: torch.Tensor, group=None,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every rank's ``tensor`` concatenated along dim 0 (``out``, shape
    (world * d0, ...)); ``tensor`` may be ``out``'s own chunk of this rank
    (in place)."""
    world = get_world_size(group)
    if out is None:
        out = tensor.new_empty((world * tensor.shape[0],)
                               + tuple(tensor.shape[1:]))
    if not is_initialized():
        if out.data_ptr() != tensor.data_ptr():
            out.copy_(tensor)
        return out
    _ALL_GATHER(out, tensor, group=group)
    return out


@timed_op
def reduce_scatter(tensor: torch.Tensor, op: ReduceOp = ReduceOp.SUM,
                   group=None, out: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """This rank's chunk of dim 0 of the reduction of every rank's
    ``tensor`` (``out``, shape (d0 / world, ...))."""
    world = get_world_size(group)
    if tensor.shape[0] % world:
        raise ValueError(f"reduce_scatter: dim 0 ({tensor.shape[0]}) is not "
                         f"a multiple of the world size {world}")
    if out is None:
        out = tensor.new_empty((tensor.shape[0] // world,)
                               + tuple(tensor.shape[1:]))
    if not is_initialized():
        return out.copy_(tensor)
    _REDUCE_SCATTER(out, tensor, op=_dist_op(op), group=group)
    if op == ReduceOp.AVG:
        out.div_(world)
    return out


@timed_op
def all_to_all(tensor: torch.Tensor, group=None,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Split dim 0 into world chunks, send chunk j to rank j, concatenate
    what arrives in rank order (the MoE dispatch / Ulysses primitive)."""
    if out is None:
        out = torch.empty_like(tensor)
    if not is_initialized():
        return out.copy_(tensor)
    dist.all_to_all_single(out, tensor, group=group)
    return out


@timed_op
def broadcast(tensor: torch.Tensor, src: int = 0,
              group=None) -> torch.Tensor:
    """In place: every rank gets rank ``src``'s ``tensor``."""
    if is_initialized():
        dist.broadcast(tensor, src, group=group)
    return tensor


# host-level helpers over the group's device ----------------------------------


def host_all_reduce_scalar(value: float) -> float:
    """Sum of a host number over the processes (1 process: the number)."""
    if not is_initialized():
        return value
    t = torch.tensor([float(value)], dtype=torch.float64,
                     device=comm_device())
    dist.all_reduce(t)
    return float(t.item())


def host_all_gather_array(value: Any) -> np.ndarray:
    """Every process's host array, float32, stacked on a leading
    process dim (1 process: the array with a length-1 leading dim). A
    barrier: every process must call it."""
    arr = np.asarray(value, dtype=np.float32)
    if not is_initialized():
        return arr[None]
    t = torch.from_numpy(np.ascontiguousarray(arr).reshape(1, -1)).to(
        comm_device())
    out = torch.empty((get_world_size(), t.shape[1]), dtype=t.dtype,
                      device=t.device)
    _ALL_GATHER(out, t)
    return out.cpu().numpy().reshape((-1,) + arr.shape)


def log_summary() -> None:
    clog = get_comms_logger()
    if clog is not None:
        clog.log_summary()
