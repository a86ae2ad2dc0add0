"""Collective micro-benchmark sweep: the ``ds_bench`` analog.

Counterpart of ``deepspeed_tpu/comm/benchmark.py`` (reference ``bin/ds_bench``
over DeepSpeedExamples' ``benchmarks/communication``): all_reduce /
all_gather / reduce_scatter / all_to_all / broadcast / pt2pt, each swept
over per-rank message sizes 2^minsize .. 2^maxsize bytes through the port's
collectives (``comm``: NCCL on the card, gloo on the CPU), timed on the host
around a device sync, with algbw and busbw from ``comms_logging.calc_bw_log``
(the comms logger's formulas). ``pt2pt`` sends to the next rank and receives
from the previous one; at world 1 every op is the one-participant identity
(a copy), so the sweep measures the call's cost alone.

    python -m deepspeed_tpu_torch.comm.benchmark --op all_reduce --maxsize 26
    torchrun --nproc_per_node 4 -m deepspeed_tpu_torch.comm.benchmark

Without a process group the CLI starts one from ``RANK`` / ``WORLD_SIZE`` /
``MASTER_ADDR`` / ``MASTER_PORT`` (world 1 when they are unset), on CUDA
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from . import comm
from .comms_logging import calc_bw_log

OPS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
       "broadcast", "pt2pt")
_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16,
           "fp32": torch.float32, "int8": torch.int8}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _pt2pt(x: torch.Tensor, out: torch.Tensor) -> None:
    world = comm.get_world_size()
    if world == 1:
        out.copy_(x)
        return
    rank = comm.get_rank()
    reqs = [dist.isend(x, (rank + 1) % world),
            dist.irecv(out, (rank - 1) % world)]
    for r in reqs:
        r.wait()


def _op(op: str, elems: int, world: int, dtype: torch.dtype,
        device: torch.device):
    """A no-argument call of ``op`` on a per-rank message of ``elems``
    elements (the reduce-scatter's message is its output chunk, as the
    comms logger counts it)."""
    x = torch.ones(elems, dtype=dtype, device=device)
    if op == "all_reduce":
        return lambda: comm.all_reduce(x)
    if op == "all_gather":
        out = torch.empty(world * elems, dtype=dtype, device=device)
        return lambda: comm.all_gather(x, out=out)
    if op == "reduce_scatter":
        big = torch.ones(world * elems, dtype=dtype, device=device)
        out = torch.empty(elems, dtype=dtype, device=device)
        return lambda: comm.reduce_scatter(big, out=out)
    if op == "all_to_all":
        out = torch.empty_like(x)
        return lambda: comm.all_to_all(x, out=out)
    if op == "broadcast":
        return lambda: comm.broadcast(x, src=0)
    if op == "pt2pt":
        out = torch.empty_like(x)
        return lambda: _pt2pt(x, out)
    raise ValueError(f"unknown op '{op}' (expected one of {OPS})")


def run_comm_benchmark(ops: Optional[List[str]] = None,
                       minsize_log2: int = 12, maxsize_log2: int = 26,
                       trials: int = 10, warmups: int = 2,
                       dtype: torch.dtype = torch.bfloat16,
                       device: Optional[torch.device] = None,
                       quiet: bool = False) -> List[Dict[str, Any]]:
    """One record per (op, size) over the process group (world 1 without
    one): the median latency of ``trials`` calls and its algbw / busbw in
    Gbps. Every rank must call it."""
    device = torch.device(device) if device is not None \
        else comm.comm_device()
    world = comm.get_world_size()
    itemsize = torch.empty((), dtype=dtype).element_size()
    results: List[Dict[str, Any]] = []
    for op in (ops or list(OPS)):
        size = 1 << minsize_log2
        while size <= (1 << maxsize_log2):
            # a multiple of the world: all_to_all splits the message evenly
            elems = max(size // itemsize, world)
            elems = -(-elems // world) * world
            call = _op(op, elems, world, dtype, device)
            for _ in range(warmups):
                call()
            _sync(device)
            times = []
            for _ in range(trials):
                comm.barrier()
                _sync(device)
                t0 = time.perf_counter()
                call()
                _sync(device)
                times.append(time.perf_counter() - t0)
            lat = sorted(times)[len(times) // 2]
            msg = elems * itemsize
            _, algbw, busbw = calc_bw_log(op if op != "pt2pt" else "p2p",
                                          msg, lat, world)
            rec = {"op": op, "world": world, "dtype": str(dtype),
                   "msg_bytes": msg, "latency_ms": lat * 1e3,
                   "algbw_gbps": algbw, "busbw_gbps": busbw}
            results.append(rec)
            if not quiet and comm.get_rank() == 0:
                print(f"{op:<16}{msg:>12}B  {lat * 1e3:>10.3f} ms  algbw "
                      f"{algbw:>9.2f} Gbps  busbw {busbw:>9.2f} Gbps",
                      flush=True)
            size <<= 1
    return results


def cli_main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.comm.benchmark",
        description="Collective benchmark sweep (the ds_bench analog).")
    p.add_argument("--op", default="all",
                   help=f"one of {', '.join(OPS)} or 'all'")
    p.add_argument("--minsize", type=int, default=12,
                   help="log2 of the smallest per-rank message in bytes")
    p.add_argument("--maxsize", type=int, default=26,
                   help="log2 of the largest per-rank message in bytes")
    p.add_argument("--trials", type=int, default=10)
    p.add_argument("--warmups", type=int, default=2)
    p.add_argument("--dtype", default="bf16", choices=sorted(_DTYPES))
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--json", action="store_true",
                   help="print one JSON line with every record")
    args = p.parse_args(argv)
    started = not comm.is_initialized()
    if started:
        comm.init_distributed(args.device, verbose=False)
    try:
        results = run_comm_benchmark(
            ops=list(OPS) if args.op == "all" else [args.op],
            minsize_log2=args.minsize, maxsize_log2=args.maxsize,
            trials=args.trials, warmups=args.warmups,
            dtype=_DTYPES[args.dtype], quiet=args.json)
        if args.json and comm.get_rank() == 0:
            print(json.dumps(results))
    finally:
        if started:
            comm.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(cli_main())
