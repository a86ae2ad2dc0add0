"""Whether NCCL forms a group of two ranks on one CUDA device.

Starts two processes that both take ``cuda:0`` (``comm.init_distributed``
maps rank ``r`` to device ``r % device_count``), joins them in an NCCL
group over ``tcp://localhost:<free port>`` and runs one all-reduce and one
all-to-all. Prints one JSON line per rank: the torch, CUDA and NCCL
versions and either the collectives' results or the error text. Each rank
gives up after ``--timeout`` seconds; the parent kills what is left.

    python3 scripts/nccl_shared_card_probe.py [--timeout 120]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import traceback

import torch
import torch.multiprocessing as mp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(rank: int, world: int, port: int, timeout: float, q) -> None:
    from deepspeed_tpu_torch import comm

    out = {"rank": rank, "torch": torch.__version__,
           "cuda": torch.version.cuda,
           "nccl": ".".join(map(str, torch.cuda.nccl.version())),
           "devices": torch.cuda.device_count()}
    try:
        comm.init_distributed("cuda", init_method=f"tcp://localhost:{port}",
                              rank=rank, world_size=world, timeout=timeout,
                              verbose=False)
        dev = comm.comm_device()
        out["device"] = str(dev)
        x = torch.full((4,), float(rank + 1), device=dev)
        out["all_reduce"] = comm.all_reduce(x).tolist()
        y = torch.arange(4, dtype=torch.float32, device=dev) + 10 * rank
        out["all_to_all"] = comm.all_to_all(y).tolist()
        torch.cuda.synchronize()
        out["ok"] = True
    except BaseException as exc:   # the probe reports what NCCL said
        out["ok"] = False
        out["error"] = f"{type(exc).__name__}: {exc}"
        out["traceback"] = traceback.format_exc()[-2000:]
    finally:
        try:
            comm.destroy_process_group()
        except BaseException:
            pass
    q.put(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--timeout", type=float, default=120.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, 2, port, args.timeout, q))
             for r in range(2)]
    for p in procs:
        p.start()
    results = []
    try:
        for _ in procs:
            results.append(q.get(timeout=args.timeout + 60))
    except Exception as exc:
        results.append({"ok": False, "error": f"no answer: {exc!r}"})
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    for r in sorted(results, key=lambda r: r.get("rank", 9)):
        print(json.dumps(r))
    return 0 if all(r.get("ok") for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
