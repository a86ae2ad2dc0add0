#!/usr/bin/env python3
"""Host <-> card copy rates at one llama-7b layer block's fp32 state
(202,383,360 elements, 809.5 MB: what parameter offload moves three times
each way per block update).

Each way, over the same pageable host tensor and card buffer:

* ``plain``: one ``copy_`` of the pageable tensor (the CUDA driver stages
  it through its own pinned buffers);
* ``plain_side``: the same on a side stream with ``non_blocking=True``,
  as a fetch stream would issue it;
* ``chunked``: 64 MiB chunks through two pinned buffers a direction on a
  side stream, the host copying a chunk into (or out of) one buffer while
  the other's DMA runs;
* ``pinned``: one DMA from (to) a pinned tensor, the link's rate;
* ``host_memcpy``: the pageable <-> pinned host copy alone, no card.

    python3 scripts/staging_copy_bench.py [--reps N]

Prints one JSON line (seconds each way, the median of ``--reps`` after a
warm-up; GB/s; the card's name and power limit). Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

N = 4 * 4096 ** 2 + 3 * 4096 * 11008 + 2 * 4096
CHUNK = 64 << 20


def seconds(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


class Chunked:
    """Pageable <-> card copies through two pinned chunk buffers a
    direction on a side stream."""

    def __init__(self):
        self.stream = torch.cuda.Stream()
        mk = lambda: torch.empty(CHUNK, dtype=torch.uint8,  # noqa: E731
                                 pin_memory=True)
        self.up, self.down = [mk(), mk()], [mk(), mk()]
        self.up_done = [None, None]

    def _dma(self, dst, src):
        with torch.cuda.stream(self.stream):
            dst.copy_(src, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return ev

    def to_device(self, dst, src):
        s8, d8 = src.view(torch.uint8), dst.view(torch.uint8)
        n = s8.numel()
        for i, lo in enumerate(range(0, n, CHUNK)):
            hi, k = min(n, lo + CHUNK), i % 2
            if self.up_done[k] is not None:
                self.up_done[k].synchronize()
            buf = self.up[k][:hi - lo]
            buf.copy_(s8[lo:hi])
            self.up_done[k] = self._dma(d8[lo:hi], buf)

    def to_host(self, dst, src):
        s8, d8 = src.view(torch.uint8), dst.view(torch.uint8)
        n, pending = s8.numel(), []
        for i, lo in enumerate(range(0, n, CHUNK)):
            hi = min(n, lo + CHUNK)
            if len(pending) == 2:
                ev, buf, out = pending.pop(0)
                ev.synchronize()
                out.copy_(buf)
            buf = self.down[i % 2][:hi - lo]
            pending.append((self._dma(buf, s8[lo:hi]), buf, d8[lo:hi]))
        for ev, buf, out in pending:
            ev.synchronize()
            out.copy_(buf)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    host = torch.randn(N)
    back = torch.zeros(N)
    pinned = torch.empty(N, pin_memory=True)
    dev = torch.empty(N, device="cuda")
    side = torch.cuda.Stream()
    chunked = Chunked()

    def on_side(fn):
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        side.synchronize()

    runs = {
        "h2d": {
            "plain": lambda: dev.copy_(host),
            "plain_side": lambda: on_side(
                lambda: dev.copy_(host, non_blocking=True)),
            "chunked": lambda: chunked.to_device(dev, host),
            "pinned": lambda: dev.copy_(pinned, non_blocking=True),
            "host_memcpy": lambda: pinned.copy_(host)},
        "d2h": {
            "plain": lambda: back.copy_(dev),
            "plain_side": lambda: on_side(lambda: back.copy_(dev)),
            "chunked": lambda: chunked.to_host(back, dev),
            "pinned": lambda: pinned.copy_(dev, non_blocking=True),
            "host_memcpy": lambda: back.copy_(pinned)}}
    out = {"elements": N, "bytes": N * 4, "chunk_bytes": CHUNK,
           "reps": args.reps, "host_threads": torch.get_num_threads()}
    for way, fns in runs.items():
        row = {}
        for name, fn in fns.items():
            s = seconds(fn, args.reps)
            row[name] = {"s": s, "gb_per_s": N * 4 / s / 1e9}
        out[way] = row
    chunked.to_host(back, dev)
    dev.copy_(host)
    back.copy_(dev)
    out["round_trip_equal"] = bool(torch.equal(back, host))
    out["card"] = smi
    print(json.dumps(out), flush=True)
    return 0 if out["round_trip_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
