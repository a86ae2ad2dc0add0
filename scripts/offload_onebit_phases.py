#!/usr/bin/env python3
"""``chip_smoke.py``'s phases of the data-parallel slice and the offload
tiers, alone: OPT-1.3B's stage-0 ``train`` phase (whose losses the others
are held to), a repeat of stage 0 for the run-to-run spread (the bound of
the zero phase), then in a world-1 NCCL group ``lamb_zero``, ``onebit``,
``offload_parity``, ``offload`` (llama-7b under host-memory offload),
``nvme``, ``param_offload_parity``, ``param_offload`` (llama-7b under
parameter offload) and ``comm_bench``, with the same checks as in
``chip_smoke.py``. Builds only the kernels these paths run (one nvcc each,
in parallel). ``--param-runs nvme:8,cpu:4,nvme:2`` replaces
``param_offload``'s (tier, layers) runs (a shorter rehearsal; the first
two tiers' nvme runs set the L-independence check).

    python3 scripts/offload_onebit_phases.py [--only PHASE ...] [--threads N]
        [--param-runs TIER:LAYERS,...]

Prints one JSON line a phase (``card``: the nvidia-smi name and power
limit) and, last, ``{"ok": true}``. Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from deepspeed_tpu_torch import comm  # noqa: E402
from deepspeed_tpu_torch.ops import registry  # noqa: E402

SOURCES = ["layer_norm", "flash_attention", "flash_attention_bwd",
           "fused_adam", "fused_lamb"]
PHASES = ("lamb_zero", "onebit", "offload_parity", "offload", "nvme",
          "param_offload_parity", "param_offload", "comm_bench")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", choices=PHASES, default=PHASES)
    ap.add_argument("--threads", type=int, default=0,
                    help="torch's host threads (default: torch's own)")
    ap.add_argument("--param-runs", default="",
                    help="param_offload's tier:layers runs, comma-separated")
    args = ap.parse_args()
    if args.param_runs:
        cs.PARAM_OFFLOAD_RUNS = tuple(
            (t, int(n)) for t, n in (r.split(":") for r in
                                     args.param_runs.split(",")))
    if args.threads:
        torch.set_num_threads(args.threads)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi()
    cs.emit(dict(phase="device", nvidia_smi=smi, torch=torch.__version__,
                 cuda=torch.version.cuda))
    t0 = time.perf_counter()
    todo = [s for s in SOURCES if not registry.library_path(s).exists()]
    if todo:
        registry._compile(todo, False)
    registry.host_library("ds_aio")
    cs.emit(dict(phase="build", seconds=time.perf_counter() - t0))
    _, train = cs.train_phase(dev, "train")
    cs.emit(dict(train, card=smi))
    store = tempfile.mkdtemp(prefix="nccl-store-")
    comm.init_distributed(dev, init_method=f"file://{store}/store", rank=0,
                          world_size=1, timeout=600)
    try:
        repeat, _ = cs.zero_stage_run(dev, 0, train["losses"])
        bound = max(cs.ZERO_LOSS_FLOOR,
                    cs.ZERO_SPREAD_FACTOR * repeat["loss_rel_err"])
        cs.emit(dict(phase="stage0_repeat", spread=repeat["loss_rel_err"],
                     loss_rtol=bound, card=smi))
        base = train["losses"]
        runs = {"lamb_zero": lambda: cs.lamb_zero_phase(dev, bound),
                "onebit": lambda: cs.onebit_phase(dev, base, bound),
                "offload_parity": lambda: parity(dev),
                "offload": lambda: cs.offload_phase(dev),
                "nvme": lambda: cs.nvme_phase(dev, base, bound),
                "param_offload_parity": lambda: param_parity(dev, bound),
                "param_offload": lambda: cs.param_offload_phase(dev),
                "comm_bench": lambda: cs.comm_bench_phase(dev)}
        for name in PHASES:
            if name not in args.only:
                continue
            t0 = time.perf_counter()
            res = runs[name]()
            out = res[1] if isinstance(res, tuple) else res
            cs.emit(dict(out, seconds=time.perf_counter() - t0, card=smi))
            cs.gc.collect()
            torch.cuda.empty_cache()
    finally:
        comm.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    print(smi, flush=True)
    cs.emit({"ok": True})
    return 0


def parity(dev):
    root = tempfile.mkdtemp(prefix="offload-", dir=cs.largest_disk())
    try:
        return cs.offload_parity_phase(dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def param_parity(dev, bound):
    root = tempfile.mkdtemp(prefix="param-parity-", dir=cs.largest_disk())
    try:
        return cs.param_offload_parity_phase(dev, root, bound)
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
