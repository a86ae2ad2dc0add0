#!/usr/bin/env python3
"""``chip_smoke.py``'s training phases under ZeRO, alone: OPT-1.3B's stage-0
``train`` phase (whose losses the others are held to), then ``zero``
(stages 1, 2 and 3 at world 1 over a real NCCL group) and ``checkpoint``
(format 2 saved at stage 2 and restored into stage 3, bit for bit), with
the same checks as in ``chip_smoke.py``. Builds only the train path's
kernels (one nvcc each, in parallel).

    python3 scripts/zero_checkpoint_phases.py [--skip-checkpoint]

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

TRAIN_SOURCES = ["layer_norm", "flash_attention", "flash_attention_bwd",
                 "fused_adam"]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-checkpoint", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi()
    cs.emit(dict(phase="device", nvidia_smi=smi, torch=torch.__version__,
                 cuda=torch.version.cuda))
    t0 = time.perf_counter()
    todo = [s for s in TRAIN_SOURCES if not registry.library_path(s).exists()]
    if todo:
        registry._compile(todo, False)
    cs.emit(dict(phase="build", seconds=time.perf_counter() - t0))
    _, train = cs.train_phase(dev, "train")
    cs.emit(dict(train, card=smi))
    store = tempfile.mkdtemp(prefix="nccl-store-")
    comm.init_distributed(dev, init_method=f"file://{store}/store", rank=0,
                          world_size=1, timeout=600)
    try:
        _, zero = cs.zero_phase(dev, train["losses"])
        cs.emit(dict(zero, card=smi))
        if not args.skip_checkpoint:
            cs.emit(dict(cs.checkpoint_phase(dev, zero["loss_rtol"]),
                         card=smi))
    finally:
        comm.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    print(smi, flush=True)
    cs.emit({"ok": True})
    return 0


if __name__ == "__main__":
    sys.exit(main())
