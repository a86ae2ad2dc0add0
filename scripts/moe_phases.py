#!/usr/bin/env python3
"""``chip_smoke.py``'s Mixture-of-Experts checks, alone: the kernel cases at
moe-gpt-350m-8e's training shapes (the norm at 4096 x 1024, the flash
forward and backward at B 4, S = T 1024, 16 heads of 64, fused Adam over the
model's 1.76 B elements and over a layer's block and the resident part of
parameter offload, LAMB phase 1 over the model's leaves), then
``moe_train`` (stage 0, and stage 3 in a world-1 NCCL group),
``moe_param_offload`` (nvme, cpu), ``moe_optim``, ``moe_generate`` (bf16,
int8), ``moe_serve`` and ``e2e_moe``, with the same checks as in
``chip_smoke.py``. Builds only the kernels those paths run (one nvcc each,
in parallel).

    python3 scripts/moe_phases.py [--bound REL] [--skip-kernels]
        [--train-only]

``--bound``: the relative loss difference stage 3 may show against stage 0
(``chip_smoke.py`` derives it in its ``zero`` phase; default
``ZERO_LOSS_FLOOR``); ``--train-only``: moe_train, moe_param_offload and
moe_optim alone. Prints one JSON line a phase (``card``: the
nvidia-smi name and power limit) and, last, ``{"ok": true}``. Needs one
NVIDIA GPU.
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

MOE_SOURCES = ["layer_norm", "flash_attention", "flash_attention_bwd",
               "fused_adam", "fused_lamb", "decode_attention",
               "paged_attention", "quant_matmul"]


def kernel_cases(dev, gen) -> dict:
    """The MoE training shapes' cases of the ``kernels`` phase."""
    saved = cs.NORM_CASES
    cs.NORM_CASES = [(4096, 1024, False)]
    try:
        norm = cs.norm_cases(dev, gen)
    finally:
        cs.NORM_CASES = saved
    bwd = [c for c in cs.flash_bwd_cases(dev, gen) if c["case"] == "moe_train"]
    block, resident = cs.offload_numels(cs.MOE_PRESET)
    adam = [cs.adam_case(dev, gen, case, n, torch.bfloat16, True, False,
                         True)
            for case, n in (("moe_offload_block", block),
                            ("moe_offload_resident", resident))]
    adam.append(cs.adam_model_case(dev, gen, "moe_train",
                                   cs.moe_param_count(), cs.ADAM_KW))
    return dict(fused_layer_norm=norm,
                flash_attention=[cs.flash_train_case(dev, gen, "moe_train",
                                                     cs.MOE_TRAIN_FLASH)],
                flash_attention_bwd=bwd, fused_adam=adam,
                fused_lamb=[cs.lamb_model_case(dev, gen, "moe-gpt-350m-8e",
                                               cs.moe_leaf_sizes(),
                                               cs.LAMB_KW)])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bound", type=float, default=cs.ZERO_LOSS_FLOOR)
    ap.add_argument("--skip-kernels", action="store_true")
    ap.add_argument("--train-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi()
    cs.emit(dict(phase="device", nvidia_smi=smi, torch=torch.__version__,
                 cuda=torch.version.cuda))
    t0 = time.perf_counter()
    todo = [s for s in MOE_SOURCES if not registry.library_path(s).exists()]
    if todo:
        registry._compile(todo, False)
    cs.emit(dict(phase="build", seconds=time.perf_counter() - t0))
    if not args.skip_kernels:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        t0 = time.perf_counter()
        cases = kernel_cases(dev, gen)
        cs.emit(dict(phase="kernels", card=smi, cases=cases,
                     seconds=time.perf_counter() - t0))
        torch.cuda.empty_cache()
    store = tempfile.mkdtemp(prefix="nccl-store-")
    comm.init_distributed(dev, init_method=f"file://{store}/store", rank=0,
                          world_size=1, timeout=600)
    try:
        counts = cs.moe_phases(dev, smi, args.bound, args.train_only)
    finally:
        comm.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    cs.emit(dict(phase="moe_launches", launches=counts))
    print(smi, flush=True)
    cs.emit({"ok": True})
    return 0


if __name__ == "__main__":
    sys.exit(main())
