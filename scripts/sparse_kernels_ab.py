#!/usr/bin/env python3
"""The block-sparse attention kernels, as one checkout builds them: the
bits of the forward on seeded inputs and ``chip_smoke.py``'s sparse cases.

Imports ``deepspeed_tpu_torch`` and ``chip_smoke`` from the WORKING
DIRECTORY, so that, run from an unpacked older checkout, it measures that
tree's kernels. To compare two commits on one card, run it in turns from
each checkout within one command (parent, change, change, parent) and
compare the lines:

    (cd build/parent && python3 ../../scripts/sparse_kernels_ab.py)
    python3 scripts/sparse_kernels_ab.py

Prints one JSON line: ``tree`` (the working directory), the card
(nvidia-smi name and power limit) and, per case, ``hash`` (sha256 of the
forward's output bytes) and ``chip_smoke.sparse_case``'s forward and
backward entries (ms, plain ms, SDPA's ms, the flash kernels' ms at the
same shape, bound, max abs error against the plain version, which it holds
within ``chip_smoke.TOL``). Cases: sparse_train's shape (B 2, S 2048, 32
heads of 64, bf16, causal) under the Fixed, sliding-window and BSLongformer
layouts, and Fixed at head_dim 128; inputs from a generator seeded 0. Needs
one NVIDIA GPU.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

KEEP = ("ms", "plain_ms", "library_ms", "flash_ms", "bound_ms", "bound_by",
        "max_abs_err")


def main() -> int:
    if not torch.cuda.is_available():
        print("sparse_kernels_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import block_sparse_attention_fwd
    from deepspeed_tpu_torch.ops.sparse_attention import tile_plan_for
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    configs = cs.sparse_path_configs()
    out = {}
    for D, cases in ((cs.SPARSE_D, tuple(configs)), (128, ("fixed",))):
        q, k, v, do = (torch.randn(cs.SPARSE_B, cs.SPARSE_S, cs.SPARSE_N, D,
                                   generator=gen, device=dev
                                   ).to(torch.bfloat16) for _ in range(4))
        flash = cs.flash_same_shape(q, k, v, do)
        for case in cases:
            plan = tile_plan_for(configs[case], cs.SPARSE_S)
            o = block_sparse_attention_fwd(q, k, v, plan, True)[0]
            res = cs.sparse_case(case, plan, True, q, k, v, do, flash)
            out[f"{case}_d{D}"] = dict(
                hash=hashlib.sha256(o.view(torch.uint8).cpu().numpy()
                                    .tobytes()).hexdigest()[:16],
                **{part: {key: res[f"block_sparse_attention_{part}"][key]
                          for key in KEEP} for part in ("fwd", "bwd")})
    print(json.dumps(dict(tree=os.getcwd(), card=cs.nvidia_smi(),
                          cases=out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
