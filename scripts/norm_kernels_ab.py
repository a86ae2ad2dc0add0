#!/usr/bin/env python3
"""The norm kernel (``fused_layer_norm``), as one checkout builds it: the
bits it gives on seeded inputs, ``chip_smoke.py``'s norm cases and the
host's cost of a call.

Imports ``deepspeed_tpu_torch`` and ``chip_smoke`` from the WORKING
DIRECTORY, so that, run from an unpacked older checkout, it measures that
tree's kernel. To compare two commits on one card, run it in turns from
each checkout within one command (parent, change, change, parent) and
compare the lines:

    (cd build/parent && python3 ../../scripts/norm_kernels_ab.py)
    python3 scripts/norm_kernels_ab.py

Prints one JSON line: ``tree`` (the working directory), the card
(nvidia-smi name and power limit), ``hashes`` (sha256 of the output bytes
at ``SHAPES``, inputs from a generator seeded 0), ``cases``
(``chip_smoke.norm_cases``, from a generator seeded 0: ms, rotated ms and
the plan where the tree has them, plain ms, library ms, bound) and
``host_us``: the host's wall time a call of the norm at the decode step's
shape (8 x 4096 RMSNorm, bf16) over 2000 eager calls ended by one sync; the
kernel's device time is a fraction of it, so this is the wrapper's and the
launch's cost. Needs one NVIDIA GPU.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

# (rows, H, rms, bias, dtype): the main paths' shapes, then fp16, fp32,
# 8192-wide rows and a row of 4099 (the scalar kernel)
SHAPES = [(8, 4096, True, False, torch.bfloat16),
          (256, 4096, True, False, torch.bfloat16),
          (256, 4096, False, True, torch.bfloat16),
          (4096, 4096, True, False, torch.bfloat16),
          (4096, 2048, False, True, torch.bfloat16),
          (8, 4096, True, False, torch.float16),
          (8, 4096, True, False, torch.float32),
          (4096, 2048, False, True, torch.float32),
          (5, 8192, False, True, torch.bfloat16),
          (3, 4099, False, True, torch.float32)]
KEEP = ("rows", "H", "rms", "dtype", "ms", "rotated_ms", "plain_ms",
        "library_ms", "bound_ms", "max_abs_err", "plan", "kernel")
HOST_CALLS = 2000


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(
        t.contiguous().view(torch.uint8).cpu().numpy().tobytes()
    ).hexdigest()[:16]


def main() -> int:
    if not torch.cuda.is_available():
        print("norm_kernels_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import fused_layer_norm
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    hashes = {}
    for rows, H, rms, use_bias, dtype in SHAPES:
        x = torch.randn(rows, H, generator=gen, device=dev).to(dtype)
        scale = (1 + 0.1 * torch.randn(H, generator=gen, device=dev)
                 ).to(dtype)
        bias = (0.1 * torch.randn(H, generator=gen, device=dev)).to(dtype) \
            if use_bias else None
        name = (f"{rows}x{H}_{'rms' if rms else 'ln'}"
                f"{'_bias' if use_bias else ''}_{str(dtype)[6:]}")
        hashes[name] = digest(fused_layer_norm(x, scale, bias, 1e-6, rms))
    gen.manual_seed(0)
    cases = [{k: c[k] for k in KEEP if k in c}
             for c in cs.norm_cases(dev, gen)]
    x = torch.randn(8, 4096, device=dev).to(torch.bfloat16)
    scale = torch.ones(4096, device=dev, dtype=torch.bfloat16)
    for _ in range(50):
        fused_layer_norm(x, scale, None, 1e-6, True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fused_layer_norm(x, scale, None, 1e-6, True)
    torch.cuda.synchronize()
    host_us = (time.perf_counter() - t0) / HOST_CALLS * 1e6
    print(json.dumps(dict(tree=os.getcwd(), card=cs.nvidia_smi(),
                          hashes=hashes, cases=cases, host_us=host_us)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
