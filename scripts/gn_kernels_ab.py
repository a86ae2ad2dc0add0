#!/usr/bin/env python3
"""The GroupNorm kernels (``fused_group_norm``), as one checkout builds
them: the bits they give on seeded inputs, ``chip_smoke.py``'s GroupNorm
cases, the SD v1.5 VAE mid block under torch.profiler and the host's cost
of a call.

Imports ``deepspeed_tpu_torch`` and ``chip_smoke`` from the WORKING
DIRECTORY, so that, run from an unpacked older checkout, it measures that
tree's kernels. To compare two commits on one card, run it in turns from
each checkout within one command (parent, change, change, parent) and
compare the lines:

    (cd build/parent && python3 ../../scripts/gn_kernels_ab.py)
    python3 scripts/gn_kernels_ab.py

Prints one JSON line: ``tree`` (the working directory), the card
(nvidia-smi name and power limit), ``hashes`` (sha256 of the output bytes
at ``SHAPES``, inputs from a generator seeded 0; the shapes that stream on
both trees must give equal hashes), ``cases`` (``chip_smoke.
group_norm_cases``, from a generator seeded 0: ms, plain ms, library ms,
bound, and the plan, route and kernel where the tree has them),
``sweep`` (where the tree has ``gn_resident_plan``: the resident kernel
at ``SWEEP`` shapes in bf16 under its plan's and other block counts a
batch row, ms by ``chip_smoke.time_ms``), ``spatial`` (``SPATIAL_CALLS``
calls of the mid block of ``chip_smoke``'s
spatial phase under torch.profiler after a warm-up call: the device's busy
ms, the GroupNorm kernels' device ms and launches, device launches a call,
the profiled wall) and ``host_us``: the host's wall time a call of the
GroupNorm of a small x (B 4, HW 64, C 512, 32 groups, bf16: the device's
time a call is a fraction of it) over 2000 eager calls ended by one
sync. Needs one NVIDIA GPU.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

# (name, B, HW, C, G, dtype, offset in elements): the VAE mid block (16-bit:
# the resident route where the tree has it; fp32: streaming), the 512 x 512
# up block, rows of 120 bytes and a view one element in (streaming on
# both), JAX's test shapes
SHAPES = [("vae_mid_bf16", 4, 4096, 512, 32, torch.bfloat16, 0),
          ("vae_mid_fp16", 4, 4096, 512, 32, torch.float16, 0),
          ("vae_mid_fp32", 4, 4096, 512, 32, torch.float32, 0),
          ("vae_up_512_bf16", 1, 262144, 128, 32, torch.bfloat16, 0),
          ("rows_120B_bf16", 2, 33, 60, 20, torch.bfloat16, 0),
          ("view_fp32", 2, 64, 32, 8, torch.float32, 1),
          ("jax_a_bf16", 2, 256, 64, 8, torch.bfloat16, 0),
          ("jax_c_fp32", 3, 640, 128, 32, torch.float32, 0)]
# (B, HW, C, G): JAX's test shapes, one batch row of 4 MB, the VAE mid
# block, a 320-channel UNet width
SWEEP = [(2, 256, 64, 8), (1, 1024, 96, 12), (3, 640, 128, 32),
         (1, 4096, 512, 32), (4, 4096, 512, 32), (2, 4096, 320, 32)]
SWEEP_BLOCKS = (2, 4, 8, 16, 24, 32, 48, 64, 96, 132)
KEEP = ("case", "B", "HW", "C", "G", "dtype", "ms", "plain_ms", "library_ms",
        "bound_ms", "max_abs_err", "plan", "route", "kernel")
GN_KERNELS = ("gn_resident_kernel", "gn_stats_kernel", "gn_apply_kernel")
HOST_CALLS = 2000


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(
        t.contiguous().view(torch.uint8).cpu().numpy().tobytes()
    ).hexdigest()[:16]


def spatial_profile(cs, dev) -> dict:
    """The mid block of chip_smoke's spatial phase, profiled."""
    from deepspeed_tpu_torch.models.spatial import init_mid_block, mid_block
    B, side, C, G = (cs.SPATIAL[k] for k in ("B", "latent", "C", "groups"))
    params = init_mid_block(torch.Generator(device=dev).manual_seed(11), C,
                            device=dev, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn(B, side, side, C, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    calls = cs.SPATIAL_CALLS
    with torch.no_grad():
        mid_block(x, params, G)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                mid_block(x, params, G)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans, gn = [], defaultdict(lambda: [0.0, 0])
    for e in events:
        spans.append((e.time_range.start, e.time_range.end))
        name = next((k for k in GN_KERNELS if k in e.name), None)
        if name is not None:
            gn[name][0] += (e.time_range.end - e.time_range.start) / 1e3
            gn[name][1] += 1
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    return dict(calls=calls, busy_ms=busy / 1e3, wall_ms=wall * 1e3,
                launches_per_call=len(events) / calls,
                group_norm={k: dict(ms=v[0], launches=v[1])
                            for k, v in sorted(gn.items())})


def block_sweep(cs, dev, gen) -> dict:
    """The resident kernel under other block counts a batch row (those
    whose rows fit a block's shared memory), beside ``gn_plan``'s."""
    from deepspeed_tpu_torch.ops import spatial
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for B, HW, C, G in SWEEP:
        x = (3 * torch.randn(B, HW, C, generator=gen, device=dev) + 1
             ).to(torch.bfloat16)
        scale = torch.ones(C, device=dev, dtype=torch.bfloat16)
        bias = torch.zeros(C, device=dev, dtype=torch.bfloat16)
        plan = spatial.gn_plan(B, HW, C, G, 2, sms)
        times = {}
        for per_row in sorted({plan.blocks, *SWEEP_BLOCKS}):
            p = spatial.gn_resident_plan(HW, C, plan.vec, per_row)
            if (plan.route != "resident" or B * p.blocks > sms
                    or p.rows * C * 2 > spatial.GN_SMEM_BYTES
                    or str(p.blocks) in times):
                continue
            times[str(p.blocks)] = cs.time_ms(
                lambda: spatial._launch(x, scale, bias, torch.empty_like(x),
                                        G, 1e-6, p))
        out[f"{B}x{HW}x{C}/{G}"] = dict(plan_blocks=plan.blocks, ms=times)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("gn_kernels_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import fused_group_norm
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    hashes = {}
    for name, B, HW, C, G, dtype, offset in SHAPES:
        base = (3 * torch.randn(B * HW * C + offset, generator=gen,
                                device=dev) + 1).to(dtype)
        x = base[offset:].view(B, HW, C)
        scale = (1 + 0.1 * torch.randn(C, generator=gen, device=dev)
                 ).to(dtype)
        bias = (0.1 * torch.randn(C, generator=gen, device=dev)).to(dtype)
        hashes[name] = digest(fused_group_norm(x, scale, bias, G, eps=1e-6))
    gen.manual_seed(0)
    cases = [{k: c[k] for k in KEEP if k in c}
             for c in cs.group_norm_cases(dev, gen)]
    from deepspeed_tpu_torch.ops import spatial as ops_spatial
    sweep = (block_sweep(cs, dev, gen)
             if hasattr(ops_spatial, "gn_resident_plan") else None)
    spatial = spatial_profile(cs, dev)
    x = torch.randn(4, 64, 512, device=dev).to(torch.bfloat16)
    scale = torch.ones(512, device=dev, dtype=torch.bfloat16)
    bias = torch.zeros(512, device=dev, dtype=torch.bfloat16)
    for _ in range(50):
        fused_group_norm(x, scale, bias, 32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fused_group_norm(x, scale, bias, 32)
    torch.cuda.synchronize()
    host_us = (time.perf_counter() - t0) / HOST_CALLS * 1e6
    print(json.dumps(dict(tree=os.getcwd(), card=cs.nvidia_smi(),
                          hashes=hashes, cases=cases, sweep=sweep,
                          spatial=spatial,
                          host_us=host_us)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
