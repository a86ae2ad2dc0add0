#!/usr/bin/env python3
"""Where the serving, generate and training time goes on the GPU, for the
PyTorch / CUDA port.

Runs ``chip_smoke.py``'s scenarios under ``torch.profiler``: on llama-7b at
full width (bf16, or with ``--dtype`` a quantized mode, from seeded random
weights) ``serve`` (8 greedy requests of 32 new tokens through the
``ServingEngine``) and ``generate`` (one ``InferenceEngine.generate`` of 8
right-padded prompts of 64..500 tokens, 32 greedy new tokens, after one
unprofiled warm-up call); and ``train``:
OPT-1.3B at full size, 3 ``train_batch`` steps of ``chip_smoke``'s train
phase (bf16, micro batch 4 x 1024 tokens, AdamW) after one warm-up step, or
``sparse_train``: the same for its sparse_train phase (the Fixed sparse
layout, LAMB, micro batch 2 x 2048 tokens); ``spatial``: the SD v1.5 VAE
decoder's mid block of ``chip_smoke``'s spatial phase (bf16, a 64 x 64
latent of 512 channels, B 4), 5 calls after one warm-up call;
``moe_train``: ``chip_smoke``'s moe_train phase (moe-gpt-350m-8e, bf16, B 4
x 1024 tokens, AdamW, ZeRO 0), 3 steps after one warm-up step, with the
device time also split by what launched it (``moe_split_ms``): gating +
dispatch + combine (kernels launched inside ``moe_mlp`` outside the
expert FFN, and by the backward nodes those ops made), the expert GEMMs
(inside ``parallel.moe._expert_ffn`` and their backward nodes), the
attention kernels, Adam, the norm, and the rest. Prints one JSON line per
scenario:

* ``wall_ms`` — host wall time of the profiled scenario (ends in a sync;
  the profiler's own host-side cost is inside it);
* ``device_busy_ms`` / ``device_idle_share`` — the union of GPU kernel and
  copy intervals, and the share of the window the device sat idle;
* ``by_group_ms`` — device time of cuBLAS/CUTLASS GEMMs, the port's
  kernels, and everything else;
* ``port_kernels`` — device ms and calls of each of the port's kernels
  (``PORT_KERNELS``) that ran;
* ``top_kernels`` — the 12 kernels with the most device time;
* ``launches_per_iteration`` — GPU launches per serving iteration, per
  forward (the prefill and each decode step) for ``generate``, per step
  for ``train``, per call for ``spatial``.

    python3 scripts/profile_torch_serving.py
        [--scenario serve|generate|both|train|sparse_train|spatial|moe_train]
        [--dtype bf16|int8|int4|w8a8|w4a8] [--trace PATH]

``--trace`` also writes the Chrome trace (of the last scenario). Needs one
NVIDIA GPU; exits 1 without one and when the profiler records no device
activity.
"""

from __future__ import annotations

import json
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

PORT_KERNELS = ("ln_rows_kernel", "ln_scalar_kernel", "paged_split_kernel",
                "paged_prefill_kernel", "paged_prefill_tma_kernel",
                "flash_fwd_kernel",
                "flash_fwd_tma_kernel",
                "decode_split_kernel", "flash_bwd_kernel",
                "flash_bwd_prologue",
                "flash_bwd_epilogue", "flash_bwd_dq", "flash_bwd_dkv",
                "adam_kernel", "quant_matmul_kernel",
                "quant_matmul_tc_kernel", "quant_matmul_a8_kernel",
                "sparse_fwd_tma_kernel", "sparse_fwd_kernel", "sparse_bwd",
                "sparse_dq", "sparse_dkv",
                "lamb_phase1_kernel", "gn_resident_kernel", "gn_stats_kernel",
                "gn_apply_kernel", "quant_sym_kernel")
TRAIN_STEPS = 3


def group(name: str) -> str:
    low = name.lower()
    if any(k in name for k in PORT_KERNELS):
        return "port_kernels"
    if any(k in low for k in ("gemm", "cutlass", "xmma", "cublas", "nvjet")):
        return "gemm"                   # nvjet_*: cuBLAS's Hopper GEMMs
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other"


def union_ms(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def device_events(prof):
    """The device's kernels and copies (not the spans of profiler ranges,
    which cover the gaps between them)."""
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def breakdown(prof, wall_s: float, steps: int) -> dict:
    """Device time by group and by kernel, busy / idle share of the
    window; None when the profiler saw no device activity."""
    dev = device_events(prof)
    if not dev:
        return None
    by_group = defaultdict(float)
    by_name = defaultdict(lambda: [0.0, 0])
    by_port = defaultdict(lambda: [0.0, 0])   # each port kernel, ms / calls
    for e in dev:
        dur = (e.time_range.end - e.time_range.start) / 1e3
        by_group[group(e.name)] += dur
        by_name[e.name][0] += dur
        by_name[e.name][1] += 1
        port = next((k for k in PORT_KERNELS if k in e.name), None)
        if port is not None:
            by_port[port][0] += dur
            by_port[port][1] += 1
    busy = union_ms((e.time_range.start, e.time_range.end) for e in dev)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return dict(wall_ms=wall_s * 1e3, device_busy_ms=busy,
                device_idle_share=1.0 - busy / (wall_s * 1e3),
                by_group_ms=dict(by_group), device_events=len(dev),
                port_kernels={k: dict(ms=v[0], calls=v[1])
                              for k, v in sorted(by_port.items())},
                launches_per_iteration=len(dev) / steps,
                top_kernels=[dict(name=n[:120], ms=v[0], calls=v[1])
                             for n, v in top])


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("profile_torch_serving: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke

    trace = argv[argv.index("--trace") + 1] if "--trace" in argv else None
    scenario = (argv[argv.index("--scenario") + 1] if "--scenario" in argv
                else "serve")
    dtype = argv[argv.index("--dtype") + 1] if "--dtype" in argv else "bf16"
    if scenario not in ("serve", "generate", "both", "train",
                        "sparse_train", "spatial", "moe_train"):
        print(f"profile_torch_serving: unknown scenario {scenario}",
              file=sys.stderr)
        return 1
    if dtype not in ("bf16", "int8", "int4", "w8a8", "w4a8"):
        print(f"profile_torch_serving: unknown dtype {dtype}",
              file=sys.stderr)
        return 1
    smi = chip_smoke.nvidia_smi()
    results = []
    if scenario in ("train", "sparse_train"):
        return profile_train(smi, trace, scenario == "sparse_train")
    if scenario == "spatial":
        return profile_spatial(smi, trace)
    if scenario == "moe_train":
        return profile_moe_train(smi, trace)
    srv, _ = chip_smoke.make_server(
        torch.bfloat16 if dtype == "bf16" else dtype)
    if scenario in ("serve", "both"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            handles, _, steps, wall = chip_smoke.serve_requests(srv)
        out = breakdown(prof, wall, steps)
        if out is None:
            print("profile_torch_serving: the profiler recorded no device "
                  "activity (device time not measured)", file=sys.stderr)
            return 1
        results.append(dict(
            card=smi, scenario=f"chip_smoke serve: llama-7b {dtype}, 8 "
            "requests",
            iterations=steps, tokens=sum(len(h.tokens) for h in handles),
            **out))
    if scenario in ("generate", "both"):
        srv.close()
        eng = srv.engine
        ids, mask = chip_smoke.generate_prompts(eng.model.config.vocab_size)
        chip_smoke.generate_call(eng, ids, mask)          # warm-up
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            toks, ttft, wall, _ = chip_smoke.generate_call(eng, ids, mask)
        out = breakdown(prof, wall, chip_smoke.GEN_NEW)
        if out is None:
            print("profile_torch_serving: the profiler recorded no device "
                  "activity (device time not measured)", file=sys.stderr)
            return 1
        results.append(dict(
            card=smi, scenario=f"chip_smoke generate: llama-7b {dtype}, 8 "
            "prompts of 64..500 tokens, 32 new", forwards=chip_smoke.GEN_NEW,
            tokens=int(toks.size), ttft_ms=ttft * 1e3, **out))
    if trace:
        prof.export_chrome_trace(trace)
    for r in results:
        print(json.dumps(r), flush=True)
    return 0


def profile_train(smi: str, trace, sparse: bool) -> int:
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    phase = "sparse_train" if sparse else "train"
    spec = chip_smoke.TRAINS[phase]
    engine, batch, _ = chip_smoke.make_trainer(torch.device("cuda"), phase)
    engine.train_batch(batch=batch)                   # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        losses = [engine.train_batch(batch=batch)
                  for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = breakdown(prof, wall, TRAIN_STEPS)
    if out is None:
        print("profile_torch_serving: the profiler recorded no device "
              "activity (device time not measured)", file=sys.stderr)
        return 1
    if trace:
        prof.export_chrome_trace(trace)
    what = (f"{phase}: opt-1.3b bf16, micro batch {spec['B']} x {spec['S']}"
            " tokens, " + ("Fixed sparse layout, LAMB" if sparse
                           else "AdamW"))
    print(json.dumps(dict(
        card=smi, scenario=f"chip_smoke {what}",
        steps=TRAIN_STEPS, losses=[float(x) for x in losses],
        step_ms=wall * 1e3 / TRAIN_STEPS, **out)), flush=True)
    return 0


MOE_ROUTING, MOE_EXPERTS = "moe_mlp", "moe_expert_ffn"
BACKWARD = "autograd::engine::evaluate_function: "


def moe_split(prof, steps: int) -> dict:
    """Device ms a step by what launched each kernel. The port's kernels by
    name (attention: the flash kernels; Adam; the norm). The rest through
    the op that launched it: inside the profiler range MOE_EXPERTS
    (``parallel.moe._expert_ffn``) the expert GEMMs, else inside
    MOE_ROUTING (``moe_mlp``) gating + dispatch + combine; in the backward,
    by the forward op whose autograd node ran (the evaluate_function event
    carries that op's sequence number). ``unlinked``: kernels no op is
    linked to."""
    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]

    def chain(e):
        names = []
        while e is not None:
            names.append(e.name)
            e = e.cpu_parent
        return names

    def tag_of(names):
        if MOE_EXPERTS in names:
            return "expert_gemms"
        if MOE_ROUTING in names:
            return "gating_dispatch_combine"
        return None

    # forward ops (none under a backward node): a sequence number's tag is
    # the range of any op that carries it
    by_seq = {}
    for e in cpu:
        names = chain(e)
        if e.sequence_nr < 0 or any(n.startswith(BACKWARD) for n in names):
            continue
        tag = tag_of(names)
        if tag == "expert_gemms" or by_seq.get(e.sequence_nr) is None:
            by_seq[e.sequence_nr] = tag

    def port_group(name):
        if "flash_" in name:
            return "attention"
        if "adam_kernel" in name:
            return "adam"
        if "ln_rows_kernel" in name or "ln_scalar_kernel" in name:
            return "norm"
        return None

    split = defaultdict(float)
    total = 0.0
    for e in device_events(prof):
        dur = (e.time_range.end - e.time_range.start) / 1e3
        total += dur
        group_ = port_group(e.name)
        if group_:
            split[group_] += dur
    for e in cpu:
        kernels = [k for k in e.kernels if port_group(k.name) is None]
        if not kernels:
            continue
        names = chain(e)
        back = next((n for n in names if n.startswith(BACKWARD)), None)
        if back is not None:
            node = e
            while not node.name.startswith(BACKWARD):
                node = node.cpu_parent
            tag = by_seq.get(node.sequence_nr)
        else:
            tag = tag_of(names)
        for k in kernels:
            split[tag or "other"] += k.duration / 1e3
    split["unlinked"] = total - sum(split.values())
    return {k: v / steps for k, v in split.items()}


def profile_moe_train(smi: str, trace) -> int:
    import chip_smoke
    from torch.profiler import record_function

    from deepspeed_tpu_torch.models import transformer
    from deepspeed_tpu_torch.parallel import moe

    torch.backends.cuda.matmul.allow_tf32 = False
    engine, batch, _ = chip_smoke.make_moe_trainer(torch.device("cuda"), 0)
    engine.train_batch(batch=batch)                   # warm-up
    torch.cuda.synchronize()
    saved = transformer.moe_mlp, moe._expert_ffn

    def ranged(name, fn):
        def call(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return call

    transformer.moe_mlp = ranged(MOE_ROUTING, saved[0])
    moe._expert_ffn = ranged(MOE_EXPERTS, saved[1])
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            losses = [engine.train_batch(batch=batch)
                      for _ in range(TRAIN_STEPS)]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        transformer.moe_mlp, moe._expert_ffn = saved
    out = breakdown(prof, wall, TRAIN_STEPS)
    if out is None:
        print("profile_torch_serving: the profiler recorded no device "
              "activity (device time not measured)", file=sys.stderr)
        return 1
    if trace:
        prof.export_chrome_trace(trace)
    print(json.dumps(dict(
        card=smi, scenario=f"chip_smoke moe_train: {chip_smoke.MOE_PRESET} "
        f"bf16, micro batch {chip_smoke.MOE_B} x {chip_smoke.MOE_S} tokens, "
        "AdamW, ZeRO 0", steps=TRAIN_STEPS,
        losses=[float(x) for x in losses], step_ms=wall * 1e3 / TRAIN_STEPS,
        moe_split_ms=moe_split(prof, TRAIN_STEPS), **out)), flush=True)
    return 0


def profile_spatial(smi: str, trace) -> int:
    import chip_smoke
    from deepspeed_tpu_torch.models.spatial import mid_block

    params, x, G = chip_smoke.mid_block_inputs(torch.device("cuda"))
    calls = chip_smoke.SPATIAL_CALLS
    with torch.no_grad():
        mid_block(x, params, G)                       # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                mid_block(x, params, G)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    out = breakdown(prof, wall, calls)
    if out is None:
        print("profile_torch_serving: the profiler recorded no device "
              "activity (device time not measured)", file=sys.stderr)
        return 1
    if trace:
        prof.export_chrome_trace(trace)
    print(json.dumps(dict(
        card=smi, scenario="chip_smoke spatial: sd-v1.5 vae decoder mid "
        f"block, bf16, B {x.shape[0]}, latent {x.shape[1]} x {x.shape[2]}, "
        f"C {x.shape[3]}", calls=calls, call_ms=wall * 1e3 / calls, **out)),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
