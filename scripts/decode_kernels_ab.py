#!/usr/bin/env python3
"""The attention kernels of the decode paths, as one checkout builds them:
the bits they give on seeded inputs and their ``chip_smoke.py`` times.

Imports ``deepspeed_tpu_torch`` and ``chip_smoke`` from the WORKING
DIRECTORY, so that, run from an unpacked older checkout, it measures that
tree's kernels. To compare two commits on one card, run it in turns from
each checkout within one command (parent, change, change, parent) and
compare the lines:

    (cd build/parent && python3 ../../scripts/decode_kernels_ab.py)
    python3 scripts/decode_kernels_ab.py [--ptxas]

Prints one JSON line: ``tree`` (the working directory), the card
(nvidia-smi name and power limit), ``hashes`` (sha256 of the output bytes
of ``decode_attention``, ``paged_prefill_attention`` and
``paged_decode_attention`` on seeded inputs: dense decode at llama-7b's B 8
/ T 1024 step in bf16 and fp32, with alibi over key positions, at B 1 / T
4096, and at small GQA shapes in fp16; paged prefill at chip_smoke's chunk
(C 256 at start 256) in bf16 and fp32 and at a small fp16 GQA shape; paged
decode at the serve step; then paged prefill of the partial last chunk of a
700-token prompt, with 8 KV heads, and over two ragged rows in fp16), and
``times``: ``chip_smoke``'s
``decode_dense_cases``, ``prefill_cases`` and ``decode_cases`` (ms,
rotated ms where the tree has them, plain ms, bound), each from a generator
seeded 0. ``--ptxas`` first builds the two sources with ``nvcc -Xptxas
-v`` and prints its lines about the decode and prefill kernels (registers,
spills). Needs one NVIDIA GPU.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(
        t.contiguous().view(torch.uint8).cpu().numpy().tobytes()
    ).hexdigest()[:16]


def seeded(shape, dtype, dev, gen):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def dense_inputs(dev, gen, B, T, N, K, D, dtype, lo):
    q = seeded((B, N, D), dtype, dev, gen)
    k = seeded((B, T, K, D), dtype, dev, gen)
    v = seeded((B, T, K, D), dtype, dev, gen)
    lens = torch.randint(lo, T + 1, (B,), generator=gen, device=dev)
    valid = (torch.arange(T, device=dev)[None] < lens[:, None]).int()
    holes = torch.rand(B, T, generator=gen, device=dev) < 0.1
    valid = valid * (~holes).int()
    valid[:, 0] = 1
    return q, k, v, valid.contiguous()


def hashes(dev) -> dict:
    from deepspeed_tpu_torch.models.transformer import alibi_slopes
    from deepspeed_tpu_torch.ops import (decode_attention,
                                         paged_decode_attention,
                                         paged_prefill_attention)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {}
    for name, B, T, N, K, D, dtype, alibi, kv_len in (
            ("dense_b8_bf16", 8, 1024, 32, 32, 128, torch.bfloat16, False,
             1000),
            ("dense_b8_fp32", 8, 1024, 32, 32, 128, torch.float32, False,
             1000),
            ("dense_b8_alibi_bf16", 8, 1024, 32, 32, 128, torch.bfloat16,
             True, 1000),
            ("dense_b1_t4096_bf16", 1, 4096, 32, 32, 128, torch.bfloat16,
             False, 4000),
            ("dense_gqa8_fp16", 2, 500, 32, 4, 64, torch.float16, True, 480),
            ("dense_d48_bf16", 3, 300, 8, 2, 48, torch.bfloat16, False,
             290)):
        q, k, v, valid = dense_inputs(dev, gen, B, T, N, K, D, dtype, T // 2)
        kw = dict(kv_len=kv_len)
        if alibi:
            kw["alibi"] = alibi_slopes(N, device=dev)
            kw["key_positions"] = (torch.arange(T, device=dev)[None].float()
                                   - 3.0 * torch.arange(B, device=dev)[:, None]
                                   ).contiguous()
        out[name] = digest(decode_attention(q, k, v, valid, **kw))
    for name, B, C, N, K, D, BS, MAXB, dtype, start in (
            ("prefill_c256_bf16", 1, 256, 32, 32, 128, 16, 64,
             torch.bfloat16, 256),
            ("prefill_c256_fp32", 1, 256, 32, 32, 128, 16, 64,
             torch.float32, 256),
            ("prefill_gqa_fp16", 2, 40, 16, 4, 64, 16, 8, torch.float16, 9)):
        NB = B * MAXB + 1
        kp = seeded((NB, BS, K, D), dtype, dev, gen)
        vp = seeded((NB, BS, K, D), dtype, dev, gen)
        bt = (torch.randperm(NB - 1, generator=gen, device=dev) + 1).view(
            B, MAXB).int().contiguous()
        q = seeded((B, C, N, D), dtype, dev, gen)
        st = torch.full((B,), start, dtype=torch.int32, device=dev)
        nv = torch.full((B,), C - 3, dtype=torch.int32, device=dev)
        out[name] = digest(paged_prefill_attention(q, kp, vp, bt, st,
                                                   n_valid=nv))
    R, N, K, D, BS, MAXB = 8, 32, 32, 128, 16, 64
    NB = R * MAXB + 1
    kp = seeded((NB, BS, K, D), torch.bfloat16, dev, gen)
    vp = seeded((NB, BS, K, D), torch.bfloat16, dev, gen)
    bt = (torch.randperm(NB - 1, generator=gen, device=dev) + 1).view(
        R, MAXB).int().contiguous()
    q = seeded((R, N, D), torch.bfloat16, dev, gen)
    lengths = torch.tensor([1, 1000, 0, 517, 64, 333, 800, 129],
                           dtype=torch.int32, device=dev)
    out["paged_decode_serve8_bf16"] = digest(
        paged_decode_attention(q, kp, vp, bt, lengths))
    # the prefill kernel's later cases, from a generator of their own (the
    # cases above draw the same numbers in every tree)
    gen.manual_seed(1)
    for name, B, C, K, starts, valid, dtype in (
            ("prefill_tail_bf16", 1, 256, 32, [512], [188],
             torch.bfloat16),
            ("prefill_gqa_bf16", 1, 256, 8, [256], [256], torch.bfloat16),
            ("prefill_ragged_fp16", 2, 200, 8, [0, 37], [200, 150],
             torch.float16)):
        N, D, BS, MAXB = 32, 128, 16, 64
        NB = B * MAXB + 1
        kp = seeded((NB, BS, K, D), dtype, dev, gen)
        vp = seeded((NB, BS, K, D), dtype, dev, gen)
        bt = (torch.randperm(NB - 1, generator=gen, device=dev) + 1).view(
            B, MAXB).int().contiguous()
        q = seeded((B, C, N, D), dtype, dev, gen)
        st = torch.tensor(starts, dtype=torch.int32, device=dev)
        nv = torch.tensor(valid, dtype=torch.int32, device=dev)
        out[name] = digest(paged_prefill_attention(q, kp, vp, bt, st,
                                                   n_valid=nv))
    torch.cuda.synchronize()
    return out


def times(dev) -> dict:
    import chip_smoke
    keep = ("case", "dtype", "ms", "ms_rotated", "rotated_ms",
            "dense_kernel_ms", "plain_ms", "library_ms", "flash_ms",
            "bound_ms", "start", "n_valid", "K", "B", "T", "split", "plan")
    res = {}
    for name in ("decode_dense_cases", "prefill_cases", "decode_cases"):
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        res[name] = [{k: c[k] for k in keep if k in c}
                     for c in getattr(chip_smoke, name)(dev, gen)]
    return res


def ptxas_report(registry) -> None:
    """Builds decode_attention.cu and paged_attention.cu with ``-Xptxas
    -v`` (both at once, into the registry's library paths) and prints, per
    kernel,
    how many instantiations, their registers (min..max) and those that
    spill; and each instantiation of the 16-bit D 128 layout (16 lanes x 8
    dims a key: the serve and generate shapes) and of the 16-bit D 128
    prefill kernel on its own line."""
    import re
    import subprocess
    names = ("paged_split_kernel", "decode_split_kernel",
             "paged_prefill_tma_kernel", "paged_prefill_kernel")
    registry.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in ("decode_attention", "paged_attention"):
        out = registry.library_path(src)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        procs.append((out, tmp, subprocess.Popen(
            [registry._nvcc(), *registry.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(tmp), str(registry.CSRC / f"{src}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = []
    for out, tmp, proc in procs:
        logs.append(proc.communicate()[0])
        if proc.returncode == 0:
            os.replace(tmp, out)      # the library the registry then loads
    entries = {}                # mangled name -> {regs, spill}
    entry = None
    for line in "\n".join(logs).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            entries[entry] = dict(regs=None, spill=0)
            continue
        if entry is None:
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entries[entry]["regs"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            entries[entry]["spill"] = int(m.group(1))
    stats = {}
    for name, e in entries.items():
        base = next((n for n in names if n in name), None)
        if base is None or e["regs"] is None:
            continue
        args = re.search(base + r"I(.*?)EEv", name)
        what = base + "<" + (args.group(1) if args else "?") + ">"
        st = stats.setdefault(base, dict(n=0, regs=[], spills=[]))
        st["n"] += 1
        st["regs"].append(e["regs"])
        if e["spill"]:
            st["spills"].append((what, e["spill"]))
        if "Li8ELi16E" in name or (base == "paged_prefill_tma_kernel"
                                   and "Li128E" in name):
            print(f"[ptxas] {what}: {e['regs']} registers, {e['spill']} "
                  "bytes spilled", flush=True)
    for base, st in stats.items():
        print(f"[ptxas] {base}: {st['n']} instantiations, registers "
              f"{min(st['regs'])}..{max(st['regs'])}, spilling "
              f"{st['spills'] or 'none'}", flush=True)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("decode_kernels_ab: no CUDA device", file=sys.stderr)
        return 1
    from deepspeed_tpu_torch.ops import registry
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    if "--ptxas" in argv:
        ptxas_report(registry)
    for name in ("decode_attention", "paged_attention"):
        registry.library(name)
    import chip_smoke
    print(json.dumps(dict(tree=os.getcwd(), card=chip_smoke.nvidia_smi(),
                          hashes=hashes(dev), times=times(dev))),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
