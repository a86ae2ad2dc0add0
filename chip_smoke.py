#!/usr/bin/env python3
"""Build and drive the PyTorch / CUDA port (``deepspeed_tpu_torch``) on one
NVIDIA GPU, and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line (``{"phase": ...}``):

1. ``device``  — the card (nvidia-smi name and power limit), torch and CUDA
   versions.
2. ``build``   — compile every ``deepspeed_tpu_torch/csrc/*.cu`` with nvcc
   for sm_90a (one process per source, in parallel); seconds taken.
3. ``kernels`` — each CUDA kernel against its plain PyTorch version on the
   same inputs, at the shapes of the serving and generate paths, in bf16
   and fp32: max abs error against the stated tolerance, the kernel's and
   the plain version's device time (CUDA events around CUDA-graph
   replays), the least time the card could take (bytes over 3.35 TB/s vs
   operations over the peak rate), and one PyTorch library call computing
   the same function where there is one (``scaled_dot_product_attention``
   with an explicit mask for the dense attention kernels; timed here only,
   the port never calls it). The four quantized decode GEMMs run at
   llama-7b's weight sites, 1 and 8 rows, int4 with one group and with
   groups of 128, in bf16 and fp32, the weight-only ones (bf16 / fp16 on
   the tensor-core ``quant_matmul_tc_kernel``, fp32 on the CUDA-core
   ``quant_matmul_kernel``) also in fp16; the a8 ones must equal their
   plain versions bit for bit. At 8 rows in bf16 every one of them and its
   yardstick (the dense ``torch.matmul``, or ``torch._int_mm``) are also
   timed over weight copies larger than the L2.
4. ``serve``   — ``init_serving("llama-7b")`` at full width (H 4096, 32
   layers, 32 heads, D 128, FFN 11008, vocab 32000; seeded random bf16
   weights) serves 8 greedy requests (prompts of 64..700 tokens, two sharing
   a 256-token prefix so the prefix cache and copy-on-write run; 32 new
   tokens each). Launch counts are zeroed just before and read just after:
   each of the serving path's three kernels must have run. Prints TTFT and
   tokens/s.
5. ``e2e_parity`` — the same model cut to 2 layers at full width, fp32:
   one prefill chunk and 8 decode steps through the kernel path and
   through the plain versions (``forward(..., plain=True)``) on the card,
   over an arena whose unwritten slots hold NaN; last-position logits
   must agree.
6. ``generate`` — the serving engine is closed and its ``InferenceEngine``
   (the same llama-7b weights) runs ``generate`` on 8 right-padded prompts
   of 64..500 tokens with an attention mask, 32 greedy new tokens, twice
   (the second call reuses the dense arena). Launch counts are zeroed
   before each call and read after it: ``flash_attention``,
   ``decode_attention`` and ``fused_layer_norm`` must each have run.
   Prints TTFT, decode tokens/s and the counts.
7. ``e2e_generate_parity`` — llama-7b widths at 2 layers, fp32, 2 prompts
   of 200 and 77 tokens: the dense static prefill and 8 decode steps
   through the kernel path and through the plain versions, over an arena
   whose slots outside ``valid`` hold large finite values; last-position
   logits must agree.
8. ``quant_generate`` — ``init_inference("llama-7b", dtype=mode)`` from
   the same seeded weights, quantized on load, in int8, w8a8 (over the
   int8 tree), int4 and w4a8 (over the int4 tree), each generating as the
   generate phase does, twice. Each call must launch its mode's GEMM
   exactly 225 x 31 times (every weight site of every decode forward) and
   the other three not at all. Prints TTFT, decode tokens/s, weight bytes
   on the device and peak memory. ``quant_serve`` — the serve scenario
   over the int8 tree; ``int8_matmul`` must run.
9. ``e2e_quant_parity`` — the 2-layer fp32 dense check of phase 7 with
   int8, int4 and int4 (groups of 128) weights, each weight-only and with
   quantized activations (w8a8, w4a8): the decode steps through the
   quantized GEMM kernels against ``plain=True`` (weight-only) or against
   the kernel path with the a8 GEMMs' plain versions (w8a8, w4a8; their
   distance to ``plain=True`` is reported).
10. ``train`` — once the llama-7b phases have released their memory,
   ``initialize`` trains OPT-1.3B at full size (H 2048, 24 layers, 32 heads
   of 64, FFN 8192, vocab 50272; seeded random bf16 weights) with the
   ``bench_zero.py`` config (bf16, AdamW lr 1e-4, micro batch 4, seq 1024,
   gas 1, ZeRO stage 0): one warm-up step, then 5 ``train_batch`` steps on
   one fixed seeded token batch. Every loss must be finite and the last
   below the first; launch counts are zeroed before the 5 steps and each of
   the path's five kernels must have run its expected count per step.
   Prints step ms, tokens/s, MFU and peak memory.
11. ``e2e_train_parity`` — OPT-1.3B widths at 2 layers, fp32: 3 optimizer
   steps through the kernel path and through the plain path (a model whose
   ``loss_fn`` runs ``forward(..., plain=True)``, and a
   ``MixedPrecisionOptimizer(..., plain=True)``) on the card from the same
   weights and batch; per-step losses, and leaf for leaf the first step's
   grads and the final params, must agree.
12. ``zero`` — in a world-1 NCCL group (``comm.init_distributed`` through a
   ``file://`` store in a temporary directory), OPT-1.3B at the train
   phase's config, weights and batch under ZeRO stages 1, 2 and 3: a
   warm-up and ZERO_STEPS timed steps each, with the train path's exact
   launches (one vector-route Adam launch a step), losses within
   the train phase's within a bound derived in the phase (ZERO_SPREAD_
   FACTOR times the spread of a repeat of stage 0 against the train phase,
   at least ZERO_LOSS_FLOOR), at most two gather units alive at stage 3;
   then one step with the comms logger on. Prints each stage's step ms,
   peak memory, launches and each collective's count and bytes a step.
13. ``checkpoint`` — in the same group: OPT-1.3B at stage 2 with a WarmupLR
   schedule trains 2 steps and is saved in format 2 (~18.4 GB) on the disk
   of the temporary directory or the checkout with more free space
   (failing if it has under CKPT_NEED_BYTES); ``verify_checkpoint``
   re-hashes it; a fresh stage-3 engine loads it and must hold the same
   params, master, moments, counts, loss scale and schedule bit for bit;
   one more step on each, losses within the zero bound; the 16-bit export
   is read back bit for bit. Prints the disk, GB written, seconds and GB/s
   of the save, the verify and the (warm) load.
14. ``lamb_zero`` — OPT-1.3B with the train configuration and LAMB at ZeRO
   stages 0 and 3 (stage 3's segments are the shard's parts of leaves, the
   per-leaf norms all-reduced): a warm-up and 2 timed steps each, exact
   launches (one LAMB phase-1 launch a step, no Adam), stage 3's losses
   within the zero bound of stage 0's.
15. ``onebit`` — OPT-1.3B under ``onebitadam`` (freeze_step 2, 5 steps):
   the first loss equals the train phase's (dense AdamW) bit for bit, the
   next two within the zero bound, the compressed ones falling and within
   5% of dense; ``onebitlamb`` and ``zerooneadam`` 3 steps each. Prints
   step ms and the comms log's bytes a step, dense and compressed.
16. ``offload_parity`` — llama-7b's widths at 2 layers, bf16, trained 3
   steps resident, under host-memory offload and under NVMe offload, each
   step on the tier-1 engine's grads: tier 2 equals tier 1 bit for bit
   (losses, master, moments); every resident step is held to tier 1's by
   ``check_adam`` from the same old state (the resident state is set to
   tier 1's after each check), each step's losses within 1e-5; fused Adam
   launches only resident.
17. ``offload`` — llama-7b at full size (H 4096, 32 layers, FFN 11008,
   vocab 32000, bf16, 1 x 2048 tokens, ZeRO 1) with its master and moments
   (80.9 GB) in host memory: a warm-up and 2 timed steps; losses finite and
   falling; exact launches (no Adam); the state CPU tensors and the card
   holding only the 16-bit params and grads. Prints the step split (device
   forward + backward, D2H, host update, H2D), the GB moved each way, peak
   device memory and host RSS.
18. ``nvme`` — OPT-1.3B under NVMe offload on the largest disk: 2 steps, a
   checkpoint with its swap snapshot and one more step, the losses within
   the zero bound of the train phase's; the checkpoint restored into a
   fresh engine (state and next loss bit for bit). Prints GB read and written a step, GB/s, the host
   update's seconds. The swap directories are removed.
19. ``param_offload_parity`` — llama-7b's widths cut to 2 layers (bf16, 1 x
   2048 tokens, AdamW, stage 3) trained side by side resident and under
   parameter offload (``offload_param``) on the cpu and the nvme tier: 3
   steps of the fused path, then from a fresh init 2 steps at gas 2 with a
   clip that clips (the deferred path). The cpu tier's grads (the
   executor's ``grad_hook``) feed the nvme tier and the resident engine's
   accumulator; each step the resident master and moments are held to the
   cpu tier's by the fused Adam tolerance from the same old state and
   grads, then set to them; losses within the zero bound of the cpu
   tier's; the nvme tier equals the cpu tier bit for bit (losses, params,
   master, moments); exact launches a step (Adam once a block and once
   for the resident part; the backward's recompute adds a flash forward and
   two norms a layer).
20. ``param_offload`` — llama-7b at full size (32 layers) on the nvme tier,
   at full width and 16 layers on the cpu tier (its 14 bytes a param of
   host memory would not fit at 32) and at 4 layers on the nvme tier: a
   warm-up and 2 timed fused steps each, on the largest local disk (20 GB
   free needed); losses finite and falling, exact launches, at most two
   blocks on the card; peak device memory at 32 layers within 28 boundary
   activations and a stated slack of 4 layers'. Prints each run's step
   split (forward, backward with recompute, block updates), the card's
   busy seconds (CUDA events around its work) and the host's staging-copy
   seconds, GB each way and on disk, fetch waits, peak device memory and
   host RSS.
21. ``comm_bench`` — ``comm/benchmark.py``'s sweep at world 1: a 64 MiB
   message an op, latency and bandwidths. The group is destroyed.
22. ``sparse_train`` — OPT-1.3B at full size with DeepSpeed's Fixed sparse
   layout (block 16, 4 local blocks, 1 global, unidirectional) as its
   ``attention_impl`` and LAMB (lr 1e-3, weight decay 0.01), bf16, micro
   batch 2 x 2048 tokens: a warm-up step, then 5 timed ``train_batch``
   steps on one seeded batch. Losses finite and falling; launch counts,
   zeroed before the timed steps, exact: the block-sparse forward and
   backward 24 a step each, the flash kernels and Adam none, the norm 49, LAMB phase 1
   once. Prints step ms, tokens/s, MFU (PR 3's formula at S 2048), peak
   memory, and beside the formula's attention FLOPs (all S^2 pairs) those
   of the pairs the layout lets attend.
23. ``e2e_sparse_train_parity`` — OPT-1.3B widths at 2 layers, fp32, S 512,
   the Fixed layout, LAMB with weight decay and clipping: 3 steps through
   the kernel path and through the plain path, held as in phase 11 (the
   update within E2E_SPARSE_TRAIN_TOL; ``scripts/lamb_parity_faults.py``
   reads the same measures with faults planted in the kernel path's LAMB).

24. ``spatial`` — the Stable Diffusion v1.5 VAE decoder's mid block
   (resnet -> attention -> resnet) at full width: a 64 x 64 latent of 512
   channels, 32 groups, eps 1e-6, batch 4, seeded bf16 weights (10.5 M
   parameters): a warm-up, then 5 timed calls with exact launch counts (5
   ``fused_group_norm`` and 1 ``flash_attention``, head_dim 512, a call).
   The output must be finite and within SPATIAL_TOL of the plain path.
   Prints ms a call, latents/s, the share of the bf16 peak at its FLOPs and
   peak memory.
25. ``e2e_spatial_parity`` — the same block in fp32 on a 16 x 16 latent, B
   2: the kernel path against ``plain=True`` within E2E_TOL.
26. ``quantize`` — ``fake_quantize`` (int8, groups of 128) over every
   weight leaf of OPT-1.3B in bf16 under autograd: one quantize launch a
   leaf, the gradient passed through bit for bit, |deq - w| within half a
   scale plus one bf16 ulp; then int4 ``quantize_symmetric`` over the same
   leaves, bit-equal to its plain version.
27. ``moe_train`` — in the world-1 NCCL group, after ``comm_bench``:
   moe-gpt-350m-8e at full width (H 1024, 24 layers, 16 heads of 64, 8
   experts of FFN 4096, top-2, vocab 50257, tied; 1.76 B parameters, 0.56 B
   active a token; seeded random bf16 weights) with the train
   configuration, B 4 x S 1024, through the engine's MoE process groups
   (global gating and the expert-parallel code at world 1, ep 1; two ranks
   on the one card are not run: NCCL refuses them, as
   ``scripts/nccl_shared_card_probe.py`` shows): a warm-up step (its routing
   recorded through
   ``parallel.moe.PLAN_LOG``: capacity, the share of assignments dropped,
   the least and most tokens an expert kept, the aux loss), 3 timed steps
   with exact launches (MOE_TRAIN_KERNELS) and falling losses, then a
   stage-0 repeat and 2 steps at ZeRO stage 3 from the same weights and
   batch, stage 3's losses within the zero bound of stage 0's, or within
   ZERO_SPREAD_FACTOR times the repeat's spread where that is larger.
   Prints step ms, tokens/s, MFU on the active parameters and peak memory.
28. ``moe_param_offload`` — the same model, batch and AdamW under ZeRO-3
   parameter offload, one layer a block (24 blocks), on the nvme tier
   then the cpu tier: the streamed init draws moe_train's weights, so the
   first two losses are held to moe_train's stage-3 losses within 10x the
   larger of moe_train's two run-to-run spreads (its stage-0 repeat's and
   stage 3's), at least stage 3's bound; a warm-up step's routing (one
   plan a layer: the backward's recompute routes again unlogged), then 2
   timed steps with exact
   launches (``param_offload_launches``: #16 once a block and once for the
   resident part). Prints each step split into forward / backward
   (recompute) / block updates, ``device_busy_s``, ``host_copy_s``, GB
   each way and on disk, peak device memory beside moe_train stage 3's,
   host RSS.
29. ``moe_optim`` — the same model and batch, 3 steps each with exact
   launches and falling losses under host-memory optimizer offload at ZeRO
   1 (the host update over 1.76 B elements), LAMB at ZeRO 0 and 2 (#17 once
   a step) and onebitadam at ZeRO 0 past its freeze step (compressed from
   the second step). Prints step ms, peak memory, host RSS.
30. ``moe_generate`` — ``init_inference("moe-gpt-350m-8e")`` in bf16, then
   int8 over the same weights (attention sites quantized, expert banks
   dense): two ``generate`` calls each on the generate phase's prompts;
   the first call of each launches the generate kernels, int8's exactly
   4 x 24 x 31 int8 GEMMs. Prints TTFT, decode tokens/s and the bf16 / int8
   token agreement (not a gate). ``moe_serve`` — ``init_serving`` over the
   bf16 weights, the serve phase's 8 requests; the serving kernels run.
31. ``e2e_moe`` — the same widths at 2 layers, fp32: cache-less, dense-arena
   and paged logits of the kernel path within E2E_TOL of ``plain=True``,
   each with its routing margin guarded (``RouterSpy``: the smallest gap of
   a token's top-(k+1) gates above twice the two paths' gate difference),
   and ``train_parity`` at E2E_TRAIN_TOL.

The ``kernels`` phase holds the norm at llama-7b's decode step (8 x 4096)
and serve chunk (256 rows, RMSNorm and LayerNorm with bias), generate's
static prefill (4096 x 4096), OPT-1.3B's training rows (4096 x 2048,
LayerNorm with bias) and llama-7b's under offload (2048 x 4096), each with the launch shape ``ln_plan`` gave it, the
8- and 256-row bf16 cases also over scale copies larger than the L2; the
paged decode kernel at the serve step
(``serve8``: 8 rows of 0..1000 keys) and over one row of 4000 keys
(``long1``), also over pool copies larger than the L2 and beside the dense
decode kernel over the same keys; the paged prefill kernel at serve's chunk
(start 0, 256, 512), the 700-token prompt's partial last chunk and a GQA
chunk, beside SDPA over the keys gathered from the pages. It also holds the block-sparse forward
and backward at the sparse_train shape (B 2, S 2048, 32 heads of 64) for
the Fixed, sliding window and BSLongformer layouts, and at small shapes
with a key-less q-tile and with BigBird's per-head layouts, beside the
port's flash kernels at the same shape; the LAMB phase-1 kernel on a flat buffer of 64 Mi elements
and segmented over OPT-1.3B's leaves (1.3 B elements); the GroupNorm
kernel at the mid block's shape, JAX's test shapes and the VAE decoder's
512 x 512 up block, each with the route ``gn_plan`` took (the resident
kernel, one launch, where a block's rows fit its shared memory; else the
streaming pair), ``F.group_norm`` as yardstick, and on 300 + 0.01 N(0, 1)
against float64 on either route; group quantization,
bit for bit, over OPT-1.3B's 1.316 B bf16 parameters and 64 Mi elements;
the flash forward at head_dim 512 (the mid block's self attention,
cross attention over 77 keys; SDPA as yardstick); and the flash forward
and backward at OPT-1.3B's training shape and at llama-7b's under offload
(B 1, S 2048, 32 heads of 128; causal, no mask; SDPA with ``is_causal`` as
yardstick). The ``kernels`` line gives those three kernels' llama-7b
training case under ``llama_train`` (kernel or plan, error, ms). Fused
Adam also runs at parameter offload's two calls on llama-7b (a layer's
block with fp32 grads and a clip scale; the resident part with bf16
grads), given under ``param_offload`` in the ``kernels`` line. At
moe-gpt-350m-8e's training shapes the norm (4096 x 1024, LayerNorm with
bias), the flash forward and backward (B 4, S = T 1024, 16 heads of 64,
causal) and fused Adam over the model's 1.76 B elements in one launch
(``adam_model_case``: held to the plain version slice by slice) are given
under ``moe_train``; fused Adam at moe_param_offload's two calls (a layer's
block and the resident part, bf16 grads) under ``moe_param_offload``, and
the LAMB phase-1 kernel over the model's 1.76 B elements in its leaves
(``lamb_model_case``: held to the plain version piece by piece) under
``moe_optim``.

Then one ``{"kernels": [...]}`` line (``kernel``: the CUDA kernel that runs
at the main path's shape; ``launches``: each wrapper's count over
the serve run, the first generate call, the first call of each quantized
mode, the int8 serve run, the 5 timed train steps, the zero phase's 2
timed steps of each stage 1-3, lamb_zero's 2 timed steps a stage,
offload's 2 timed steps, param_offload's 2 timed steps of each run, the 5
timed sparse_train steps, the 5 timed
spatial calls, the quantize phase's fake_quantize pass, moe_train's 3 + 2
timed steps, moe_param_offload's 2 timed steps a tier, moe_optim's 3
steps a run, the first bf16 and int8 moe_generate calls and the moe_serve
run), the nvidia-smi line, and as the last line ``{"ok":
true, "device": {...}}``. Each phase's line carries ``at_s``, the seconds
since the start, and the ``kernels`` phase's line the seconds each group
of cases took.
Any failed check raises and the exit code is non-zero; without a CUDA
device it exits 1 and prints no result.
"""

from __future__ import annotations

import dataclasses
import gc
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from deepspeed_tpu_torch import comm, initialize
from deepspeed_tpu_torch.comm.benchmark import run_comm_benchmark
from deepspeed_tpu_torch.inference import init_inference
from deepspeed_tpu_torch.inference.kv_cache import (cache_memory_bytes,
                                                    init_cache,
                                                    init_paged_cache)
from deepspeed_tpu_torch.models import (Model, create_model, is_quantized,
                                        param_count, tree_bytes)
from deepspeed_tpu_torch.models.core import tree_items, tree_leaves
from deepspeed_tpu_torch.models.spatial import init_mid_block, mid_block
from deepspeed_tpu_torch.models.presets import transformer_config
from deepspeed_tpu_torch.models.transformer import (_quantize_int8,
                                                    alibi_slopes, forward,
                                                    init_params,
                                                    quantize_model_weights)
from deepspeed_tpu_torch.models import transformer
from deepspeed_tpu_torch.ops import quant_matmul
from deepspeed_tpu_torch.ops import (
    BigBirdSparsityConfig, BSLongformerSparsityConfig, FixedSparsityConfig,
    LambSegments, LocalSlidingWindowSparsityConfig,
    block_sparse_attention_bwd,
    block_sparse_attention_bwd_magnitude, block_sparse_attention_fwd,
    build_tile_plan, lamb_phase1, lamb_phase2, lamb_step,
    make_sparse_attention_impl,
    reference_block_sparse_attention, reference_block_sparse_attention_bwd,
    reference_lamb_flat, reference_lamb_phase1, tile_plan_for)
from deepspeed_tpu_torch.ops import (decode_attention,
                                     flash_attention, flash_attention_bwd,
                                     flash_attention_bwd_magnitude,
                                     fused_adam_flat, fused_layer_norm,
                                     launch_counts, reference_adam_flat,
                                     paged_decode_attention,
                                     paged_prefill_attention,
                                     reference_decode_attention,
                                     reference_flash_attention,
                                     reference_flash_attention_bwd,
                                     reference_layer_norm,
                                     reference_paged_attention,
                                     reset_launch_counts)
from deepspeed_tpu_torch.ops import (fake_quantize, fused_group_norm,
                                     quantize_symmetric,
                                     reference_group_norm,
                                     reference_quantize_symmetric)
from deepspeed_tpu_torch.ops import fused_adam, registry
from deepspeed_tpu_torch.ops.decode_attention import decode_split_plan
from deepspeed_tpu_torch.ops.normalization import ln_plan
from deepspeed_tpu_torch.ops.paged_decode_attention import (
    paged_prefill_plan, paged_split_plan, prefill_kernel)
from deepspeed_tpu_torch.ops.spatial import gn_plan
from deepspeed_tpu_torch.parallel import moe
from deepspeed_tpu_torch.runtime import MixedPrecisionOptimizer
from deepspeed_tpu_torch.runtime.optimizer import zero_one_var_step
from deepspeed_tpu_torch.runtime import checkpoint as ckpt
from deepspeed_tpu_torch.serving import ServingConfig, init_serving

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
BF16_FLOPS = 989e12                # dense tensor-core peak, bf16
INT8_OPS = 1979e12                 # dense tensor-core peak, int8
FP32_FLOPS = 67e12                 # fp32 outside the tensor cores

# (atol, rtol): |kernel - plain| <= atol + rtol * |plain| elementwise. fp32:
# the same arithmetic in another order; bf16: one bf16 rounding of outputs
# of size up to ~4 (1 ulp = 2^-6 there) plus the plain version's own bf16
# intermediates; fp16 (the weight-only quantized GEMMs): one fp16 rounding
# (at most 2^-10 relative) of fp32 sums taken in another order
TOL = {torch.bfloat16: (2e-2, 2e-2), torch.float16: (5e-3, 5e-3),
       torch.float32: (2e-5, 2e-5)}
E2E_TOL = 2e-4     # fp32 logits of |x| <= ~6 after 2 layers
# the flash backward's 16-bit kernels round P and dS once to the input type
# before their products: their error against the plain version is at most
# that rounding (2^-9 in bf16; twice it here) times the sum of the terms'
# magnitudes (``flash_attention_bwd_magnitude``), on top of TOL
BWD_ROUND = {torch.bfloat16: 2.0 ** -8, torch.float32: 0.0}
# fused Adam against its plain version: the same fp32 arithmetic, which the
# compiler may contract into FMAs. Each of m, v and the update lr * u is held
# within ADAM_RTOL of the sum of its terms' magnitudes (a few fp32 ulps
# each; a sum that cancels keeps the error of its terms), so small moments
# are held as tightly as large ones; the new params also within two ulps of
# their own rounding (ADAM_P_ROUND * |p|). The bf16 working copy may then
# round one bf16 ulp apart.
ADAM_RTOL = 1e-5
ADAM_P_ROUND = 2.0 ** -22
ADAM_COPY_TOL = (0.0, 2.0 ** -7)
# 2-layer fp32 training, kernel path vs plain path, both fp32 but summing
# in other orders (~1e-6 relative per op). OPT's ReLU turns that into
# whole-term differences wherever a pre-activation sits within rounding of
# 0, and Adam's normalised update turns a gradient's relative difference
# into the same relative difference of its step. Measures, each the worst
# leaf: the first step's gradient as ||dg|| / ||g|| per leaf, and the
# params after 3 steps as ||dp|| / ||p_3 - p_0|| per leaf (the difference
# of the two trajectories against how far the leaf moved); losses
# relative. A leaf whose plain gradient is zero up to rounding (at most
# ZERO_GRAD times the largest gradient element: a few fp32 ulps of it) is
# left out of both, since its gradient and its Adam steps are rounding
# noise: OPT's attention key bias, whose gradient is zero because softmax
# does not change when one bias is added to every key. Observed on an H100
# 80GB HBM3 (700 W): losses 3.0e-5, worst gradient leaf 3.4e-4
# (layers.mlp.w_up), worst update leaf 2.1e-2 (layers.attn.bo); bk's
# gradient is at most 9e-10 against a largest element of 5.7e-2.
ZERO_GRAD = 1e-6
# Those trajectories are noise-bound: an element whose gradient is rounding
# noise flips sign between the paths, and the normalised step turns each
# flip into a whole step, so they cannot see a small fault of the
# optimizer. The optimizer alone is held apart: a third kernel-path engine
# takes its first step on the plain path's first gradients, ||dp|| /
# ||p_1 - p_0|| per leaf against the plain first step. That is the same
# fp32 arithmetic on the same inputs, a few ulps apart: 8.0e-7 here with
# Adam, held to 1e-4.
E2E_TRAIN_TOL = {"loss_rel": 1e-4, "grad_rel": 1e-3, "update_rel": 3e-2,
                 "opt_step_rel": 1e-4}
# The same measures for 2-layer fp32 sparse attention + LAMB. Observed on an
# H100 80GB HBM3 (700 W) with ``scripts/lamb_parity_faults.py`` at seeds 7 /
# 8 / 9 (the phase runs 7): losses 1.9e-6 / 4.7e-7 / 9.4e-8, worst gradient
# leaf 6.3e-4 / 9.3e-4 / 3.8e-4, worst update leaf 3.8e-2 / 4.4e-2 / 1.9e-2
# (a bias each time; the worst weight matrix 2.1e-2 / 1.2e-2 / 7.8e-3, not
# the same leaf twice), optimizer alone 2.5e-6 / 3.5e-6 / 2.3e-6. Faults
# planted in the kernel path's LAMB, seed 7: a trust ratio per layer,
# losses 4.6e-5 and optimizer alone 3.4e-3; the ratio clamped to [0.01,
# 10], losses 2.6e-5 (the clamp engages only from the second step); u
# applied in bf16, optimizer alone 1.9e-3; eps 1e-6 for 1e-8, update 0.34.
# Their update measure reads 3.8e-2 to 4.1e-2 but for eps's: inside the
# sound runs' spread. So the update limit sits above the sound runs
# (6e-2), and the loss limit between them and the faults (1e-5).
E2E_SPARSE_TRAIN_TOL = dict(E2E_TRAIN_TOL, loss_rel=1e-5, update_rel=6e-2)

# wrapper -> (its source, the TPU kernel it replaces, the CUDA kernel that
# runs at the main path's shape in bf16)
SOURCES = {
    "fused_layer_norm": ("deepspeed_tpu_torch/csrc/layer_norm.cu",
                         "deepspeed_tpu/ops/normalization.py:59",
                         "ln_rows_kernel"),
    "paged_decode_attention": ("deepspeed_tpu_torch/csrc/paged_attention.cu",
                               "deepspeed_tpu/ops/paged_decode_attention.py:171",
                               "paged_split_kernel"),
    "paged_prefill_attention": ("deepspeed_tpu_torch/csrc/paged_attention.cu",
                                "deepspeed_tpu/ops/paged_decode_attention.py:294",
                                prefill_kernel(torch.bfloat16, 128)),
    "flash_attention": ("deepspeed_tpu_torch/csrc/flash_attention.cu",
                        "deepspeed_tpu/ops/flash_attention.py:135",
                        "flash_fwd_tma_kernel"),
    "decode_attention": ("deepspeed_tpu_torch/csrc/decode_attention.cu",
                         "deepspeed_tpu/ops/decode_attention.py:161",
                         "decode_split_kernel"),
    "flash_attention_bwd": ("deepspeed_tpu_torch/csrc/flash_attention_bwd.cu",
                            "deepspeed_tpu/ops/flash_attention.py:286,311",
                            "flash_bwd_kernel"),
    "fused_adam": ("deepspeed_tpu_torch/csrc/fused_adam.cu",
                   "deepspeed_tpu/ops/fused_adam.py:72", "adam_kernel"),
    "int8_matmul": ("deepspeed_tpu_torch/csrc/quant_matmul.cu",
                    "deepspeed_tpu/ops/quant_matmul.py:79",
                    quant_matmul.weight_only_kernel(torch.bfloat16)),
    "int8_a8_matmul": ("deepspeed_tpu_torch/csrc/quant_matmul_a8.cu",
                       "deepspeed_tpu/ops/quant_matmul.py:167",
                       "quant_matmul_a8_kernel"),
    "int4_a8_matmul": ("deepspeed_tpu_torch/csrc/quant_matmul_a8.cu",
                       "deepspeed_tpu/ops/quant_matmul.py:250",
                       "quant_matmul_a8_kernel"),
    "int4_matmul": ("deepspeed_tpu_torch/csrc/quant_matmul.cu",
                    "deepspeed_tpu/ops/quant_matmul.py:394",
                    quant_matmul.weight_only_kernel(torch.bfloat16)),
    "block_sparse_attention_fwd": (
        "deepspeed_tpu_torch/csrc/block_sparse_attention.cu",
        "deepspeed_tpu/ops/block_sparse_attention.py:196",
        "sparse_fwd_tma_kernel"),
    "block_sparse_attention_bwd": (
        "deepspeed_tpu_torch/csrc/block_sparse_attention.cu",
        "deepspeed_tpu/ops/block_sparse_attention.py:325,360",
        "sparse_bwd_kernel"),
    "fused_lamb": ("deepspeed_tpu_torch/csrc/fused_lamb.cu",
                   "deepspeed_tpu/ops/fused_lamb.py:82", "lamb_phase1_kernel"),
    "quantize_symmetric": ("deepspeed_tpu_torch/csrc/quantization.cu",
                           "deepspeed_tpu/ops/quantization.py:44",
                           "quant_sym_kernel"),
    "fused_group_norm": ("deepspeed_tpu_torch/csrc/group_norm.cu",
                         "deepspeed_tpu/ops/spatial.py:101",
                         "gn_resident_kernel"),
}
# the quantized inference modes and the decode GEMM each one runs
QUANT_MODES = {"int8": "int8_matmul", "w8a8": "int8_a8_matmul",
               "int4": "int4_matmul", "w4a8": "int4_a8_matmul"}
# llama-7b's widths (H, layers, heads, D, FFN, vocab) and its decode weight
# sites (K, N)
LLAMA_7B = (4096, 32, 32, 128, 11008, 32000)
QUANT_SITES = {"qkvo": (4096, 4096), "gate_up": (4096, 11008),
               "down": (11008, 4096), "lm_head": (4096, 32000)}
INT_MM_ROWS = 17    # torch._int_mm takes more than 16 rows
L2_BYTES = 50e6     # the H100's L2: rotated timings cycle through more
# the norm's cases (rows, H, rms): llama-7b's decode step (8 rows) and serve
# prefill chunk (256), 256 rows of LayerNorm with bias, generate's static
# prefill (8 prompts padded to 512: 4096 rows), OPT-1.3B's training rows
# (4 x 1024, H 2048, LayerNorm with bias), llama-7b's training rows under
# offload (1 x 2048, RMSNorm), moe-gpt-350m-8e's training rows (4 x 1024,
# H 1024, LayerNorm with bias)
NORM_CASES = [(8, 4096, True), (256, 4096, True), (256, 4096, False),
              (4096, 4096, True), (4096, 2048, False), (2048, 4096, True),
              (4096, 1024, False)]
SERVE_KERNELS = ("fused_layer_norm", "paged_decode_attention",
                 "paged_prefill_attention")
GENERATE_KERNELS = ("fused_layer_norm", "flash_attention", "decode_attention")
# the train path's kernels and their exact launches per step of OPT-1.3B
# (24 layers: one flash forward and one flash backward call each; two norms
# each plus the final norm; one Adam launch for the whole model)
TRAIN_KERNELS = {"flash_attention": 24, "flash_attention_bwd": 24,
                 "fused_layer_norm": 49, "fused_adam": 1}
# the sparse_train path's kernels and their exact launches per step: the
# sparse forward and backward once per layer, no flash kernel, the norms as
# above, and one LAMB phase-1 launch for the whole model (its phase 2 is
# torch, one in-place op per leaf), no Adam
SPARSE_TRAIN_KERNELS = {"block_sparse_attention_fwd": 24,
                        "block_sparse_attention_bwd": 24,
                        "flash_attention": 0, "flash_attention_bwd": 0,
                        "fused_layer_norm": 49, "fused_adam": 0,
                        "fused_lamb": 1}
# LAMB against its plain version: the same fp32 arithmetic as Adam's, so m,
# v and the update u are held as Adam's are (ADAM_RTOL of their terms'
# magnitudes), and the step's params within ADAM_P_ROUND * |p| plus
# ADAM_RTOL of the step's terms, lr * ratio * |u|'s (the ratio's norms are
# summed in another order: a few fp32 ulps of it). The per-block partial
# sums of p^2 and u^2 (positive terms: a tree of up to 8192 against a
# sequential sum) within LAMB_SUM_RTOL of themselves.
LAMB_SUM_RTOL = 1e-5
STALE = 1e4        # dense arena slots outside every mask: large and finite
# The Stable Diffusion v1.5 VAE decoder's mid block (diffusers AutoencoderKL
# of runwayml/stable-diffusion-v1-5, vae/: block_out_channels [128, 256,
# 512, 512], norm_num_groups 32, resnet eps 1e-6, one attention head as wide
# as the channels) on the 64 x 64 latent of a 512 x 512 image, batch 4
SPATIAL = dict(B=4, latent=64, C=512, groups=32, eps=1e-6)
SPATIAL_CALLS = 5
# per mid block call: 5 group norms (2 per resnet block, 1 in attention),
# one flash forward (the single head of 512)
SPATIAL_KERNELS = {"fused_group_norm": 5, "flash_attention": 1}
# bf16 kernel path vs the plain path after 4 convs and an attention over
# 4096 keys, each rounding to bf16 in other places: relative to the
# output's largest magnitude
SPATIAL_TOL = 5e-2
# GroupNorm cases: the mid block's shape, then JAX's test shapes
# (tests/kernels/test_spatial.py:18), then the VAE decoder's last up block
# at 512 x 512 (C 128, 67 MB in bf16: more than the card's shared memory
# and its L2, so it takes the streaming route)
GN_SHAPES = [("vae_mid", 4, 4096, 512, 32), ("jax_a", 2, 256, 64, 8),
             ("jax_b", 1, 1024, 96, 12), ("jax_c", 3, 640, 128, 32),
             ("vae_up_512", 1, 262144, 128, 32)]
# the stress input's shapes: the mid block (fp32: the streaming route) and
# half its latent (fp32, 63 rows a block: the resident route)
GN_STRESS_SHAPES = [("stress_300", 4, 4096, 512, 32),
                    ("stress_300_resident", 4, 2048, 512, 32)]
GN_EPS = 1e-6
QUANT_N = 1 << 26  # the quantize cases' second size (64 Mi elements)
# the flash forward and backward at the training shapes (B, S = T, N = K,
# D): OPT-1.3B's (train) and llama-7b's under offload (offload)
TRAIN_FLASH = (4, 1024, 32, 64)
LLAMA_TRAIN_FLASH = (1, 2048, 32, 128)
MOE_TRAIN_FLASH = (4, 1024, 16, 64)


def flash_fwd_kernel_name(dtype, D: int) -> str:
    """The kernel a flash forward call runs (``ops/flash_attention.py``)."""
    return ("flash_fwd_tma_kernel" if dtype != torch.float32 and (
        D in (16, 32, 64, 128) or (256 < D <= 512 and D % 8 == 0))
        else "flash_fwd_kernel")


def flash_bwd_kernel_name(dtype, D: int) -> str:
    """The kernel(s) a flash backward call runs."""
    return ("flash_bwd_kernel (fused)" if dtype != torch.float32
            and D in (16, 32, 64, 128)
            else "flash_bwd_dq_kernel + flash_bwd_dkv_kernel")
# the flash forward at head_dim 512 (non-causal, N 1): (case, dtype, B, S, T)
FLASH_WIDE = [("vae_mid", torch.bfloat16, 4, 4096, 4096),
              ("vae_mid", torch.float32, 2, 1024, 1024),
              ("cross", torch.bfloat16, 2, 1024, 77),
              ("cross", torch.float32, 2, 1024, 77)]
# 300 + 0.01 N(0, 1) in fp32 against float64: an fp32 mean of values near
# 300 may be off by an ulp there (3e-5, 0.3% of the std), which the
# normalisation scales by 1 / std = 100 (~3e-3); a one-pass variance gives
# NaN or errors of order 1
GN_STRESS_TOL = 1e-2


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also gets ``at_s``, the seconds since
    the script started when the phase ended."""
    if "phase" in obj:
        obj = dict(obj, at_s=time.perf_counter() - _START)
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int = 20, reps: int = 10,
            warmup_s: float = 0.05) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed ``reps`` times between two CUDA events, so the host's
    per-call cost (Python, argument checks, the launch itself) is not in
    the number. Replays run for ``warmup_s`` seconds first (an idle card
    runs at low clocks)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):          # allocator and lazy init, uncaptured
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < warmup_s:
        graph.replay()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def bound_ms(nbytes: float, flops: float, peak: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def check(name: str, got: torch.Tensor, ref: torch.Tensor, tol) -> float:
    """Hold ``got`` to ``ref`` within (atol, rtol); returns max abs error."""
    atol, rtol = tol
    diff = (got.float() - ref.float()).abs()
    ok = bool((diff <= atol + rtol * ref.float().abs()).all())
    err = float(diff.max())
    if not ok:                  # also catches NaN
        raise AssertionError(f"{name}: max abs error {err} outside "
                             f"atol {atol} + rtol {rtol} * |plain|")
    return err


# ---------------------------------------------------------------------------
# kernels vs plain versions
# ---------------------------------------------------------------------------


def norm_cases(dev, gen):
    """The norm at NORM_CASES in bf16 and fp32 (H 4096 eps 1e-6 as
    llama-7b's RMSNorm; OPT-1.3B's rows take a bias), each with the launch
    shape it took (``ln_plan``: vectors a thread, threads a row, rows a
    block, blocks) and the kernel of its route. The bf16 cases of 8 and 256
    rows are also timed over scale (and bias) copies larger than the L2
    (``rotated_ms``), as on the decode path, where a forward's weights
    stream through the L2 between two norms; x stays hot, as there."""
    eps = 1e-6
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    results = []
    for rows, H, rms in NORM_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(rows, H, generator=gen, device=dev).to(dtype)
            scale = (1 + 0.1 * torch.randn(H, generator=gen, device=dev)
                     ).to(dtype)
            bias = (None if rms else
                    (0.1 * torch.randn(H, generator=gen, device=dev)
                     ).to(dtype))
            got = fused_layer_norm(x, scale, bias, eps, rms)
            ref = reference_layer_norm(x, scale, bias, eps, rms)
            err = check(f"fused_layer_norm rows={rows} H={H} rms={rms} "
                        f"{dtype}", got, ref, TOL[dtype])
            item = x.element_size()
            plan = ln_plan(rows, H, item, sms)
            nbytes = (2 * rows * H + H * (1 if rms else 2)) * item
            b_ms, b_by = bound_ms(nbytes, 8.0 * rows * H, FP32_FLOPS)
            if rms:
                lib = (lambda: torch.nn.functional.rms_norm(
                    x, (H,), scale, eps)) if hasattr(
                        torch.nn.functional, "rms_norm") else None
            else:
                lib = lambda: torch.nn.functional.layer_norm(  # noqa: E731
                    x, (H,), scale, bias, eps)
            extra = {}
            if dtype == torch.bfloat16 and rows <= 256:
                params = l2_copies(torch.stack(
                    [scale] if rms else [scale, bias]))
                extra["rotated_ms"] = rotated_ms(
                    lambda p: fused_layer_norm(x, p[0], None if rms
                                               else p[1], eps, rms), params)
                extra["l2_copies"] = len(params)
                del params
            results.append(dict(
                rows=rows, H=H, rms=rms, dtype=str(dtype), max_abs_err=err,
                tol=dict(zip(("atol", "rtol"), TOL[dtype])),
                plan=plan._asdict(), kernel=("ln_rows_kernel" if plan.vectors
                                             else "ln_scalar_kernel"),
                ms=time_ms(lambda: fused_layer_norm(x, scale, bias, eps,
                                                    rms)), **extra,
                plain_ms=time_ms(lambda: reference_layer_norm(
                    x, scale, bias, eps, rms)),
                library_ms=time_ms(lib) if lib is not None else None,
                bound_ms=b_ms, bound_by=b_by))
    return results


def arena_pools(dev, gen, nb, bs, k, d, dtype):
    kp = torch.randn(nb, bs, k, d, generator=gen, device=dev).to(dtype)
    vp = torch.randn(nb, bs, k, d, generator=gen, device=dev).to(dtype)
    return kp, vp


def decode_cases(dev, gen):
    """llama-7b's paged decode step (32 heads of 128, block 16):
    ``serve8``, 8 rows of 0..1000 keys over 64-page tables, in bf16 and
    fp32, with NaN in the page after row 3's last one and in that page's
    tail; ``long1``, one row of 4000 keys over a 256-page table, in bf16,
    with NaN in the pages after its last. Each bf16 case is also timed over
    pool copies larger than the L2 (``rotated_ms``, ``l2_copies``: the live
    bytes of serve8, 46.6 MB, fit the 50 MB L2 across repeats) and the
    dense decode kernel over the same keys (``dense_kernel_ms``:
    ``decode_attention`` on the gathered view, gathered before timing).
    Each case records the kernel's split (``paged_split_plan``: splits,
    ring stages)."""
    N, K, D, BS = 32, 32, 128, 16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    serve = [1, 1000, 0, 517, 64, 333, 800, 129]
    results, tables = [], {}
    for case, dtype, lens, MAXB in (
            ("serve8", torch.bfloat16, serve, 64),
            ("serve8", torch.float32, serve, 64),
            ("long1", torch.bfloat16, [4000], 256)):
        R = len(lens)
        NB = R * MAXB + 1
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        if case not in tables:     # one table a case, every entry a page
            perm = torch.randperm(NB - 1, generator=gen, device=dev) + 1
            tables[case] = perm.view(R, MAXB).int().contiguous()
        table = tables[case]
        kp, vp = arena_pools(dev, gen, NB, BS, K, D, dtype)
        # non-finite residue outside every live range: the page after a
        # row's last resident page, and the tail of that last page
        row = 3 if case == "serve8" else 0
        last = (lens[row] - 1) // BS
        for p in (kp, vp):
            p[table[row, last + 1:]] = float("nan")
            p[table[row, last], lens[row] % BS or BS:] = float("nan")
        q = torch.randn(R, N, D, generator=gen, device=dev).to(dtype)
        got = paged_decode_attention(q, kp, vp, table, lengths)
        ref = reference_paged_attention(q[:, None], kp, vp, table,
                                        (lengths.long() - 1)[:, None])[:, 0]
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"paged_decode_attention {case}: "
                                 "non-finite output")
        if bool((got[lengths == 0] != 0).any()):
            raise AssertionError("paged_decode_attention: length-0 row "
                                 "is not zero")
        err = check(f"paged_decode_attention {case} {dtype}", got, ref,
                    TOL[dtype])
        item = q.element_size()
        tokens = int(lengths.sum())
        pages = int(((lengths + BS - 1) // BS).sum())
        nbytes = (2 * tokens * K * D + 2 * R * N * D) * item \
            + 4 * (pages + R)
        b_ms, b_by = bound_ms(nbytes, 4.0 * tokens * N * D,
                              BF16_FLOPS if dtype != torch.float32
                              else FP32_FLOPS)
        extra = {}
        if dtype == torch.bfloat16:
            pairs = l2_copies(torch.stack([kp, vp]))
            extra["rotated_ms"] = rotated_ms(
                lambda kv: paged_decode_attention(q, kv[0], kv[1], table,
                                                  lengths), pairs)
            extra["l2_copies"] = len(pairs)
            del pairs
            T = MAXB * BS
            kk = kp[table.long()].reshape(R, T, K, D)
            vv = vp[table.long()].reshape(R, T, K, D)
            valid = (torch.arange(T, device=dev)[None]
                     < lengths[:, None]).int()
            extra["dense_kernel_ms"] = time_ms(
                lambda: decode_attention(q, kk, vv, valid,
                                         kv_len=max(lens)))
            del kk, vv
        results.append(dict(
            case=case, R=R, N=N, K=K, D=D, BS=BS, MAXB=MAXB, lengths=lens,
            dtype=str(dtype), max_abs_err=err,
            tol=dict(zip(("atol", "rtol"), TOL[dtype])),
            split=paged_split_plan(R, K, D, item, BS, MAXB, sms),
            ms=time_ms(lambda: paged_decode_attention(q, kp, vp, table,
                                                      lengths)), **extra,
            plain_ms=time_ms(lambda: reference_paged_attention(
                q[:, None], kp, vp, table, (lengths.long() - 1)[:, None])),
            library_ms=None, bound_ms=b_ms, bound_by=b_by))
    return results


def prefill_cases(dev, gen):
    """llama-7b's serve chunk (B 1, C 256, 32 heads of 128, block 16, a
    64-page table): the whole chunk at start 0, 256 and 512 in bf16 and
    fp32; ``tail``, the partial last chunk of serve's 700-token prompt
    (start 512, 188 valid queries) in bf16; ``gqa``, 8 KV heads (G 4) at
    start 256 in bf16. NaN fills the pages past the chunk's last written
    key, the tail of its last written page, and a page in no table. Each
    case records the kernel's plan (``paged_prefill_plan``: rows of a work
    tile, rows of a page's box); ``library_ms`` is one
    ``scaled_dot_product_attention`` call with a boolean mask over K / V
    gathered from the pages into contiguous tensors beforehand (the gather
    is not timed), and ``flash_ms`` the port's flash forward over that
    copy where its 0-based causal rows are the chunk's positions (start
    0; null elsewhere)."""
    B, C, N, D, BS, MAXB = 1, 256, 32, 128, 16, 64
    NB = MAXB + 2
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    table = (torch.randperm(NB - 2, generator=gen, device=dev) + 1
             ).view(1, MAXB).int().contiguous()
    specs = [("chunk", dtype, start, C, 32)
             for dtype in (torch.bfloat16, torch.float32)
             for start in (0, 256, 512)]
    specs += [("tail", torch.bfloat16, 512, 188, 32),
              ("gqa", torch.bfloat16, 256, C, 8)]
    results = []
    for case, dtype, start, valid, K in specs:
        kp, vp = arena_pools(dev, gen, NB, BS, K, D, dtype)
        end = start + valid                 # written positions < end
        for p in (kp, vp):
            for page in range(-(-end // BS), MAXB):
                p[table[0, page]] = float("nan")
            if end % BS:
                p[table[0, end // BS], end % BS:] = float("nan")
            p[NB - 1] = float("nan")        # a page in no table
        q = torch.randn(B, C, N, D, generator=gen, device=dev).to(dtype)
        st = torch.tensor([start], dtype=torch.int32, device=dev)
        nv = torch.tensor([valid], dtype=torch.int32, device=dev)
        got = paged_prefill_attention(q, kp, vp, table, st, n_valid=nv)
        offs = torch.arange(C, device=dev)
        pos = torch.where(offs < valid, start + offs,
                          torch.full_like(offs, -1))[None]
        ref = reference_paged_attention(q, kp, vp, table, pos)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"paged_prefill_attention {case}: "
                                 "non-finite output")
        if bool((got[:, valid:] != 0).any()):
            raise AssertionError(f"paged_prefill_attention {case}: a pad "
                                 "query's output is not zero")
        err = check(f"paged_prefill_attention {case} start={start} {dtype}",
                    got, ref, TOL[dtype])
        item = q.element_size()
        pairs = sum(start + c + 1 for c in range(valid))
        nbytes = (2 * end * K * D + 2 * B * C * N * D) * item \
            + 4 * (-(-end // BS) + 2)
        b_ms, b_by = bound_ms(nbytes, 4.0 * pairs * N * D,
                              BF16_FLOPS if dtype != torch.float32
                              else FP32_FLOPS)
        # the library's yardstick over the keys gathered beforehand
        kk = kp[table[0, :-(-end // BS)].long()].reshape(
            1, -1, K, D)[:, :end].contiguous()
        vv = vp[table[0, :-(-end // BS)].long()].reshape(
            1, -1, K, D)[:, :end].contiguous()
        keep = (torch.arange(end, device=dev)[None] <= pos[0][:, None]
                )[None, None]
        flash_ms = (time_ms(lambda: flash_attention(q, kk, vv, None,
                                                    causal=True))
                    if start == 0 and valid == C else None)
        results.append(dict(
            case=case, B=B, C=C, start=start, n_valid=valid, N=N, K=K, D=D,
            BS=BS, dtype=str(dtype), max_abs_err=err,
            tol=dict(zip(("atol", "rtol"), TOL[dtype])),
            plan=(paged_prefill_plan(B, C, N, BS, sms)
                  if dtype != torch.float32 else None),
            ms=time_ms(lambda: paged_prefill_attention(
                q, kp, vp, table, st, n_valid=nv)),
            plain_ms=time_ms(lambda: reference_paged_attention(
                q, kp, vp, table, pos)),
            library_ms=time_ms(sdpa_call(q, kk, vv, keep)),
            flash_ms=flash_ms, bound_ms=b_ms, bound_by=b_by))
        del kk, vv
    return results


def dense_operands(dev, gen, B, S, T, N, K, D, lens, dtype):
    """q (B, S, N, D) and a (B, T, K, D) arena whose columns outside the
    (B, T) key mask (right padding at ``lens``, plus holes) hold STALE."""
    col = torch.arange(T, device=dev)
    mask = (col[None] < torch.tensor(lens, device=dev)[:, None]).int()
    mask[:, 1::7] = 0
    mask[:, 0] = 1
    q = torch.randn(B, S, N, D, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, T, K, D, generator=gen, device=dev)
    v = torch.randn(B, T, K, D, generator=gen, device=dev)
    dead = (mask == 0)[:, :, None, None]
    k = torch.where(dead, torch.full_like(k, STALE), k).to(dtype)
    v = torch.where(dead, torch.full_like(v, -STALE), v).to(dtype)
    return q, k, v, mask


def sdpa_call(q, k, v, keep):
    """The library yardstick: one scaled_dot_product_attention call with an
    explicit boolean mask (B, 1, S, T) over KV heads expanded to N."""
    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=keep)


def flash_cases(dev, gen):
    """The static prefill of llama-7b's generate: 8 rows of 64..500 prompt
    tokens bucketed to S 512 over a 1024-column arena, 32 heads of 128, in
    bf16 and fp32; then alibi, GQA (K 8) and the cache-less S = T = 512;
    then OPT-1.3B's and llama-7b's training shapes (``flash_train_case``).
    """
    lens = [500, 64, 287, 133, 411, 350, 96, 222]
    specs = [("prefill", torch.bfloat16, 512, 1024, 32, False),
             ("prefill", torch.float32, 512, 1024, 32, False),
             ("prefill_alibi", torch.bfloat16, 512, 1024, 32, True),
             ("prefill_gqa", torch.bfloat16, 512, 1024, 8, False),
             ("cacheless", torch.bfloat16, 512, 512, 32, False)]
    results = []
    for case, dtype, S, T, K, use_alibi in specs:
        B, N, D = 8, 32, 128
        q, k, v, mask = dense_operands(dev, gen, B, S, T, N, K, D, lens,
                                       dtype)
        al = alibi_slopes(N, device=dev) if use_alibi else None
        got = flash_attention(q, k, v, mask, causal=True, alibi=al)
        ref = reference_flash_attention(q, k, v, mask, causal=True, alibi=al)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"flash_attention {case}: non-finite output")
        err = check(f"flash_attention {case} {dtype}", got, ref, TOL[dtype])
        # the work these inputs need: causal pairs of visible keys, and the
        # K / V rows some query sees
        seen = mask[:, :min(S, T)].long()
        vis = torch.cumsum(seen, dim=1)                      # keys <= i
        rows = torch.arange(S, device=dev).clamp(max=min(S, T) - 1)
        pairs = int(vis[:, rows].sum()) * N
        item = q.element_size()
        nbytes = (2 * B * S * N * D + 2 * int(seen.sum()) * K * D) * item \
            + 4 * seen.numel()
        b_ms, b_by = bound_ms(nbytes, 4.0 * pairs * D,
                              BF16_FLOPS if dtype != torch.float32
                              else FP32_FLOPS)
        keep = ((torch.arange(T, device=dev)[None, :]
                 <= torch.arange(S, device=dev)[:, None])[None]
                & (mask != 0)[:, None, :])[:, None]
        results.append(dict(
            case=case, B=B, S=S, T=T, N=N, K=K, D=D, lens=lens,
            alibi=use_alibi, dtype=str(dtype), max_abs_err=err,
            tol=dict(zip(("atol", "rtol"), TOL[dtype])),
            ms=time_ms(lambda: flash_attention(q, k, v, mask, causal=True,
                                               alibi=al)),
            plain_ms=time_ms(lambda: reference_flash_attention(
                q, k, v, mask, causal=True, alibi=al), iters=4, reps=5),
            library_ms=(time_ms(sdpa_call(q, k, v, keep))
                        if al is None else None),
            bound_ms=b_ms, bound_by=b_by))
    results.append(flash_train_case(dev, gen, "train", TRAIN_FLASH))
    results.append(flash_train_case(dev, gen, "llama_train",
                                    LLAMA_TRAIN_FLASH))
    results.append(flash_train_case(dev, gen, "moe_train", MOE_TRAIN_FLASH))
    return results


def flash_train_case(dev, gen, case, shape):
    """The forward at a training shape (B, S = T, N = K, D), bf16, causal,
    no mask: OPT-1.3B's (B 4, S 1024, 32 heads of 64), as ``train`` runs it
    24 times a step, llama-7b's (B 1, S 2048, 32 heads of 128), as
    ``offload`` runs it 32 times, or moe-gpt-350m-8e's (B 4, S 1024, 16
    heads of 64), as ``moe_train`` runs it 24 times. o and the lse that
    the backward reads are both held to the plain version. Bound: 4 D
    operations per visible pair and q, k, v and o once. Yardstick: SDPA
    with ``is_causal``, its backend named."""
    dtype, (B, S, N, D) = torch.bfloat16, shape
    q, k, v = (torch.randn(B, S, N, D, generator=gen, device=dev).to(dtype)
               for _ in range(3))
    got, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    ref, ref_lse = reference_flash_attention(q, k, v, causal=True,
                                             return_lse=True)
    if not bool(torch.isfinite(got).all() and torch.isfinite(lse).all()):
        raise AssertionError(f"flash_attention {case}: non-finite output")
    err = check(f"flash_attention {case} {dtype}", got, ref, TOL[dtype])
    lse_err = check(f"flash_attention {case} {dtype} lse", lse, ref_lse,
                    TOL[dtype])
    pairs = B * N * S * (S + 1) // 2
    b_ms, b_by = bound_ms(4 * B * S * N * D * q.element_size(),
                          4.0 * pairs * D, BF16_FLOPS)
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    del ref, ref_lse
    return dict(
        case=case, B=B, S=S, T=S, N=N, K=N, D=D, lens=None, alibi=False,
        causal=True, dtype=str(dtype), max_abs_err=err,
        kernel=flash_fwd_kernel_name(dtype, D),
        lse_max_abs_err=lse_err,
        tol=dict(zip(("atol", "rtol"), TOL[dtype])),
        ms=time_ms(lambda: flash_attention(q, k, v, causal=True)),
        plain_ms=time_ms(lambda: reference_flash_attention(
            q, k, v, causal=True), iters=4, reps=5),
        library_ms=time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)),
        library="SDPA, is_causal, backend " + sdpa_backend(qt, kt, vt,
                                                          causal=True),
        bound_ms=b_ms, bound_by=b_by)


def decode_dense_cases(dev, gen):
    """llama-7b's decode step over the dense arena: B 8, 32 heads of 128,
    T 1024, ragged validity with holes, bf16 and fp32; then alibi with
    per-row key positions; then one long row at the same heads (B 1, T
    4096, kv_len 4000). The bf16 cases without alibi are also timed over
    K / V arena copies larger than the L2 (``ms_rotated``, and SDPA's
    ``library_ms_rotated``). Each case records the kernel's split
    (``decode_split_plan``: splits, chunk columns, ring stages)."""
    short = [1000, 77, 512, 300, 64, 800, 640, 129]
    results = []
    for case, dtype, use_alibi, B, T, lens in (
            ("decode", torch.bfloat16, False, 8, 1024, short),
            ("decode", torch.float32, False, 8, 1024, short),
            ("decode_alibi", torch.bfloat16, True, 8, 1024, short),
            ("decode_long", torch.bfloat16, False, 1, 4096, [4000])):
        N, K, D = 32, 32, 128
        q, k, v, valid = dense_operands(dev, gen, B, 1, T, N, K, D, lens,
                                        dtype)
        q = q[:, 0].contiguous()
        kv_len = max(lens)
        al = alibi_slopes(N, device=dev) if use_alibi else None
        kpos = None
        if use_alibi:
            col = torch.arange(T, dtype=torch.float32, device=dev)[None]
            kpos = (col - torch.tensor([17.0 * b for b in range(B)],
                                       device=dev)[:, None]).contiguous()
        args = (q, k, v, valid)
        kw = dict(alibi=al, key_positions=kpos, kv_len=kv_len)
        got = decode_attention(*args, **kw)
        ref = reference_decode_attention(*args, **kw)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"decode_attention {case}: non-finite "
                                 "output")
        err = check(f"decode_attention {case} {dtype}", got, ref, TOL[dtype])
        live = int(valid[:, :kv_len].sum())
        item = q.element_size()
        nbytes = (2 * live * K * D + 2 * B * N * D) * item \
            + 4 * B * kv_len * (2 if kpos is not None else 1)
        b_ms, b_by = bound_ms(nbytes, 4.0 * live * N * D,
                              BF16_FLOPS if dtype != torch.float32
                              else FP32_FLOPS)
        keep = (valid != 0) & (torch.arange(T, device=dev) < kv_len)[None]
        sdpa = sdpa_call(q[:, None], k, v, keep[:, None, None]) \
            if al is None else None
        rot = {}
        if dtype == torch.bfloat16 and al is None:
            pairs = l2_copies(torch.stack([k, v]))
            rot = dict(
                ms_rotated=rotated_ms(
                    lambda kv: decode_attention(q, kv[0], kv[1], valid, **kw),
                    pairs),
                library_ms_rotated=rotated_ms(
                    lambda call: call(),
                    [sdpa_call(q[:, None], kv[0], kv[1], keep[:, None, None])
                     for kv in pairs]),
                l2_copies=len(pairs))
            del pairs
        results.append(dict(
            case=case, B=B, T=T, N=N, K=K, D=D, lens=lens, kv_len=kv_len,
            live_keys=live, alibi=use_alibi, dtype=str(dtype),
            split=decode_split_plan(B, K, D, item, kv_len,
                                    torch.cuda.get_device_properties(
                                        dev).multi_processor_count),
            max_abs_err=err, tol=dict(zip(("atol", "rtol"), TOL[dtype])),
            ms=time_ms(lambda: decode_attention(*args, **kw)), **rot,
            plain_ms=time_ms(lambda: reference_decode_attention(*args, **kw)),
            library_ms=time_ms(sdpa) if sdpa is not None else None,
            bound_ms=b_ms, bound_by=b_by))
    return results


def time_eager_ms(fn, iters: int = 10) -> float:
    """Device time per call of ``fn`` between two CUDA events, without a
    CUDA graph (for library calls that cannot be captured: autograd, an
    optimizer step); their host cost is small beside their device time."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_bwd(name: str, got, ref, mag, dtype) -> float:
    """Hold a flash-backward output to its plain version within TOL plus
    the 16-bit rounding bound; returns the max abs error."""
    atol, rtol = TOL[dtype]
    diff = (got.float() - ref.float()).abs()
    bound = atol + rtol * ref.float().abs() + BWD_ROUND[dtype] * mag
    if not bool((diff <= bound).all()):       # also catches NaN
        raise AssertionError(f"{name}: max abs error {float(diff.max())} "
                             f"outside atol {atol} + rtol {rtol} * |plain| "
                             f"+ {BWD_ROUND[dtype]} * magnitude")
    return float(diff.max())


def flash_bwd_cases(dev, gen):
    """The flash backward (``flash_attention_bwd``: delta, dq, dk and dv in
    one call) at OPT-1.3B's training shape (B 4, S = T 1024, 32 heads of 64,
    causal, no mask) in bf16 and fp32; then GQA (K 8) and alibi with
    right-padded masks with holes, whose masked keys hold STALE; then
    llama-7b's training shape under offload (bf16, B 1, S = T 2048, 32
    heads of 128, causal, no mask: the fused pass at D 128) and
    moe-gpt-350m-8e's (bf16, B 4, S = T 1024, 16 heads of 64). Inputs o /
    lse are the plain forward's; the yardstick is autograd of
    ``scaled_dot_product_attention`` (the backward alone, all three
    gradients) with the same causality and mask. The bound: 10 D operations
    per visible pair (S, dP, dV, dK, dQ) and the bytes of q, k, v, o, dO,
    lse (and the mask) read once and dq, dk, dv written once; the fp32 dq
    accumulator is scratch and is not counted."""
    LB, LS, LN, LD = LLAMA_TRAIN_FLASH
    MB, MS, MN, MD = MOE_TRAIN_FLASH
    specs = [("train", torch.bfloat16, 4, 1024, 32, 32, 64, False, False),
             ("train", torch.float32, 4, 1024, 32, 32, 64, False, False),
             ("gqa_mask", torch.bfloat16, 4, 512, 32, 8, 64, True, False),
             ("alibi_mask", torch.bfloat16, 2, 512, 32, 32, 64, True, True),
             ("llama_train", torch.bfloat16, LB, LS, LN, LN, LD, False,
              False),
             ("moe_train", torch.bfloat16, MB, MS, MN, MN, MD, False,
              False)]
    out = []
    for case, dtype, B, S, N, K, D, masked, use_alibi in specs:
        T = S
        if masked:
            lens = [S - 97 * b for b in range(B)]
            q, k, v, mask = dense_operands(dev, gen, B, S, T, N, K, D, lens,
                                           dtype)
        else:
            q, k, v = (torch.randn(B, S, n, D, generator=gen, device=dev
                                   ).to(dtype) for n in (N, K, K))
            mask = None
        do = torch.randn(B, S, N, D, generator=gen, device=dev).to(dtype)
        al = alibi_slopes(N, device=dev) if use_alibi else None
        o, lse = reference_flash_attention(q, k, v, mask, True, None, al,
                                           return_lse=True)
        # contiguous, as the forward kernel writes it (the plain forward
        # returns a permuted view, which the wrapper would copy)
        o = o.contiguous()
        args = (q, k, v, o, lse, do, mask, True, None, al)
        got = flash_attention_bwd(*args)
        refs = reference_flash_attention_bwd(*args)
        mags = flash_attention_bwd_magnitude(*args)
        errs = [check_bwd(f"flash_attention_bwd {case} {dtype} {part}",
                          g, r, m, dtype)
                for part, g, r, m in zip(("dq", "dk", "dv"), got, refs, mags)]
        if mask is not None:
            dead = mask == 0
            if bool((got[1][dead] != 0).any() | (got[2][dead] != 0).any()):
                raise AssertionError(f"flash_attention_bwd {case}: a masked "
                                     "key got a gradient")
        del refs, mags, got
        # the work these inputs need: the causal pairs of visible keys
        seen = (mask if mask is not None
                else torch.ones(B, T, dtype=torch.int32, device=dev)).long()
        pairs = int(torch.cumsum(seen, dim=1).sum()) * N
        item = q.element_size()
        nbytes = (4 * B * S * N * D + 4 * B * T * K * D) * item \
            + 4 * B * N * S + (4 * B * T if mask is not None else 0)
        peak = BF16_FLOPS if dtype != torch.float32 else FP32_FLOPS
        b_ms, b_by = bound_ms(nbytes, 10.0 * pairs * D, peak)
        plain = time_ms(lambda: reference_flash_attention_bwd(*args),
                        iters=2, reps=3)
        library = None
        if al is None:
            G = N // K
            lq, lk, lv = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k.repeat_interleave(G, dim=2),
                                    v.repeat_interleave(G, dim=2)))
            if mask is None:
                lo = torch.nn.functional.scaled_dot_product_attention(
                    lq, lk, lv, is_causal=True)
            else:
                keep = ((torch.arange(T, device=dev)[None, :]
                         <= torch.arange(S, device=dev)[:, None])[None]
                        & (mask != 0)[:, None, :])[:, None]
                lo = torch.nn.functional.scaled_dot_product_attention(
                    lq, lk, lv, attn_mask=keep)
            ldo = do.transpose(1, 2)
            library = time_eager_ms(lambda: torch.autograd.grad(
                lo, (lq, lk, lv), ldo, retain_graph=True))
            del lo
        out.append(dict(
            case=case, B=B, S=S, T=T, N=N, K=K, D=D, causal=True,
            masked=masked, alibi=use_alibi, dtype=str(dtype),
            kernel=flash_bwd_kernel_name(dtype, D),
            tol=dict(zip(("atol", "rtol"), TOL[dtype]),
                     round=BWD_ROUND[dtype]),
            max_abs_err=max(errs), visible_pairs=pairs,
            ms=time_ms(lambda: flash_attention_bwd(*args)),
            plain_ms=plain, library_ms=library, bound_ms=b_ms,
            bound_by=b_by))
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return out


def update_magnitudes(old, g, scale, v_new, step: int, kw):
    """The sums of the terms' magnitudes of Adam's and LAMB's new m, v and
    update u = m^ / (sqrt(v^) + eps) + wd * p (before lr and LAMB's trust
    ratio), from the buffers ``old`` = (p, m, v), the gradient times
    ``scale`` and the plain version's new v."""
    p0, m0, v0 = old
    b1, b2 = kw["beta1"], kw["beta2"]
    gs = g.float() * scale
    m_mag = b1 * m0.abs() + (1 - b1) * gs.abs()
    v_mag = b2 * v0 + (1 - b2) * gs * gs
    u_mag = (m_mag / (1 - b1 ** step)
             / (torch.sqrt(v_new / (1 - b2 ** step)) + kw["eps"])
             + kw["weight_decay"] * p0.abs())
    return m_mag, v_mag, u_mag


def hold(what: str, checks) -> float:
    """Each (name, got, ref, bound) of ``checks`` elementwise: |got - ref|
    <= bound; returns the max abs error."""
    for name, a, b, bound in checks:
        diff = (a - b).abs()
        if not bool((diff <= bound).all()):      # also catches NaN
            worst = int(torch.argmax(diff - bound))
            raise AssertionError(
                f"{what} {name}: error {float(diff[worst])} above its "
                f"bound {float(bound[worst])} at element {worst}")
    return max(max_err(a, b) for _, a, b, _ in checks)


def check_adam(case: str, old, got, ref, g, scale, kw) -> float:
    """Hold the kernel's m, v and update (``got``) to the plain version's
    (``ref``), both from the buffers ``old`` = (p, m, v), each within
    ADAM_RTOL of its terms' magnitudes (see ADAM_RTOL); returns the max abs
    error over p, m and v."""
    m_mag, v_mag, u_mag = update_magnitudes(old, g, scale, ref[2],
                                            kw["step"], kw)
    # both params start at p0: got_p - ref_p is the difference of the updates
    return hold(f"fused_adam {case}", (
        ("m", got[1], ref[1], ADAM_RTOL * m_mag),
        ("v", got[2], ref[2], ADAM_RTOL * v_mag),
        ("update", got[0], ref[0],
         ADAM_P_ROUND * ref[0].abs() + ADAM_RTOL * kw["lr"] * u_mag)))


def offload_numels(preset: str = "llama-7b"):
    """Elements of one layer of ``preset`` (a block of parameter offload at
    one layer a block) and of its resident part (embedding, final norm,
    head), from the model's shapes."""
    tree = create_model(preset, num_layers=1).init(torch.Generator(),
                                                   device="meta")
    items = list(tree_items(tree))
    return (sum(t.numel() for p, t in items if p[0] == "layers"),
            sum(t.numel() for p, t in items if p[0] != "layers"))


def adam_cases(dev, gen):
    """Fused Adam on flat buffers: at 64 Mi elements the train path's update
    (fp32 master / moments, bf16 grads, bf16 working copy written, the clip
    coefficient as a device scalar), then fp32 grads without a copy; at
    parameter offload's sizes on llama-7b its two calls: a block (one
    layer) on the deferred path (fp32 accumulated grads, the bf16 copy, the
    clip coefficient) and the resident part on the fused path (bf16 grads,
    the bf16 copy, no scale; the blocks take the same call), and at
    moe-gpt-350m-8e's (moe_param_offload's fused path: a layer's block and
    the resident part, bf16 grads and copy, no scale). AdamW, lr
    1e-4, weight decay 0.01, bias correction at step 10. The second moments
    span 1e-16..1 (log-uniform), so some updates are ~lr-sized and depend
    on eps and the bias corrections, others are dominated by the weight
    decay. The yardstick is ``torch.optim.AdamW(fused=True)``'s step on the
    same sizes (fp32 grads: it takes the param's dtype)."""
    kw = ADAM_KW
    block, resident = offload_numels()
    moe_block, moe_resident = offload_numels(MOE_PRESET)
    results = [adam_case(dev, gen, *c) for c in (
        ("train", 64 * 2 ** 20, torch.bfloat16, True, True),
        ("fp32", 64 * 2 ** 20, torch.float32, False, True),
        ("offload_block", block, torch.float32, True, True),
        ("offload_resident", resident, torch.bfloat16, True, False),
        ("moe_offload_block", moe_block, torch.bfloat16, True, False, True),
        ("moe_offload_resident", moe_resident, torch.bfloat16, True, False,
         True))]
    results.append(adam_model_case(dev, gen, "moe_train",
                                   moe_param_count(), kw))
    return results


# AdamW as the kernel cases run it: bias correction at step 10
ADAM_KW = dict(step=10, lr=1e-4, beta1=0.9, beta2=0.999, eps=1e-8,
               weight_decay=0.01, adam_w_mode=True)


def adam_case(dev, gen, case: str, n: int, gdt, copy: bool, scaled: bool,
              rounding_copy: bool = False):
    """One ``adam_cases`` case: ``n`` elements, ``gdt`` grads, the bf16
    copy written when ``copy``, a clip coefficient when ``scaled``; held
    to the plain version and timed beside it and the library step. With
    ``rounding_copy`` the copy is held to its master's rounding
    (``check_adam_copy``, as ``adam_model_case`` holds it): over tens of
    millions of elements some step cancels most of a param, and there the
    two copies can sit more than ADAM_COPY_TOL apart."""
    kw = ADAM_KW
    p = torch.randn(n, generator=gen, device=dev)
    m = 1e-5 * torch.randn(n, generator=gen, device=dev)
    v = torch.pow(10.0, -16 * torch.rand(n, generator=gen, device=dev))
    g = (1e-5 * torch.randn(n, generator=gen, device=dev)).to(gdt)
    one = torch.ones(1, device=dev)
    scale = torch.tensor([0.37], device=dev) if scaled else None
    bufs = [[x.clone() for x in (p, m, v)] for _ in range(2)]
    copies = ([torch.empty(n, dtype=torch.bfloat16, device=dev)
               for _ in range(2)] if copy else [None, None])
    fused_adam_flat(*bufs[0][:1], g, *bufs[0][1:], param_copy=copies[0],
                    grad_scale=scale, **kw)
    reference_adam_flat(*bufs[1][:1], g, *bufs[1][1:],
                        param_copy=copies[1], grad_scale=scale, **kw)
    err = check_adam(case, (p, m, v), bufs[0], bufs[1], g,
                     one if scale is None else scale, kw)
    outside = None
    if copy and rounding_copy:
        outside = check_adam_copy(case, copies[0], copies[1], bufs[0][0],
                                  bufs[1][0])
    elif copy:
        check(f"fused_adam {case} copy", copies[0], copies[1],
              ADAM_COPY_TOL)
    nbytes = n * (12 + g.element_size() + 12 + (2 if copy else 0))
    b_ms, b_by = bound_ms(nbytes, 16.0 * n, FP32_FLOPS)
    kp, km, kv = bufs[0]
    ms = time_ms(lambda: fused_adam_flat(kp, g, km, kv,
                                         param_copy=copies[0],
                                         grad_scale=scale, **kw),
                 iters=5, reps=4)
    pp, pm, pv = bufs[1]
    plain = time_ms(lambda: reference_adam_flat(
        pp, g, pm, pv, param_copy=copies[1], grad_scale=scale, **kw),
        iters=2, reps=3)
    del bufs, copies
    param = torch.nn.Parameter(p)
    param.grad = g.float()
    opt = torch.optim.AdamW([param], lr=1e-4, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=0.01, fused=True)
    library = time_eager_ms(opt.step)
    del opt, param, p, m, v, g
    torch.cuda.empty_cache()
    return dict(
        case=case, n=n, grad_dtype=str(gdt), param_copy=copy,
        grad_scale=scaled, dtype=str(gdt), max_abs_err=err,
        copy_outside_copy_tol=outside,
        tol=dict(rtol_of_terms=ADAM_RTOL, p_round=ADAM_P_ROUND),
        ms=ms, plain_ms=plain,
        library_ms=library, bound_ms=b_ms, bound_by=b_by)


def check_adam_copy(case: str, got, ref, got_p, ref_p) -> int:
    """Hold the kernel's bf16 working copy to the plain version's: each is
    its fp32 master rounded to nearest, so they differ by at most half a
    bf16 ulp of each master (2^-8 |p|) plus the masters' own difference,
    which ``check_adam`` has held. Where a step cancels most of a param
    (p - lr * u near 0) that difference is large beside |p|, and the copies
    can sit more than ADAM_COPY_TOL apart; returns how many elements do."""
    a, b = got_p.float(), ref_p.float()
    diff = (got.float() - ref.float()).abs()
    bound = 2.0 ** -8 * (a.abs() + b.abs()) + (a - b).abs()
    bad = ~(diff <= bound)
    if bool(bad.any()):
        i = int(torch.nonzero(bad)[0])
        raise AssertionError(
            f"fused_adam {case} copy: {int(bad.sum())} elements outside the "
            f"rounding of their masters; first at {i}: copy {float(got[i])} "
            f"vs {float(ref[i])}, master {float(a[i])} vs {float(b[i])}")
    atol, rtol = ADAM_COPY_TOL
    return int((diff > atol + rtol * ref.float().abs()).sum())


def moe_param_count() -> int:
    """moe-gpt-350m-8e's parameter count, from the model's meta init: the
    flat buffer's elements one fused Adam launch updates at ZeRO stage 0."""
    tree = create_model(MOE_PRESET).init(torch.Generator(), device="meta")
    return sum(t.numel() for t in tree_leaves(tree))


# the plain version's check runs over slices of this many elements
ADAM_CHECK_CHUNK = 1 << 27


def adam_model_case(dev, gen, case: str, n: int, kw):
    """Fused Adam over one flat buffer of a whole model's ``n`` elements, as
    the train path launches it once a step: fp32 master and moments, bf16
    grads, the bf16 working copy, a clip coefficient. The kernel runs once
    over the whole buffer; its result is held to the plain version by
    ``check_adam`` slice by slice (a whole second set of buffers and the
    plain version's temporaries would not fit beside it). The initial
    buffers are then released, and the kernel, the plain version (one call
    over the whole buffer, in place) and ``torch.optim.AdamW(fused=True)``
    are timed over it."""
    p = torch.randn(n, generator=gen, device=dev)
    m = 1e-5 * torch.randn(n, generator=gen, device=dev)
    v = torch.pow(10.0, -16 * torch.rand(n, generator=gen, device=dev))
    g = (1e-5 * torch.randn(n, generator=gen, device=dev)).to(torch.bfloat16)
    scale = torch.tensor([0.37], device=dev)
    kp, km, kv = (x.clone() for x in (p, m, v))
    copy = torch.empty(n, dtype=torch.bfloat16, device=dev)
    fused_adam_flat(kp, g, km, kv, param_copy=copy, grad_scale=scale, **kw)
    err, outside = 0.0, 0
    for lo in range(0, n, ADAM_CHECK_CHUNK):
        sl = slice(lo, min(n, lo + ADAM_CHECK_CHUNK))
        ref = [x[sl].clone() for x in (p, m, v)]
        rcopy = torch.empty_like(copy[sl])
        reference_adam_flat(ref[0], g[sl], ref[1], ref[2], param_copy=rcopy,
                            grad_scale=scale, **kw)
        err = max(err, check_adam(case, (p[sl], m[sl], v[sl]),
                                  (kp[sl], km[sl], kv[sl]), ref, g[sl],
                                  scale, kw))
        outside += check_adam_copy(case, copy[sl], rcopy, kp[sl], ref[0])
        del ref, rcopy
    del p, m, v
    torch.cuda.empty_cache()
    b_ms, b_by = bound_ms(n * (12 + 2 + 12 + 2), 16.0 * n, FP32_FLOPS)
    ms = time_ms(lambda: fused_adam_flat(kp, g, km, kv, param_copy=copy,
                                         grad_scale=scale, **kw),
                 iters=3, reps=3)
    plain = time_eager_ms(lambda: reference_adam_flat(
        kp, g, km, kv, param_copy=copy, grad_scale=scale, **kw), iters=2)
    del km, kv, copy
    torch.cuda.empty_cache()
    param = torch.nn.Parameter(kp)
    param.grad = g.float()
    opt = torch.optim.AdamW([param], lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.01, fused=True)
    library = time_eager_ms(opt.step, iters=2)
    del opt, param, kp, g
    torch.cuda.empty_cache()
    return dict(case=case, n=n, grad_dtype=str(torch.bfloat16),
                param_copy=True, grad_scale=True, dtype=str(torch.bfloat16),
                max_abs_err=err, copy_outside_copy_tol=outside,
                tol=dict(rtol_of_terms=ADAM_RTOL, p_round=ADAM_P_ROUND),
                ms=ms, plain_ms=plain, library_ms=library, bound_ms=b_ms,
                bound_by=b_by)


SPARSE_B, SPARSE_S, SPARSE_N, SPARSE_D = 2, 2048, 32, 64


def sparse_path_configs():
    """The sparse layouts timed at the sparse_train shape: DeepSpeed's
    Fixed layout (the path's), a sliding window of 3 blocks and
    BSLongformer (one global block), all unidirectional at block 16."""
    N = SPARSE_N
    return {
        "fixed": FixedSparsityConfig(num_heads=N, block=16,
                                     num_local_blocks=4, num_global_blocks=1,
                                     attention="unidirectional"),
        "window": LocalSlidingWindowSparsityConfig(
            num_heads=N, block=16, num_sliding_window_blocks=3,
            attention="unidirectional"),
        "longformer": BSLongformerSparsityConfig(num_heads=N, block=16,
                                                 attention="unidirectional"),
    }


def sparse_timing(dtype) -> dict:
    """``time_ms``'s counts for the sparse cases: fp32 calls take ~10 ms at
    the path's shape, so 20 of them make a long enough window."""
    return dict(iters=5, reps=4) if dtype == torch.float32 else {}


def flash_same_shape(q, k, v, do):
    """The port's flash kernels (causal) at the sparse shape: ms of the
    forward and of the whole backward (dq, dk and dv in one call)."""
    o, lse = flash_attention(q, k, v, None, causal=True, return_lse=True)
    kw = sparse_timing(q.dtype)
    return dict(fwd=time_ms(lambda: flash_attention(q, k, v, None,
                                                    causal=True), **kw),
                bwd=time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do),
                            **kw))


def visible_mask(plan, causal: bool, device) -> torch.Tensor:
    """(N, S, S) bool: the (query, key) pairs the plan lets attend, with
    causality when set."""
    keep = plan.token_mask(device)
    if causal:
        keep = keep & torch.ones(keep.shape[-2:], dtype=torch.bool,
                                 device=device).tril()
    return keep


def sparse_case(case, plan, causal, q, k, v, do, flash):
    """The block-sparse forward and backward against their plain versions
    on one plan; returns one result per kernel. The bounds count the
    operations of the visible (query, key) pairs only (``visible_mask``),
    not of every pair of the active 128-tiles the kernels visit: 4 D a pair
    forward, 10 D backward (S, dP, dV, dK, dQ), beside the bytes of q, k, v
    (and o, dout) and lse read once and of the outputs written once; the
    backward's fp32 dq accumulator and stats tiles are scratch and are not
    counted. The yardstick is SDPA with the plan's boolean token mask
    (forward, and autograd of it for the backward, all three gradients).
    ``flash_ms``: the port's flash forward beside the forward, its whole
    backward (one call for dq, dk and dv) beside the backward."""
    B, S, N, D = q.shape
    dtype = q.dtype
    name = f"block_sparse {case} {dtype}"
    o, lse = block_sparse_attention_fwd(q, k, v, plan, causal)
    ro, rlse = reference_block_sparse_attention(q, k, v, plan, causal)
    if not torch.equal(torch.isfinite(lse), torch.isfinite(rlse)):
        raise AssertionError(f"{name}: key-less rows differ")
    live = torch.isfinite(rlse)
    err_fwd = max(check(f"{name} o", o, ro, TOL[dtype]),
                  check(f"{name} lse", lse[live], rlse[live], TOL[dtype]))
    args = (q, k, v, ro, rlse, do, plan, causal)
    got = block_sparse_attention_bwd(*args)
    refs = reference_block_sparse_attention_bwd(*args)
    mags = block_sparse_attention_bwd_magnitude(*args)
    errs = [check_bwd(f"{name} {part}", g, r, m, dtype)
            for part, g, r, m in zip(("dq", "dk", "dv"), got, refs, mags)]
    del refs, mags, got
    keep = visible_mask(plan, causal, q.device)
    visible = int(keep.sum()) * B
    item = q.element_size()
    io = B * S * N * D * item
    lsz = 4 * B * N * S
    peak = BF16_FLOPS if dtype != torch.float32 else FP32_FLOPS
    kw = sparse_timing(dtype)
    b_fwd = bound_ms(4 * io + lsz, 4.0 * visible * D, peak)
    b_bwd = bound_ms(8 * io + lsz, 10.0 * visible * D, peak)
    plain_fwd = time_ms(lambda: reference_block_sparse_attention(
        q, k, v, plan, causal), iters=2, reps=3)
    plain_bwd = time_ms(lambda: reference_block_sparse_attention_bwd(*args),
                        iters=2, reps=3)
    lib_fwd = lib_bwd = None
    if bool(live.all()):            # SDPA gives NaN on a key-less row
        mask = keep[None]
        lq, lk, lv = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        lib_fwd = time_ms(lambda: torch.nn.functional.
                          scaled_dot_product_attention(
                              lq.detach(), lk.detach(), lv.detach(),
                              attn_mask=mask), **kw)
        lo = torch.nn.functional.scaled_dot_product_attention(
            lq, lk, lv, attn_mask=mask)
        ldo = do.transpose(1, 2)
        lib_bwd = time_eager_ms(lambda: torch.autograd.grad(
            lo, (lq, lk, lv), ldo, retain_graph=True))
        del lo
    common = dict(case=case, B=B, S=S, N=N, D=D, causal=causal,
                  dtype=str(dtype), tile_density=plan.density,
                  active_tiles=plan.active_tiles,
                  pair_density=visible / (B * N * S * S),
                  list_width=plan.kidx.shape[2],
                  packed_stages=int(plan.stage_plan()[1].sum()),
                  transposed_width=plan.qidx_t.shape[2],
                  unique_masks=plan.masks.shape[0],
                  tol=dict(zip(("atol", "rtol"), TOL[dtype]),
                           round=BWD_ROUND[dtype]))
    out = {
        "block_sparse_attention_fwd": dict(
            common, max_abs_err=err_fwd,
            ms=time_ms(lambda: block_sparse_attention_fwd(q, k, v, plan,
                                                          causal), **kw),
            plain_ms=plain_fwd, library_ms=lib_fwd,
            flash_ms=flash and flash["fwd"], bound_ms=b_fwd[0],
            bound_by=b_fwd[1]),
        "block_sparse_attention_bwd": dict(
            common, max_abs_err=max(errs),
            ms=time_ms(lambda: block_sparse_attention_bwd(*args), **kw),
            plain_ms=plain_bwd, library_ms=lib_bwd,
            flash_ms=flash and flash["bwd"], bound_ms=b_bwd[0],
            bound_by=b_bwd[1])}
    del ro, rlse, keep
    torch.cuda.empty_cache()
    return out


def sparse_cases(dev, gen):
    """The block-sparse forward and backward: at the sparse_train
    shape (B 2, S 2048, 32 heads of 64) over the Fixed, sliding-window and
    BSLongformer layouts in bf16 and fp32, beside the port's flash kernels
    at the same shape (causal); then B 1 with a key-less q-tile (S 512, 4
    heads, a layout whose second q-tile is empty) and BigBird's per-head
    layouts (S 1024, 8 heads, bidirectional)."""
    out = {name: [] for name in ("block_sparse_attention_fwd",
                                 "block_sparse_attention_bwd")}

    def add(res):
        for name, r in res.items():
            out[name].append(r)

    def operands(B, S, N, D, dtype):
        return [torch.randn(B, S, N, D, generator=gen, device=dev).to(dtype)
                for _ in range(4)]

    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = operands(SPARSE_B, SPARSE_S, SPARSE_N, SPARSE_D, dtype)
        flash = flash_same_shape(q, k, v, do)
        for case, cfg in sparse_path_configs().items():
            add(sparse_case(case, tile_plan_for(cfg, SPARSE_S), True,
                            q, k, v, do, flash))
        del q, k, v, do
        empty = np.zeros((4, 32, 32), np.int64)
        empty[:, :, :] = np.tril(np.ones((32, 32), np.int64))
        empty[:, 8:16, :] = 0                 # q-tile 1 sees no key
        add(sparse_case("empty_q_tile", build_tile_plan(empty, 16, 512),
                        True, *operands(1, 512, 4, 64, dtype), None))
        bigbird = BigBirdSparsityConfig(num_heads=8, block=16,
                                        different_layout_per_head=True)
        add(sparse_case("bigbird_per_head", tile_plan_for(bigbird, 1024),
                        False, *operands(1, 1024, 8, 64, dtype), None))
    return out


def check_lamb(case: str, old, got, ref, g, scale, step: int, lr: float,
               clamp, kw) -> float:
    """Hold one segment's step through the kernel (``got`` = p, m, v) to
    ``reference_lamb_flat``'s (``ref``), both from ``old`` = (p, m, v): m
    and v within ADAM_RTOL of their terms' magnitudes, p within
    ADAM_P_ROUND of itself plus ADAM_RTOL of lr * ratio * |u|'s terms, at
    the plain step's trust ratio; returns the max abs error."""
    m_mag, v_mag, u_mag = update_magnitudes(old, g, scale, ref[2], step, kw)
    b1, b2 = kw["beta1"], kw["beta2"]
    u = ((ref[1] / (1 - b1 ** step))
         / (torch.sqrt(ref[2] / (1 - b2 ** step)) + kw["eps"])
         + kw["weight_decay"] * old[0])
    norms = [float(torch.linalg.vector_norm(x, dtype=torch.float64))
             for x in (old[0], u)]
    del u
    ratio = (min(max(norms[0] / norms[1], clamp[0]), clamp[1])
             if min(norms) > 0 else 1.0)
    return hold(f"fused_lamb {case}", (
        ("m", got[1], ref[1], ADAM_RTOL * m_mag),
        ("v", got[2], ref[2], ADAM_RTOL * v_mag),
        ("p", got[0], ref[0], ADAM_P_ROUND * ref[0].abs()
         + ADAM_RTOL * lr * ratio * u_mag)))


def check_lamb_phase1(case: str, old, got, ref, g, scale, step: int,
                      kw) -> float:
    """Phase 1 alone: the kernel's new m, v, u and partials (``got``)
    against its plain version's (``ref``), both from ``old`` = (p, m, v):
    m, v and u within ADAM_RTOL of their terms' magnitudes, the partials
    within LAMB_SUM_RTOL of themselves; returns the max abs error."""
    m_mag, v_mag, u_mag = update_magnitudes(old, g, scale, ref[1], step, kw)
    return hold(f"fused_lamb {case} phase 1", (
        ("m", got[0], ref[0], ADAM_RTOL * m_mag),
        ("v", got[1], ref[1], ADAM_RTOL * v_mag),
        ("u", got[2], ref[2], ADAM_RTOL * u_mag),
        ("partials", got[3], ref[3], LAMB_SUM_RTOL * ref[3])))


def opt_leaf_sizes(dev):
    """The sizes of OPT-1.3B's leaves, in the optimizer's order."""
    cfg = transformer_config("opt-1.3b", dtype=torch.bfloat16,
                             max_seq_len=SPARSE_S)
    gen = torch.Generator(device=dev)
    sizes = [t.numel() for t in tree_leaves(init_params(gen, cfg))]
    torch.cuda.empty_cache()
    return sizes


def lamb_operands(dev, gen, n: int, gdt):
    """p, m, v and g of ``n`` elements, drawn as adam_cases draws them: the
    second moments log-uniform over 1e-16..1, so some updates are set by
    eps and the bias corrections, others by the weight decay."""
    p = torch.randn(n, generator=gen, device=dev)
    m = 1e-5 * torch.randn(n, generator=gen, device=dev)
    v = torch.rand(n, generator=gen, device=dev).mul_(-16 * np.log(10.0))
    g = (1e-5 * torch.randn(n, generator=gen, device=dev)).to(gdt)
    return p, m, v.exp_(), g


def lamb_case_check(case: str, sizes, clamp, p, m, v, g, u, scale,
                    kw) -> float:
    """One segmented LAMB step (``lamb_step``, in place on p, m, v and u,
    the bf16 copy written) held per segment against ``reference_lamb_flat``
    (``check_lamb``); with one segment also phase 1 alone against its plain
    version (``check_lamb_phase1``; at OPT-1.3B's 1.3 B elements the plain
    version's temporaries and the copies would not fit beside each other).
    Returns the max abs error."""
    seg = LambSegments.from_sizes(sizes)
    old = [x.clone() for x in (p, m, v)]
    copy = torch.empty(seg.n, dtype=torch.bfloat16, device=p.device)
    lamb_step(p, g, m, v, u, seg, 10, 1e-3, max_coeff=clamp[1],
              min_coeff=clamp[0], param_copy=copy, grad_scale=scale, **kw)
    if not torch.equal(copy, p.bfloat16()):
        raise AssertionError(f"fused_lamb {case}: the bf16 copy is not the "
                             "params rounded")
    del copy
    err = 0.0
    for was, gs, got in zip(zip(*(seg.views(x) for x in old)), seg.views(g),
                            zip(*(seg.views(x) for x in (p, m, v)))):
        ref = [x.clone() for x in was]
        reference_lamb_flat(ref[0], gs.float() * scale, ref[1], ref[2], 10,
                            1e-3, max_coeff=clamp[1], min_coeff=clamp[0],
                            **kw)
        err = max(err, check_lamb(case, was, got, ref, gs, scale, 10, 1e-3,
                                  clamp, kw))
        del ref
    del old
    if len(sizes) == 1:
        bufs = [[x.clone() for x in (m, v, u)] for _ in range(2)]
        parts = [lamb_phase1(p, g, *bufs[0], seg, 11, grad_scale=scale,
                             **kw),
                 reference_lamb_phase1(p, g, *bufs[1], seg, 11,
                                       grad_scale=scale, **kw)]
        err = max(err, check_lamb_phase1(case, (p, m, v),
                                         bufs[0] + parts[:1],
                                         bufs[1] + parts[1:], g, scale, 11,
                                         kw))
    return err


# LAMB as the kernel cases run it (JAX fused_lamb_flat's eps)
LAMB_KW = dict(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01)


def lamb_cases(dev, gen):
    """The LAMB phase-1 kernel. "flat": one segment of 64 Mi elements with
    JAX's defaults (clamp [0.01, 10]), bf16 and fp32 grads; "opt-1.3b":
    segmented over OPT-1.3B's leaves (1.3 B elements) with the optimizer's
    open clamp and bf16 grads: the sparse_train step's update. Each with
    the clip coefficient as a device scalar and weight decay 0.01, at step
    10, through ``lamb_case_check``. Also phase 2's time at each size. No
    single PyTorch call computes LAMB, so there is no yardstick; the bound
    is bytes (phase 1 reads p, g, m, v and writes m, v, u)."""
    results = []
    kw = LAMB_KW
    flat = [64 * 2 ** 20]
    for case, sizes, clamp, gdt in (
            ("flat", flat, (0.01, 10.0), torch.bfloat16),
            ("flat", flat, (0.01, 10.0), torch.float32),
            ("opt-1.3b", opt_leaf_sizes(dev), (0.0, float("inf")),
             torch.bfloat16)):
        seg = LambSegments.from_sizes(sizes)
        n = seg.n
        p, m, v, g = lamb_operands(dev, gen, n, gdt)
        u = torch.empty_like(p)
        scale = torch.tensor([0.37], device=dev)
        err = lamb_case_check(f"{case} {gdt}", sizes, clamp, p, m, v, g, u,
                              scale, kw)
        torch.cuda.empty_cache()
        nbytes = n * (12 + g.element_size() + 12) + 8 * seg.nblocks
        b_ms, b_by = bound_ms(nbytes, 16.0 * n, FP32_FLOPS)
        ms = time_ms(lambda: lamb_phase1(p, g, m, v, u, seg, 12,
                                         grad_scale=scale, **kw),
                     iters=5, reps=4)
        plain = time_eager_ms(lambda: reference_lamb_phase1(
            p, g, m, v, u, seg, 12, grad_scale=scale, **kw), iters=2)
        parts = lamb_phase1(p, g, m, v, u, seg, 13, grad_scale=scale, **kw)
        phase2 = time_eager_ms(lambda: lamb_phase2(
            p, u, parts, seg, 1e-3, max_coeff=clamp[1], min_coeff=clamp[0]))
        results.append(dict(
            case=case, n=n, segments=len(sizes), blocks=seg.nblocks,
            grad_dtype=str(g.dtype), dtype=str(g.dtype), max_abs_err=err,
            tol=dict(rtol_of_terms=ADAM_RTOL, p_round=ADAM_P_ROUND,
                     sum_rtol=LAMB_SUM_RTOL),
            ms=ms, plain_ms=plain, phase2_ms=phase2,
            library_ms=None, bound_ms=b_ms, bound_by=b_by))
        del p, m, v, g, u, parts
        torch.cuda.empty_cache()
    results.append(lamb_model_case(dev, gen, "moe-gpt-350m-8e",
                                   moe_leaf_sizes(), kw))
    return results


def moe_leaf_sizes():
    """moe-gpt-350m-8e's leaves' sizes in the optimizer's order (its meta
    init): the segments of moe_optim's LAMB launch at ZeRO stage 0."""
    tree = create_model(MOE_PRESET).init(torch.Generator(), device="meta")
    return [t.numel() for t in tree_leaves(tree)]


# the plain LAMB phase 1 runs over pieces of this many elements (a multiple
# of the kernel's block, so each piece's blocks are the kernel's)
LAMB_CHECK_CHUNK = 1 << 27


def lamb_model_case(dev, gen, case: str, sizes, kw):
    """The LAMB phase-1 kernel over a whole model's leaves in one launch, as
    the train path runs it (bf16 grads, a clip coefficient, step 10): its
    new m, v, u and partial sums held to the plain version's piece by piece
    (LAMB_CHECK_CHUNK elements of a leaf, block-aligned, so each piece's
    partials are the kernel's; ``check_lamb_phase1``), since at 1.76 B
    elements the plain version's temporaries over the whole buffer would
    not fit beside it. ``plain_ms`` is the plain version over those
    pieces, one after another; phase 2's time over the whole."""
    seg = LambSegments.from_sizes(sizes)
    n = seg.n
    p, m, v, g = lamb_operands(dev, gen, n, torch.bfloat16)
    scale = torch.tensor([0.37], device=dev)
    km, kv, u = m.clone(), v.clone(), torch.empty_like(p)
    parts = lamb_phase1(p, g, km, kv, u, seg, 10, grad_scale=scale, **kw)
    pieces, off = [], 0
    for size in sizes:
        pieces += [(lo, min(off + size, lo + LAMB_CHECK_CHUNK))
                   for lo in range(off, off + size, LAMB_CHECK_CHUNK)]
        off += size
    err = 0.0
    for lo, hi in pieces:
        sl = slice(lo, hi)
        rm, rv = m[sl].clone(), v[sl].clone()
        ru = torch.empty_like(rm)
        rparts = reference_lamb_phase1(p[sl], g[sl], rm, rv, ru,
                                       LambSegments.from_sizes([hi - lo]),
                                       10, grad_scale=scale, **kw)
        b0, b1 = np.searchsorted(seg.block_start, [lo, hi])
        err = max(err, check_lamb_phase1(
            case, (p[sl], m[sl], v[sl]), (km[sl], kv[sl], u[sl],
                                          parts[b0:b1]),
            (rm, rv, ru, rparts), g[sl], scale, 10, kw))
        del rm, rv, ru, rparts
    del m, v, parts
    torch.cuda.empty_cache()
    nbytes = n * (12 + g.element_size() + 12) + 8 * seg.nblocks
    b_ms, b_by = bound_ms(nbytes, 16.0 * n, FP32_FLOPS)
    ms = time_ms(lambda: lamb_phase1(p, g, km, kv, u, seg, 12,
                                     grad_scale=scale, **kw),
                 iters=3, reps=3)
    piece_segs = {hi - lo: LambSegments.from_sizes([hi - lo])
                  for lo, hi in pieces}

    def plain():
        for lo, hi in pieces:
            reference_lamb_phase1(p[lo:hi], g[lo:hi], km[lo:hi], kv[lo:hi],
                                  u[lo:hi], piece_segs[hi - lo], 12,
                                  grad_scale=scale, **kw)

    plain_ms = time_eager_ms(plain, iters=1)
    parts = lamb_phase1(p, g, km, kv, u, seg, 13, grad_scale=scale, **kw)
    phase2 = time_eager_ms(lambda: lamb_phase2(
        p, u, parts, seg, 1e-3, max_coeff=float("inf"), min_coeff=0.0),
        iters=2)
    del p, g, km, kv, u, parts
    torch.cuda.empty_cache()
    return dict(case=case, n=n, segments=len(sizes), blocks=seg.nblocks,
                grad_dtype=str(torch.bfloat16), dtype=str(torch.bfloat16),
                max_abs_err=err,
                tol=dict(rtol_of_terms=ADAM_RTOL, sum_rtol=LAMB_SUM_RTOL),
                ms=ms, plain_ms=plain_ms, plain_pieces=len(pieces),
                phase2_ms=phase2, library_ms=None, bound_ms=b_ms,
                bound_by=b_by)


def gn_route(x: torch.Tensor, G: int):
    """The plan ``fused_group_norm`` takes for x on its card, and the CUDA
    kernels of its route."""
    B, HW, C = x.shape
    plan = gn_plan(B, HW, C, G, x.element_size(),
                   torch.cuda.get_device_properties(
                       x.device).multi_processor_count)
    return plan, ("gn_resident_kernel" if plan.route == "resident"
                  else "gn_stats_kernel + gn_apply_kernel")


def group_norm_cases(dev, gen):
    """fused_group_norm at the SD v1.5 VAE mid block's shape (B 4, a 64 x
    64 latent, C 512, 32 groups, eps 1e-6), at JAX's test shapes and at the
    decoder's last up block at 512 x 512 (B 1, C 128), in bf16 and fp32, on
    x = 3 N(0, 1) + 1, each with the plan ``gn_plan`` gave it and the
    kernels of its route; then the stress input 300 + 0.01 N(0, 1) in fp32
    at GN_STRESS_SHAPES (one shape a route), held against a float64
    computation (finite, within GN_STRESS_TOL). Yardstick: ``F.group_norm``
    on the channels-last (B, C, HW, 1) view."""
    results = []
    for case, B, HW, C, G in GN_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x = (3 * torch.randn(B, HW, C, generator=gen, device=dev) + 1
                 ).to(dtype)
            scale = (1 + 0.1 * torch.randn(C, generator=gen, device=dev)
                     ).to(dtype)
            bias = (0.1 * torch.randn(C, generator=gen, device=dev)
                    ).to(dtype)
            got = fused_group_norm(x, scale, bias, G, eps=GN_EPS)
            ref = reference_group_norm(x, scale, bias, G, eps=GN_EPS)
            err = check(f"fused_group_norm {case} {dtype}", got, ref,
                        TOL[dtype])
            del got, ref
            item = x.element_size()
            plan, kernel = gn_route(x, G)
            b_ms, b_by = bound_ms((2 * x.numel() + 2 * C) * item,
                                  8.0 * x.numel(), FP32_FLOPS)
            view = x.permute(0, 2, 1).unsqueeze(-1)       # (B, C, HW, 1)
            results.append(dict(
                case=case, B=B, HW=HW, C=C, G=G, dtype=str(dtype),
                max_abs_err=err, tol=dict(zip(("atol", "rtol"), TOL[dtype])),
                plan=plan._asdict(), route=plan.route, kernel=kernel,
                ms=time_ms(lambda: fused_group_norm(x, scale, bias, G,
                                                    eps=GN_EPS)),
                plain_ms=time_ms(lambda: reference_group_norm(
                    x, scale, bias, G, eps=GN_EPS), iters=4, reps=5),
                library_ms=time_ms(lambda: torch.nn.functional.group_norm(
                    view, G, scale, bias, GN_EPS)),
                library="F.group_norm, channels-last view",
                bound_ms=b_ms, bound_by=b_by))
            del x, view
            torch.cuda.empty_cache()
    for case, B, HW, C, G in GN_STRESS_SHAPES:
        x = 300 + 0.01 * torch.randn(B, HW, C, generator=gen, device=dev)
        got = fused_group_norm(x, torch.ones(C, device=dev),
                               torch.zeros(C, device=dev), G)
        xg = x.double().reshape(B, HW, G, C // G)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
        want = ((xg - mean) / torch.sqrt(var + 1e-5)).reshape(B, HW, C)
        err = max_err(got, want)
        if not (bool(torch.isfinite(got).all()) and err <= GN_STRESS_TOL):
            raise AssertionError(f"fused_group_norm {case}: max abs error "
                                 f"{err} against float64 (limit "
                                 f"{GN_STRESS_TOL})")
        plan, kernel = gn_route(x, G)
        results.append(dict(case=case, B=B, HW=HW, C=C, G=G,
                            dtype="float64 reference", max_abs_err=err,
                            tol=GN_STRESS_TOL, route=plan.route,
                            kernel=kernel))
    return results


def quant_input(dev, gen, n: int, group: int, bits: int, dtype):
    """``n`` N(0, 1) values in ``dtype`` whose first group is zeros and
    whose second group holds exact .5 ties of x / scale (its absmax is
    qmax, so its scale is 1)."""
    x = torch.randn(n, generator=gen, device=dev, dtype=dtype)
    qmax = 2 ** (bits - 1) - 1
    tie = torch.arange(group, device=dev) % (2 * qmax) - qmax + 0.5
    tie[-1] = qmax
    x[:group] = 0
    x[group:2 * group] = tie.to(dtype)
    return x


def quantize_cases(dev, gen):
    """quantize_symmetric against its plain version, bit for bit in q and
    the scales: over OPT-1.3B's 1.316 B bf16 parameters in groups of 128,
    int8 (the main case) and int4; and over 64 Mi elements in bf16 and
    fp32, int8 and int4, groups of 64 and 128; each input with a zero group
    and a group of exact .5 ties. No single PyTorch call computes per-group
    symmetric quantization, so there is no library time."""
    n_opt = sum(opt_leaf_sizes(dev))
    specs = [("opt-1.3b", n_opt, 128, bits, torch.bfloat16) for bits in (8, 4)]
    specs += [("64Mi", QUANT_N, g, bits, dtype) for dtype in
              (torch.bfloat16, torch.float32) for bits in (8, 4)
              for g in (128, 64)]
    results = []
    for case, n, group, bits, dtype in specs:
        x = quant_input(dev, gen, n, group, bits, dtype)
        q, s = quantize_symmetric(x, bits, group)
        qr, sr = reference_quantize_symmetric(x, bits, group)
        if not (torch.equal(q, qr) and torch.equal(s, sr)):
            raise AssertionError(
                f"quantize_symmetric {case} bits={bits} group={group} "
                f"{dtype}: q differs in {int((q != qr).sum())} elements, "
                f"scales in {int((s != sr).sum())} groups")
        del qr, sr
        if s[0] != 1 or s[1] != 1 or q[:group].any():
            raise AssertionError(f"quantize_symmetric {case}: zero / tie "
                                 "group scales")
        big = n > QUANT_N
        b_ms, b_by = bound_ms(n * x.element_size() + n + 4 * (n // group),
                              4.0 * n, FP32_FLOPS)
        results.append(dict(
            case=case, n=n, group=group, bits=bits, dtype=str(dtype),
            max_abs_err=0.0, bit_equal=True,
            ms=time_ms(lambda: quantize_symmetric(x, bits, group),
                       iters=5 if big else 20, reps=4 if big else 10),
            plain_ms=time_eager_ms(lambda: reference_quantize_symmetric(
                x, bits, group), iters=2 if big else 5),
            library_ms=None,
            library="none: no PyTorch call quantizes per group",
            bound_ms=b_ms, bound_by=b_by))
        del x, q, s
        torch.cuda.empty_cache()
    return results


def flash_wide_cases(dev, gen):
    """The flash forward at head_dim 512, non-causal, no mask: the VAE mid
    block's single head over its 64 x 64 latent (B 4, S = T 4096) in bf16,
    the same at B 2, S = T 1024 in fp32 (the CUDA-core path), and cross
    attention of 1024 queries over 77 keys (a text encoder's length) in
    both. Yardstick: one ``scaled_dot_product_attention`` call without a
    mask; the backend it takes is named."""
    results = []
    for case, dtype, B, S, T in FLASH_WIDE:
        N = K = 1
        D = SPATIAL["C"]
        q = torch.randn(B, S, N, D, generator=gen, device=dev).to(dtype)
        k, v = (torch.randn(B, T, K, D, generator=gen, device=dev).to(dtype)
                for _ in range(2))
        got = flash_attention(q, k, v, causal=False)
        ref = reference_flash_attention(q, k, v, causal=False)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"flash_attention {case}: non-finite output")
        err = check(f"flash_attention {case} D={D} {dtype}", got, ref,
                    TOL[dtype])
        item = q.element_size()
        b_ms, b_by = bound_ms((2 * B * S * N * D + 2 * B * T * K * D) * item,
                              4.0 * B * S * T * N * D,
                              BF16_FLOPS if dtype != torch.float32
                              else FP32_FLOPS)
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        slow = dtype == torch.float32
        results.append(dict(
            case=case, B=B, S=S, T=T, N=N, K=K, D=D, causal=False,
            dtype=str(dtype), max_abs_err=err,
            tol=dict(zip(("atol", "rtol"), TOL[dtype])),
            ms=time_ms(lambda: flash_attention(q, k, v, causal=False),
                       iters=4 if slow else 20, reps=3 if slow else 10),
            plain_ms=time_ms(lambda: reference_flash_attention(
                q, k, v, causal=False), iters=2, reps=3),
            library_ms=time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt), iters=4 if slow else 20,
                reps=3 if slow else 10),
            library="SDPA, no mask, backend " + sdpa_backend(qt, kt, vt),
            bound_ms=b_ms, bound_by=b_by))
    return results


def sdpa_backend(q, k, v, causal: bool = False) -> str:
    """The backend ``scaled_dot_product_attention`` picks for these
    operands (no mask, no dropout), by the dispatcher's own choice."""
    try:
        from torch.nn.attention import SDPBackend
        return SDPBackend(torch._fused_sdp_choice(
            q, k, v, is_causal=causal)).name
    except (AttributeError, ImportError, RuntimeError, ValueError):
        return "not reported by this PyTorch"


def rotated_ms(fn, copies) -> float:
    """``time_ms`` of ``fn(c)`` cycling through ``copies`` of an operand
    whose bytes together exceed the L2, so each call reads its operand from
    HBM as a decode step's first touch of a weight does."""
    turn = itertools.cycle(copies)
    return time_ms(lambda: fn(next(turn)), iters=4 * len(copies), reps=5)


def l2_copies(t: torch.Tensor):
    """Copies of ``t`` (itself first) holding more bytes than the L2."""
    n = 2 + int(L2_BYTES // (t.numel() * t.element_size()))
    return [t] + [t.clone() for _ in range(n - 1)]


def int_mm_ms(dev, K: int, w8: torch.Tensor):
    """The a8 yardstick: one ``torch._int_mm`` (s8 x s8 -> s32 on cuBLASLt)
    of INT_MM_ROWS activation rows, its smallest M, by the (K, N) int8
    weight, stored column-major as cuBLASLt's int8 GEMMs take it: (time
    with the weight in L2 reach, time over L2_BYTES of weight copies);
    (None, None) where this PyTorch has no such call for these operands."""
    xq = torch.randint(-127, 128, (INT_MM_ROWS, K), dtype=torch.int8,
                       device=dev)
    w8 = w8.t().contiguous().t()
    try:
        torch._int_mm(xq, w8)
    except (AttributeError, RuntimeError):
        return None, None
    copies = [c.t().contiguous().t() for c in l2_copies(w8)]
    return (time_ms(lambda: torch._int_mm(xq, w8)),
            rotated_ms(lambda w: torch._int_mm(xq, w), copies))


def quant_cases(dev, gen):
    """The four quantized decode GEMMs at llama-7b's decode sites (K, N),
    M 1 and 8 activation rows in bf16 and fp32 (the weight-only ones also
    in fp16), int4 with one group (G 1) and with groups of 128 rows, on
    weights drawn N(0, 0.02) with one all-zero column and quantized as the
    engine does. The a8 kernels must equal their plain versions bit for
    bit (exact integer sums, the same fp32 epilogue; grouped int4 sums its
    group partials in the kernel's order); the others are held to TOL.
    Yardsticks (timed here only): the ``torch.matmul`` of the dense weight
    in x's dtype for the weight-only kernels (bf16, fp16), ``torch._int_mm``
    of INT_MM_ROWS rows by the int8 (for int4: unpacked to int8) weight for
    the a8 ones. At M 8 in bf16 every kernel and its yardstick are also
    timed over weight copies larger than the L2 (``ms_rotated``,
    ``library_ms_rotated``)."""
    out = {name: [] for name in QUANT_MODES.values()}
    for site, (K, N) in QUANT_SITES.items():
        w = 0.02 * torch.randn(K, N, generator=gen, device=dev)
        w[:, 1] = 0.0
        q8 = _quantize_int8(w)
        packs = {G: quant_matmul.quantize_int4(w, None if G == 1 else 128)
                 for G in (1, K // 128)}
        dense = {dt: w.to(dt) for dt in (torch.bfloat16, torch.float16)}
        del w
        lib8 = int_mm_ms(dev, K, q8["q8"])
        lib4 = int_mm_ms(dev, K, quant_matmul._unpack_nibbles(
            packs[1][0]).to(torch.int8))
        for name in QUANT_MODES.values():
            int4, a8 = name.startswith("int4"), "_a8" in name
            fn = getattr(quant_matmul, name)
            ref = getattr(quant_matmul, "reference_" + name)
            dtypes = (torch.bfloat16, torch.float32) + (
                () if a8 else (torch.float16,))
            for G in (packs if int4 else (1,)):
                q, s = packs[G] if int4 else (q8["q8"], q8["s"])
                for M in (1, 8):
                    for dtype in dtypes:
                        x = torch.randn(M, K, generator=gen,
                                        device=dev).to(dtype)
                        got, want = fn(x, q, s), ref(x, q, s)
                        if got.dtype != dtype or got.shape != (M, N):
                            raise AssertionError(f"{name}: output "
                                                 f"{got.dtype} {got.shape}")
                        label = f"{name} {site} M={M} G={G} {dtype}"
                        exact = a8
                        if exact and not torch.equal(got, want):
                            raise AssertionError(
                                f"{label}: {int((got != want).sum())} "
                                "outputs differ from the plain version")
                        err = check(label, got, want, TOL[dtype])
                        item = x.element_size()
                        nbytes = (q.numel() + 4 * s.numel()
                                  + (M * K + M * N) * item)
                        peak = (INT8_OPS if a8 else FP32_FLOPS
                                if dtype == torch.float32 else BF16_FLOPS)
                        b_ms, b_by = bound_ms(nbytes, 2.0 * M * K * N, peak)
                        library, rot = None, {}
                        if a8 and dtype == torch.bfloat16:
                            library = (lib4 if int4 else lib8)[0]
                        elif dtype in dense:
                            library = time_ms(
                                lambda: torch.matmul(x, dense[dtype]))
                        if M == 8 and dtype == torch.bfloat16:
                            rot = dict(
                                ms_rotated=rotated_ms(
                                    lambda qc: fn(x, qc, s), l2_copies(q)),
                                library_ms_rotated=(
                                    (lib4 if int4 else lib8)[1] if a8
                                    else rotated_ms(
                                        lambda d: torch.matmul(x, d),
                                        l2_copies(dense[dtype]))))
                        out[name].append(dict(
                            site=site, M=M, K=K, N=N, G=G, dtype=str(dtype),
                            max_abs_err=err, exact=exact,
                            tol=dict(zip(("atol", "rtol"), TOL[dtype])),
                            ms=time_ms(lambda: fn(x, q, s)), **rot,
                            plain_ms=time_ms(lambda: ref(x, q, s), iters=4,
                                             reps=3),
                            library_ms=library,
                            library=("torch._int_mm, 17 rows" if a8
                                     else f"torch.matmul, dense {dtype}"),
                            bound_ms=b_ms, bound_by=b_by))
        del q8, packs, dense
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# serve llama-7b at full width
# ---------------------------------------------------------------------------


def check_llama_7b(cfg) -> None:
    if (cfg.hidden_size, cfg.num_layers, cfg.num_heads, cfg.head_dim,
            cfg.ffn_hidden_size, cfg.vocab_size) != LLAMA_7B:
        raise AssertionError(f"llama-7b widths changed: {cfg}")


def per_forward(cfg) -> int:
    """Weight-site GEMMs of one forward: q, k, v, o, gate, up and down in
    each layer, and an untied lm_head (225 for llama-7b)."""
    return 7 * cfg.num_layers + (0 if cfg.tie_embeddings else 1)


def make_server(dtype=torch.bfloat16, params=None, preset="llama-7b"):
    """llama-7b (or ``preset``: moe-gpt-350m-8e) at full width in ``dtype``
    (bf16, or a quantized mode) with seeded random weights (or ``params``),
    every sampled logits row checked finite, one short warm-up request
    served. Returns (server, seconds to build it)."""
    scfg = ServingConfig(block_size=16, max_seqs=8, max_model_len=1024,
                         prefill_chunk=256)
    t0 = time.perf_counter()
    srv = init_serving(preset, serving_config=scfg, dtype=dtype,
                       seed=0, params=params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = srv.engine.model.config
    (check_llama_7b if preset == "llama-7b" else check_moe_widths)(cfg)
    prefill, decode = srv._prefill, srv._decode

    def checked_prefill(*args):
        tok, last = prefill(*args)
        if not bool(torch.isfinite(last).all()):
            raise AssertionError("serve: non-finite prefill logits")
        return tok, last

    def checked_decode(params, cache, bt, lengths, *rest):
        nxt, logits = decode(params, cache, bt, lengths, *rest)
        if not bool(torch.isfinite(logits[lengths > 0]).all()):
            raise AssertionError("serve: non-finite decode logits")
        return nxt, logits

    srv._prefill, srv._decode = checked_prefill, checked_decode
    warm = srv.submit(np.arange(48) % cfg.vocab_size, max_new_tokens=2)
    srv.run()
    if len(warm.result()) != 2:
        raise AssertionError("serve: warm-up request failed")
    return srv, init_s


def serve_requests(srv):
    """The 8-request scenario: prompts of 64..700 tokens, 32 greedy new
    tokens each; the eighth request is the first one's 256-token prefix,
    submitted once that prefix is prefilled, so it maps the cached blocks
    and its last prompt token writes into a shared block (copy-on-write).
    Returns (handles, prompts, iterations, wall seconds)."""
    V = srv.engine.model.config.vocab_size
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, V, 256)
    lens = [700, 64, 150, 333, 480, 600, 96]
    prompts = [np.concatenate([prefix, rng.integers(0, V, lens[0] - 256)])]
    prompts += [rng.integers(0, V, n) for n in lens[1:]] + [prefix]
    t0 = time.perf_counter()
    handles = [srv.submit(p, max_new_tokens=32) for p in prompts[:-1]]
    steps = 0
    while handles[0]._req.prefill_pos < 256:
        srv.step()
        steps += 1
    handles.append(srv.submit(prefix, max_new_tokens=32))
    steps += srv.run()
    torch.cuda.synchronize()
    return handles, prompts, steps, time.perf_counter() - t0


def serve_phase(mode=None, params=None):
    """The 8-request scenario, in bf16 or in a quantized ``mode`` (whose
    decode GEMM must then run, in whole decode forwards, and no other
    quantized GEMM); returns (launch counts, the phase's JSON, the server,
    which the generate phase reuses)."""
    phase = "quant_serve" if mode else "serve"
    srv, init_s = make_server(mode or torch.bfloat16, params)
    V = srv.engine.model.config.vocab_size
    reset_launch_counts()
    handles, prompts, steps, wall = serve_requests(srv)
    counts = launch_counts()
    outs = [h.result() for h in handles]
    for i, out in enumerate(outs):
        if len(out) != 32 or not ((out >= 0) & (out < V)).all():
            raise AssertionError(f"{phase}: request {i} returned {out}")
    for name in SERVE_KERNELS + ((QUANT_MODES[mode],) if mode else ()):
        if counts[name] <= 0:
            raise AssertionError(f"{phase}: kernel {name} never launched")
    for name in QUANT_MODES.values():
        want_zero = mode is None or name != QUANT_MODES[mode]
        if (want_zero and counts[name]) or counts[name] % per_forward(
                srv.engine.model.config):
            raise AssertionError(f"{phase}: kernel {name} launched "
                                 f"{counts[name]} times")
    if srv.sched.prefix_hits < 1 or srv._cow_copies < 1:
        raise AssertionError(f"{phase}: prefix cache / copy-on-write did "
                             "not run")
    ttft = [h.ttft_s * 1e3 for h in handles]
    tokens = sum(len(o) for o in outs)
    return counts, dict(
        phase=phase, model="llama-7b", dtype=mode or "bfloat16",
        config=dict(block_size=16, max_seqs=8, max_model_len=1024,
                    prefill_chunk=256),
        prompt_lens=[len(p) for p in prompts], new_tokens=32,
        init_s=init_s, wall_s=wall, iterations=steps,
        prefill_chunks=srv.prefill_chunks_run, tokens=tokens,
        tokens_per_s=tokens / wall, ttft_ms=ttft,
        ttft_ms_median=float(np.median(ttft)),
        prefix_hits=srv.sched.prefix_hits, cow_copies=srv._cow_copies,
        launches=counts,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9), srv


# ---------------------------------------------------------------------------
# end-to-end parity at reduced depth
# ---------------------------------------------------------------------------


def e2e_phase(dev):
    cfg = transformer_config("llama-7b", dtype=torch.float32, num_layers=2,
                             max_seq_len=1024)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    params = init_params(gen, cfg)
    errs, last = paged_parity(params, cfg, dev, gen, "e2e")
    return dict(phase="e2e_parity", model="llama-7b", layers=2,
                dtype="float32", prefill_chunk=256, n_valid=200,
                decode_steps=8, max_abs_err=max(errs), per_step=errs,
                tol=E2E_TOL, logits_absmax=float(last.abs().max()))


def paged_parity(params, cfg, dev, gen, phase: str):
    """One paged prefill chunk of 256 queries (200 valid, then chunk
    padding at position -1) and 8 greedy decode steps beside an inactive
    row, through the kernel path and ``plain=True`` on two copies of an
    arena whose unwritten slots hold NaN; greedy on the plain path. Returns
    (each step's max abs error of the last-position logits, the last
    logits), raising above E2E_TOL."""
    BS, MAXB, C, n_valid = 16, 64, 256, 200
    NB = MAXB + 1
    arena = init_paged_cache(cfg, NB, BS, torch.float32, dev)
    for t in arena.values():
        t[:, 1:] = float("nan")        # unwritten slots hold NaN
    arenas = [arena, {k: v.clone() for k, v in arena.items()}]
    table = torch.zeros(2, MAXB, dtype=torch.int32, device=dev)
    table[0] = (torch.randperm(MAXB, generator=gen, device=dev) + 1).int()
    ids = torch.randint(0, cfg.vocab_size, (1, C), generator=gen, device=dev)
    offs = torch.arange(C, device=dev)
    mask = (offs < n_valid)[None]
    pos = torch.where(mask, offs[None], torch.full_like(offs[None], -1))
    errs = []
    outs = [forward(params, ids, cfg, arenas[i], pos, table[:1], mask,
                    paged_chunk=True, plain=bool(i))[0][0, n_valid - 1]
            for i in range(2)]
    errs.append(max_err(outs[0], outs[1]))
    tok = int(outs[1].argmax())
    length = n_valid
    for _ in range(8):
        # row 1 is an inactive decode row: table 0, length 0
        step_ids = torch.tensor([[tok], [0]], device=dev)
        step_pos = torch.tensor([[length], [0]], device=dev)
        outs = [forward(params, step_ids, cfg, arenas[i], step_pos, table,
                        plain=bool(i))[0][0, -1] for i in range(2)]
        for o in outs:
            if not bool(torch.isfinite(o).all()):
                raise AssertionError(f"{phase}: non-finite logits")
        errs.append(max_err(outs[0], outs[1]))
        tok = int(outs[1].argmax())
        length += 1
    if not max(errs) <= E2E_TOL:
        raise AssertionError(f"{phase}: logits max abs error {max(errs)} > "
                             f"{E2E_TOL}")
    return errs, outs[1]


# ---------------------------------------------------------------------------
# generate with llama-7b at full width, and dense parity at reduced depth
# ---------------------------------------------------------------------------


GEN_LENS = [500, 64, 287, 133, 411, 350, 96, 222]
GEN_NEW = 32


def generate_prompts(V: int):
    """8 right-padded prompts of 64..500 tokens (pads are token 0) and their
    (B, S) attention mask."""
    rng = np.random.default_rng(1)
    S = max(GEN_LENS)
    ids = rng.integers(0, V, (len(GEN_LENS), S))
    mask = (np.arange(S)[None] < np.asarray(GEN_LENS)[:, None]).astype(
        np.int32)
    return ids * mask, mask


def generate_call(eng, ids, mask):
    """One ``generate`` with launch counts zeroed just before it and read
    just after. Returns (tokens, ttft s, wall s, counts)."""
    reset_launch_counts()
    t0 = time.perf_counter()
    out, ttft = eng.generate(ids, attention_mask=mask,
                             max_new_tokens=GEN_NEW, return_ttft=True)
    toks = out.cpu().numpy()
    return toks, ttft, time.perf_counter() - t0, launch_counts()


def generate_phase(srv):
    """``generate`` on the serving engine's llama-7b weights after the
    serving arena is released; two calls, the second reusing the arena.
    Returns (the first call's launch counts, its tokens, the phase's
    JSON)."""
    srv.close()
    torch.cuda.empty_cache()
    eng = srv.engine
    V = eng.model.config.vocab_size
    ids, mask = generate_prompts(V)
    lengths = torch.tensor(GEN_LENS, device=eng.device)
    prefill = eng._prefill
    seen = []

    def observed_prefill(*args):
        logits = prefill(*args)
        seen.append(logits[torch.arange(len(GEN_LENS), device=eng.device),
                           lengths - 1])
        return logits

    eng._prefill = observed_prefill
    torch.cuda.reset_peak_memory_stats()
    calls, tokens = [], []
    arena = None
    for _ in range(2):
        toks, ttft, wall, counts = generate_call(eng, ids, mask)
        tokens.append(toks)
        if toks.shape != (len(GEN_LENS), GEN_NEW) or not (
                (toks >= 0) & (toks < V)).all():
            raise AssertionError(f"generate: bad tokens {toks}")
        if not bool(torch.isfinite(seen[-1]).all()):
            raise AssertionError("generate: non-finite prefill logits")
        for name in GENERATE_KERNELS:
            if counts[name] <= 0:
                raise AssertionError(f"generate: kernel {name} never "
                                     "launched")
        k_arena = eng._arena[len(GEN_LENS)]["k"]
        if arena is not None and k_arena is not arena:
            raise AssertionError("generate: the arena was not reused")
        arena = k_arena
        calls.append(dict(
            ttft_ms=ttft * 1e3, wall_s=wall,
            decode_tokens_per_s=len(GEN_LENS) * (GEN_NEW - 1) / (wall - ttft),
            launches={n: counts[n] for n in GENERATE_KERNELS}))
    eng._prefill = prefill
    cfg = eng.model.config
    return calls[0]["launches"], tokens[0], dict(
        phase="generate", model="llama-7b", dtype="bfloat16",
        prompt_lens=GEN_LENS, new_tokens=GEN_NEW,
        max_out_tokens=eng.config.max_out_tokens,
        arena_gb=cache_memory_bytes(cfg, len(GEN_LENS),
                                    eng.config.max_out_tokens,
                                    eng.config.dtype) / 1e9,
        calls=calls, same_tokens=bool(np.array_equal(*tokens)),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


def plain_forward(*args, **kw):
    return forward(*args, plain=True, **kw)


def a8_plain_gemms(*args, **kw):
    """The kernel path with the W8A8 / W4A8 GEMMs' plain versions in place
    of their kernels: attention and norms run the same kernels as the kernel
    path, so only the a8 GEMMs can make the two differ."""
    saved = transformer.int8_a8_matmul, transformer.int4_a8_matmul
    transformer.int8_a8_matmul = quant_matmul.reference_int8_a8_matmul
    transformer.int4_a8_matmul = quant_matmul.reference_int4_a8_matmul
    try:
        return forward(*args, **kw)
    finally:
        transformer.int8_a8_matmul, transformer.int4_a8_matmul = saved


def dense_parity(params, cfg, dev, gen, phase: str, second=plain_forward,
                 tol=E2E_TOL):
    """The static prefill of 2 prompts (200 and 77 tokens, padded to 256)
    and 8 greedy decode steps over a 512-column arena whose slots outside
    ``valid`` hold large finite values, through the kernel path and through
    ``second`` (by default ``plain=True``) on two copies of the arena,
    greedy on the second path's logits; the largest error must be within
    ``tol`` (None: not held). Returns (each step's max abs logits error,
    the last logits)."""
    lens, S_pad, T = [200, 77], 256, 512
    B, S = len(lens), max(lens)
    lengths = torch.tensor(lens, device=dev)
    mask = (torch.arange(S, device=dev)[None] < lengths[:, None]).int()
    ids = torch.zeros(B, S_pad, dtype=torch.long, device=dev)
    ids[:, :S] = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                               device=dev) * mask
    valid = torch.zeros(B, T, dtype=torch.int32, device=dev)
    valid[:, :S] = mask
    arena = init_cache(cfg, B, T, torch.float32, dev)
    arena["k"].fill_(STALE)             # slots outside valid: large, finite
    arena["v"].fill_(-STALE)
    arenas = [arena, {k: v.clone() for k, v in arena.items()}]
    rows = torch.arange(B, device=dev)
    paths = (forward, second)
    outs = [paths[i](params, ids, cfg, cache=arenas[i], attention_mask=valid,
                     start_pos=0)[0][rows, lengths - 1] for i in range(2)]
    errs = [max_err(outs[0], outs[1])]
    for t in range(8):
        tok = outs[1].argmax(dim=-1)
        valid[:, S + t] = 1
        pos = (lengths + t)[:, None]
        outs = [paths[i](params, tok[:, None], cfg, cache=arenas[i],
                         attention_mask=valid, start_pos=S + t,
                         positions=pos)[0][:, -1] for i in range(2)]
        for o in outs:
            if not bool(torch.isfinite(o).all()):
                raise AssertionError(f"{phase}: non-finite logits")
        errs.append(max_err(outs[0], outs[1]))
    if tol is not None and not max(errs) <= tol:
        raise AssertionError(f"{phase}: logits max abs error {max(errs)} > "
                             f"{tol}")
    return errs, outs[1]


def e2e_generate_phase(dev):
    """Dense prefill + 8 decode steps at llama-7b widths, 2 layers, fp32:
    the kernel path against ``plain=True`` on two copies of one arena."""
    cfg = transformer_config("llama-7b", dtype=torch.float32, num_layers=2,
                             max_seq_len=512)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    params = init_params(gen, cfg)
    errs, last = dense_parity(params, cfg, dev, gen, "e2e_generate")
    return dict(phase="e2e_generate_parity", model="llama-7b", layers=2,
                dtype="float32", prompt_lens=[200, 77], padded=256,
                arena=512, decode_steps=8, max_abs_err=max(errs),
                per_step=errs, tol=E2E_TOL,
                logits_absmax=float(last.abs().max()))


# ---------------------------------------------------------------------------
# quantized llama-7b: generate in four modes, serve in int8, 2-layer parity
# ---------------------------------------------------------------------------


def quantized_bytes(tree) -> int:
    """Bytes of the quantized weight sites (values and scales)."""
    if is_quantized(tree):
        return tree_bytes(tree)
    if isinstance(tree, dict):
        return sum(quantized_bytes(v) for v in tree.values())
    return 0


def quant_generate(mode: str, params, ids, mask, bf16_tokens):
    """``init_inference("llama-7b", dtype=mode)`` at full width (from seeded
    random bf16 weights, quantized leaf by leaf, or over ``params``, an
    already quantized tree), then ``generate`` as the generate phase does,
    twice. Each call must launch the mode's GEMM at every weight site of
    every decode forward (225 x 31) and no other quantized
    GEMM, and flash / decode attention and the norm once per layer (and
    norm) of each forward. Returns (the first call's launch counts, the
    phase's JSON, the engine)."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = init_inference("llama-7b", dtype=mode, seed=0, params=params,
                         max_out_tokens=1024)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    cfg = eng.model.config
    check_llama_7b(cfg)
    L, V = cfg.num_layers, cfg.vocab_size
    want = {name: 0 for name in QUANT_MODES.values()}
    want.update({QUANT_MODES[mode]: per_forward(cfg) * (GEN_NEW - 1),
                 "flash_attention": L,
                 "decode_attention": L * (GEN_NEW - 1),
                 "fused_layer_norm": (2 * L + 1) * GEN_NEW})
    decode = eng._decode
    seen = []

    def observed_decode(*args):
        logits = decode(*args)
        seen.append(logits)
        return logits

    eng._decode = observed_decode
    torch.cuda.reset_peak_memory_stats()
    calls, first = [], None
    for _ in range(2):
        seen.clear()
        toks, ttft, wall, counts = generate_call(eng, ids, mask)
        if toks.shape != (len(GEN_LENS), GEN_NEW) or not (
                (toks >= 0) & (toks < V)).all():
            raise AssertionError(f"quant_generate {mode}: bad tokens {toks}")
        if not all(bool(torch.isfinite(x).all()) for x in seen):
            raise AssertionError(f"quant_generate {mode}: non-finite decode "
                                 "logits")
        got = {name: counts[name] for name in want}
        if got != want:
            raise AssertionError(f"quant_generate {mode}: launches {got}, "
                                 f"expected {want}")
        first = counts if first is None else first
        calls.append(dict(
            ttft_ms=ttft * 1e3, wall_s=wall,
            decode_tokens_per_s=len(GEN_LENS) * (GEN_NEW - 1) / (wall - ttft),
            launches=got, tokens_equal_to_bf16=float((toks == bf16_tokens
                                                      ).mean())))
    del eng._decode        # the bound method again: no reference cycle
    return first, dict(
        phase="quant_generate", model="llama-7b", mode=mode,
        compute_dtype=str(eng.config.dtype), prompt_lens=GEN_LENS,
        new_tokens=GEN_NEW, init_s=init_s, init_peak_mem_gb=init_peak,
        weights_gb=tree_bytes(eng.params) / 1e9,
        quantized_weights_gb=quantized_bytes(eng.params) / 1e9,
        calls=calls, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9), \
        eng


def quant_phases(smi, bf16_tokens):
    """quant_generate in int8, then in w8a8 over the int8 tree, quant_serve
    over the int8 tree; then quant_generate in int4, then in w4a8 over the
    int4 tree. Emits each phase's line; returns the summed launch counts of
    the first generate call of each mode and of the serve run."""
    ids, mask = generate_prompts(LLAMA_7B[-1])
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    for modes in (("int8", "w8a8"), ("int4", "w4a8")):
        params = None
        for mode in modes:
            counts, out, eng = quant_generate(mode, params, ids, mask,
                                              bf16_tokens)
            emit(dict(out, card=smi))
            add(counts)
            params = eng.params
            del eng
            torch.cuda.empty_cache()      # its arena, before the next load
        if modes[0] == "int8":
            counts, out, srv = serve_phase("int8", params)
            srv.close()
            del srv
            emit(dict(out, card=smi))
            add(counts)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return total


def e2e_quant_phase(dev):
    """llama-7b widths at 2 layers, fp32 compute, weights int8, int4 (one
    group) and int4 in groups of 128, each weight-only and with quantized
    activations (w8a8 / w4a8: ``a8_decode``): the dense prefill (dequantized
    in both paths: 2 x 256 rows) and 8 decode steps of 2 rows, through the
    quantized GEMM kernels, held to E2E_TOL against ``plain=True`` for the
    weight-only modes and against the same kernel path with the a8 GEMMs'
    plain versions for w8a8 / w4a8 (``a8_plain_gemms``; the a8 GEMMs
    equal their plain versions bit for bit, grouped int4 too). Against
    ``plain=True`` the a8 modes are measured, not held
    (``plain_path_max_abs_err``): the attention and norm kernels differ from
    their plain versions by fp32 rounding, and the activation quantization
    turns such a difference into a whole quantization step wherever it
    moves x / sx across a rounding boundary. Each decode step must launch
    the mode's GEMM at every weight site and no other."""
    cfg = transformer_config("llama-7b", dtype=torch.float32, num_layers=2,
                             max_seq_len=512)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    dense = init_params(gen, cfg)
    cases = []
    for bits, groups in ((8, None), (4, None), (4, 128)):
        params = quantize_model_weights(dense, bits=bits, group_size=groups)
        for a8 in (False, True):
            mode = ("w" if a8 else "int") + str(bits) + ("a8" if a8 else "")
            want = {name: 0 for name in QUANT_MODES.values()}
            want[QUANT_MODES[mode]] = 8 * per_forward(cfg)
            mcfg = dataclasses.replace(cfg, a8_decode=a8)
            label = f"e2e_quant {mode} groups {groups}"
            reset_launch_counts()
            errs, last = dense_parity(
                params, mcfg, dev, gen, label,
                second=a8_plain_gemms if a8 else plain_forward)
            got = {name: launch_counts()[name] for name in want}
            if got != want:
                raise AssertionError(f"e2e_quant {mode}: launches {got}, "
                                     f"expected {want}")
            case = dict(mode=mode, bits=bits, groups=groups,
                        max_abs_err=max(errs), per_step=errs,
                        logits_absmax=float(last.abs().max()))
            if a8:
                plain_errs, _ = dense_parity(params, mcfg, dev, gen, label,
                                             tol=None)
                case.update(plain_path_max_abs_err=max(plain_errs),
                            plain_path_per_step=plain_errs)
            cases.append(case)
    return dict(phase="e2e_quant_parity", model="llama-7b", layers=2,
                dtype="float32", prompt_lens=[200, 77], padded=256,
                arena=512, decode_steps=8, tol=E2E_TOL, cases=cases)


# ---------------------------------------------------------------------------
# train OPT-1.3B at full size, and training parity at reduced depth
# ---------------------------------------------------------------------------


TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 1024, 5
# bench_zero.py's config at ZeRO stage 0 (no offload, no remat)
TRAIN_CONFIG = {"train_micro_batch_size_per_gpu": TRAIN_B,
                "gradient_accumulation_steps": 1, "steps_per_print": 1000,
                "optimizer": {"type": "adamw", "params": {"lr": 1e-4}},
                "bf16": {"enabled": True},
                "zero_optimization": {"stage": 0}}


def make_trainer(dev, phase: str = "train", config=None):
    """OPT-1.3B at full size for the training phase ``phase`` of TRAINS
    (with its sparse layout as the attention impl where it names one),
    ``initialize`` under its config (or ``config``), and one fixed seeded
    (1, B, S) token batch on the card. Returns (engine, batch, seconds
    ``initialize`` took)."""
    spec = TRAINS[phase]
    impl = (make_sparse_attention_impl(sparse_path_configs()[spec["layout"]])
            if spec["layout"] else None)
    model = create_model("opt-1.3b", dtype=torch.bfloat16,
                         max_seq_len=spec["S"], attention_impl=impl)
    cfg = model.config
    if (cfg.hidden_size, cfg.num_layers, cfg.num_heads, cfg.head_dim,
            cfg.ffn_hidden_size, cfg.vocab_size) != (2048, 24, 32, 64, 8192,
                                                     50272):
        raise AssertionError(f"{phase}: OPT-1.3B widths changed: {cfg}")
    t0 = time.perf_counter()
    engine, *_ = initialize(model=model, config=config or spec["config"])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev)
    gen.manual_seed(spec["seed"])
    ids = torch.randint(0, cfg.vocab_size, (1, spec["B"], spec["S"]),
                        generator=gen, device=dev)
    return engine, {"input_ids": ids}, init_s


def train_phase(dev, phase: str):
    """A training phase of TRAINS at OPT-1.3B's full size: a warm-up step,
    then TRAIN_STEPS timed steps on one fixed batch, launch counts zeroed
    just before them and held exactly to the phase's table."""
    spec = TRAINS[phase]
    engine, batch, init_s = make_trainer(dev, phase)
    cfg = engine.model.config
    t0 = time.perf_counter()
    losses = [engine.train_batch(batch=batch)]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        losses.append(engine.train_batch(batch=batch))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: losses {losses} not finite and "
                             "falling")
    got = {name: counts[name] for name in spec["kernels"]}
    want = {name: per * TRAIN_STEPS for name, per in spec["kernels"].items()}
    if got != want:
        raise AssertionError(f"{phase}: launches {got}, expected {want}")
    n_params = param_count(engine.params)
    L, H, D, S = cfg.num_layers, cfg.hidden_size, cfg.head_dim, spec["S"]
    tokens = spec["B"] * S
    step_s = wall / TRAIN_STEPS
    flops = (6 * n_params + 12 * L * H * S) * tokens
    out = dict(
        phase=phase, model="opt-1.3b", dtype="bfloat16",
        config=spec["config"], params=n_params, init_s=init_s,
        warmup_s=warm_s, steps=TRAIN_STEPS, losses=losses,
        step_ms=step_s * 1e3, tokens_per_s=tokens / step_s,
        mfu=flops / step_s / BF16_FLOPS, launches=got,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if spec["layout"]:
        plan = tile_plan_for(sparse_path_configs()[spec["layout"]], S)
        # the formula's attention term counts all S^2 pairs, 12 D each
        # (forward 4, backward 8); the same for the pairs the layout lets
        # attend
        visible = int(visible_mask(plan, True, dev).sum()) * spec["B"]
        out.update(layout=spec["layout"], tile_density=plan.density,
                   active_tiles=plan.active_tiles,
                   attention_flops_formula=12.0 * L * H * S * tokens,
                   attention_flops_visible=12.0 * D * visible * L)
    del engine
    torch.cuda.empty_cache()
    return counts, out


E2E_TRAIN_STEPS = 3


def leaf_names(tree, prefix: str = ""):
    """Dotted names of ``tree``'s leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in leaf_names(v, f"{prefix}{k}.")]
    return [] if tree is None else [prefix[:-1]]


def train_parity(phase, model, cfg, plain_opt, batch, tol=E2E_TRAIN_TOL,
                 preset="opt-1.3b"):
    """3 steps of ``model`` under ``cfg`` through the kernel path and
    through the plain path (``loss_fn(..., plain=True)`` and ``plain_opt``)
    from the same seeded weights and one batch, on the batch's device; the
    first step runs staged (forward / backward / step) to read its grads,
    and a third kernel-path engine takes its first step on the plain path's
    first grads (the optimizer alone). Returns the phase's JSON, raising
    when a measure is outside ``tol`` (unless it is None)."""
    plain_loss = model.loss_fn
    plain_model = Model(init=model.init, config=model.config, name=model.name,
                        loss_fn=lambda p, b: plain_loss(p, b, plain=True))
    dev = batch["input_ids"].device
    engines = [initialize(model=model, config=cfg, device=dev)[0],
               initialize(model=plain_model, config=cfg, optimizer=plain_opt,
                          device=dev)[0]]
    names = leaf_names(engines[0].params)
    start = [t.detach().clone() for t in tree_leaves(engines[0].params)]
    losses, grads = [[], []], []
    for i, eng in enumerate(engines):
        losses[i].append(float(eng.forward(batch).detach()))
        eng.backward()
        grads.append([g.clone() for g in tree_leaves(eng.opt_state.grads)])
        eng.step()
        if i == 1:
            first = [t.detach().clone() for t in tree_leaves(eng.params)]
        for _ in range(E2E_TRAIN_STEPS - 1):
            losses[i].append(float(eng.train_batch(
                batch={k: x[None] for k, x in batch.items()})))
    # the optimizer alone: a third kernel-path engine takes its first step
    # on the plain path's first gradients
    opt_eng = initialize(model=model, config=cfg, device=dev)[0]
    opt_eng.forward(batch)
    opt_eng.backward()
    for g, src in zip(tree_leaves(opt_eng.opt_state.grads), grads[1]):
        g.copy_(src)
    opt_eng.step()
    engines.append(opt_eng)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(*losses))
    largest = max(float(g.abs().max()) for g in grads[1])
    params = [[t.detach() for t in tree_leaves(e.params)] for e in engines]
    grad_rel, update_rel, opt_rel, zero = {}, {}, {}, []
    for i, name in enumerate(names):
        if float(grads[1][i].abs().max()) <= ZERO_GRAD * largest:
            zero.append(name)
            continue
        grad_rel[name] = float((grads[0][i] - grads[1][i]).norm()
                               / grads[1][i].norm())
        update_rel[name] = float((params[0][i] - params[1][i]).norm()
                                 / (params[1][i] - start[i]).norm())
        opt_rel[name] = float((params[2][i] - first[i]).norm()
                              / (first[i] - start[i]).norm())
    grad_err, update_err = max(grad_rel.values()), max(update_rel.values())
    opt_err = max(opt_rel.values())
    out = dict(phase=phase, model=preset, layers=2, dtype="float32",
               batch=list(batch["input_ids"].shape), steps=E2E_TRAIN_STEPS,
               optimizer=cfg["optimizer"], losses=losses,
               loss_rel_err=loss_err, grad_rel_err=grad_err,
               update_rel_err=update_err, opt_step_rel_err=opt_err,
               zero_grad_leaves=zero, grad_rel_by_leaf=grad_rel,
               update_rel_by_leaf=update_rel, opt_step_rel_by_leaf=opt_rel,
               tol=tol)
    if tol is not None and not (loss_err <= tol["loss_rel"]
                                and grad_err <= tol["grad_rel"]
                                and update_err <= tol["update_rel"]
                                and opt_err <= tol["opt_step_rel"]):
        raise AssertionError(f"{phase}: kernel and plain paths differ: "
                             f"{out}")
    del engines
    torch.cuda.empty_cache()
    return out


def e2e_train_phase(dev):
    """OPT-1.3B widths at 2 layers, fp32, AdamW with weight decay and
    clipping, one batch with a right-padded mask: ``train_parity``."""
    model = create_model("opt-1.3b", dtype=torch.float32, num_layers=2,
                         max_seq_len=256)
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": 1, "steps_per_print": 1000,
           "gradient_clipping": 1.0,
           "optimizer": {"type": "adamw",
                         "params": {"lr": 1e-4, "weight_decay": 0.01}}}
    plain_opt = MixedPrecisionOptimizer(1e-4, grad_clip=1.0,
                                        weight_decay=0.01, plain=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    ids = torch.randint(0, model.config.vocab_size, (2, 256), generator=gen,
                        device=dev)
    mask = torch.ones(2, 256, dtype=torch.int32, device=dev)
    mask[1, 200:] = 0
    return train_parity("e2e_train_parity", model, cfg, plain_opt,
                        {"input_ids": ids, "attention_mask": mask})


# ZeRO stages 1-3 at world 1 over NCCL: the train phase's config, weights
# and batch, a warm-up and ZERO_STEPS timed steps a stage. Their losses are
# held to the stage-0 train phase's: the update is the same math, but the
# flash backward's dq is summed in the order its blocks finish, so the grads
# are not bit for bit from run to run. The bound is derived in the phase: a
# repeat of stage 0 against the train phase gives the run-to-run spread of
# the losses (the same code twice), and a stage may differ from stage 0 by
# ZERO_SPREAD_FACTOR times that spread, at least ZERO_LOSS_FLOOR. Measured
# on an H100 80GB HBM3, 700 W: repeat spreads 7.9e-6 to 1.57e-5, stages 1-3
# within 1.25e-5 to 1.45e-5 of stage 0 (a fixed 5e-3 held them before). The
# same bound holds the phases that repeat the train configuration:
# lamb_zero's stage 3 against its stage 0, onebit's dense warm-up and nvme
# against the train phase
ZERO_STEPS = 2
ZERO_SPREAD_FACTOR = 10.0
ZERO_LOSS_FLOOR = 1e-4
# the checkpoint phase: OPT-1.3B's format-2 checkpoint (bf16 params, fp32
# master and two moments: about 18 GB) and the 16-bit export need this much
# free space
CKPT_NEED_BYTES = 24e9


def zero_config(stage: int, **extra):
    cfg = dict(TRAIN_CONFIG, zero_optimization={"stage": stage})
    cfg.update(extra)
    return cfg


def zero_stage_run(dev, stage: int, base_losses):
    """OPT-1.3B at the train phase's config and batch under ZeRO ``stage``:
    a warm-up and ZERO_STEPS timed steps with the train path's exact
    launches (one vector-route Adam launch a step), then one step with the
    comms logger on for each collective's count and bytes a step."""
    engine, batch, init_s = make_trainer(dev, "train", zero_config(stage))
    spec = TRAINS["train"]
    losses = [engine.train_batch(batch=batch)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine.zero.peak_live = engine.zero.live
    reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(ZERO_STEPS):
        losses.append(engine.train_batch(batch=batch))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    got = {name: counts[name] for name in spec["kernels"]}
    want = {name: per * ZERO_STEPS for name, per in spec["kernels"].items()}
    if got != want:
        raise AssertionError(f"zero stage {stage}: launches {got}, expected "
                             f"{want}")
    if fused_adam.last_route() != "vector":
        raise AssertionError(f"zero stage {stage}: Adam took the "
                             f"{fused_adam.last_route()} route")
    clog = comm.get_comms_logger()
    clog.reset()
    clog.enabled = True
    engine.train_batch(batch=batch)
    clog.enabled = False
    losses = [float(x) for x in losses]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, base_losses))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"zero stage {stage}: losses {losses}")
    if stage == 3 and engine.zero.peak_live > 2:
        raise AssertionError(f"zero stage 3: {engine.zero.peak_live} gather "
                             "units alive at once")
    tokens = spec["B"] * spec["S"]
    out = dict(stage=stage, init_s=init_s, losses=losses,
               stage0_losses=base_losses[:len(losses)], loss_rel_err=rel,
               steps=ZERO_STEPS,
               step_ms=wall / ZERO_STEPS * 1e3,
               tokens_per_s=tokens * ZERO_STEPS / wall,
               peak_mem_gb=peak / 1e9, launches=got,
               adam_route=fused_adam.last_route(),
               partition=engine.partition.describe(),
               gather_units_peak=engine.zero.peak_live,
               comm_per_step={op: {"count": v["count"], "bytes": v["bytes"]}
                              for op, v in clog.summary().items()})
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out, counts


def zero_phase(dev, base_losses):
    """ZeRO stages 0 (a repeat), 1, 2 and 3 at world 1 in the process group
    main() opened: ``zero_stage_run`` each, against the stage-0 train
    phase's losses; the repeat's spread sets the bound (ZERO_SPREAD_FACTOR)
    the other stages are held to. Returns (counts of stages 1-3, the
    phase's JSON with the bound as ``loss_rtol``)."""
    stages, counts = {}, {}
    for stage in (0, 1, 2, 3):
        stages[stage], c = zero_stage_run(dev, stage, base_losses)
        if stage == 0:
            continue
        for name, n in c.items():
            counts[name] = counts.get(name, 0) + n
    spread = stages[0]["loss_rel_err"]
    bound = max(ZERO_LOSS_FLOOR, ZERO_SPREAD_FACTOR * spread)
    for stage in (1, 2, 3):
        if not stages[stage]["loss_rel_err"] <= bound:
            raise AssertionError(
                f"zero stage {stage}: losses {stages[stage]['losses']} "
                f"against stage 0's {base_losses[:ZERO_STEPS + 1]}: "
                f"{stages[stage]['loss_rel_err']} above {bound}")
    return counts, dict(phase="zero", model="opt-1.3b", dtype="bfloat16",
                        world=comm.get_world_size(),
                        backend=torch.distributed.get_backend(),
                        stage0_repeat_spread=spread,
                        spread_factor=ZERO_SPREAD_FACTOR,
                        loss_floor=ZERO_LOSS_FLOOR, loss_rtol=bound,
                        stages=stages)


def largest_disk():
    """Of the temporary directory and the checkout, the one on the disk
    with the more free space."""
    return max((tempfile.gettempdir(), os.getcwd()),
               key=lambda c: shutil.disk_usage(c).free)


def leaf_of(engine, buf, path):
    """Leaf ``path`` of a buffer laid out as ``engine``'s shard, at world 1
    (every unit is whole in the shard)."""
    part = engine.partition
    plist = part.leaf_pieces()[path]
    return torch.cat([buf[part.shard_offsets[i] + pc.offset:
                          part.shard_offsets[i] + pc.offset + pc.numel]
                      for i, pc in plist]).view(plist[0][1].shape)


def checkpoint_phase(dev, bound):
    """OPT-1.3B at stage 2 (and a WarmupLR schedule) trains 2 steps and is
    saved in format 2 on the largest local disk; the tag is verified
    (re-hashed) and loaded into a fresh stage-3 engine, whose params,
    master, moments, counts, loss scale and schedule must equal the saved
    engine's bit for bit; one more step on each, losses within ``bound``
    (the zero phase's); then ``save_16bit_model`` is read back bit for
    bit."""
    root = largest_disk()
    usage = shutil.disk_usage(root)
    if usage.free < CKPT_NEED_BYTES:
        raise AssertionError(
            f"checkpoint: {root} has {usage.free / 1e9:.1f} GB free; the "
            f"OPT-1.3B checkpoint needs {CKPT_NEED_BYTES / 1e9:.0f} GB")
    sched = {"type": "WarmupLR", "params": {"warmup_num_steps": 10,
                                            "warmup_max_lr": 1e-4}}
    d = tempfile.mkdtemp(prefix="ckpt-", dir=root)
    try:
        a, batch, _ = make_trainer(dev, "train",
                                   zero_config(2, scheduler=sched))
        for _ in range(2):
            a.train_batch(batch=batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.save_checkpoint(d, tag="step2")
        save_s = time.perf_counter() - t0
        written = sum(os.path.getsize(os.path.join(dp, f))
                      for dp, _, fs in os.walk(d) for f in fs)
        t0 = time.perf_counter()
        problems = ckpt.verify_checkpoint(d, "step2")
        verify_s = time.perf_counter() - t0
        if problems:
            raise AssertionError(f"checkpoint: verify found {problems[:3]}")
        b = make_trainer(dev, "train", zero_config(3, scheduler=sched))[0]
        t0 = time.perf_counter()
        b.load_checkpoint(d)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        differ = []
        for path in a.partition.leaf_pieces():
            for what, x, y in (
                    ("params", a.zero.shard, b.zero.shard),
                    ("master", a.opt_state.master, b.opt_state.master),
                    ("exp_avg", a.opt_state.exp_avg, b.opt_state.exp_avg),
                    ("exp_avg_sq", a.opt_state.exp_avg_sq,
                     b.opt_state.exp_avg_sq)):
                if not torch.equal(leaf_of(a, x, path), leaf_of(b, y, path)):
                    differ.append(f"{what} {'.'.join(path)}")
        for what, x, y in (
                ("count", a.opt_state.count, b.opt_state.count),
                ("inner_count", a.opt_state.inner_count,
                 b.opt_state.inner_count),
                ("global_steps", a.global_steps, b.global_steps),
                ("loss_scale", a.cur_scale, b.cur_scale),
                ("lr_scheduler", a.lr_scheduler.state_dict(),
                 b.lr_scheduler.state_dict())):
            if x != y:
                differ.append(f"{what} {x} != {y}")
        if differ:
            raise AssertionError(f"checkpoint: restored state differs: "
                                 f"{differ[:8]}")
        la, lb = (float(e.train_batch(batch=batch)) for e in (a, b))
        rel = abs(la - lb) / abs(la)
        if not rel <= bound:
            raise AssertionError(f"checkpoint: next losses {la} / {lb}")
        del a
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        path16 = b.save_16bit_model(d)
        s16 = time.perf_counter() - t0
        flat = ckpt.load_flat_weights(path16)
        bad = [".".join(p) for p, t in tree_items(b.params)
               if not torch.equal(t.cpu(), flat["##".join(p)])]
        if bad:
            raise AssertionError(f"checkpoint: 16-bit export differs at "
                                 f"{bad[:4]}")
        return dict(phase="checkpoint", model="opt-1.3b", dtype="bfloat16",
                    save_stage=2, load_stage=3, disk=root,
                    disk_total_gb=usage.total / 1e9,
                    disk_free_gb=usage.free / 1e9,
                    written_gb=written / 1e9, save_s=save_s,
                    save_gb_per_s=written / 1e9 / save_s,
                    verify_s=verify_s, load_s=load_s,
                    load_gb_per_s=written / 1e9 / load_s,
                    load_read="warm (page cache)",
                    restored_bit_equal=True, next_losses=[la, lb],
                    next_loss_rel_err=rel,
                    fp16_model_gb=os.path.getsize(path16) / 1e9,
                    save_16bit_s=s16)
    finally:
        shutil.rmtree(d, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# LAMB under ZeRO, the 1-bit optimizers, optimizer-state offload, the sweep
# ---------------------------------------------------------------------------


LAMB_ZERO_CONFIG = dict(TRAIN_CONFIG, optimizer={"type": "lamb",
                                                 "params": {"lr": 1e-4}})
# the train path's launches a step with LAMB: one phase-1 launch over the
# rank's shard (its segments are parts of leaves at stage 3), no Adam
LAMB_ZERO_KERNELS = dict(TRAIN_KERNELS, fused_adam=0, fused_lamb=1)


def lamb_zero_phase(dev, bound):
    """OPT-1.3B, the train configuration with LAMB, at ZeRO stages 0 and 3:
    a warm-up and ZERO_STEPS timed steps each with exact launches; stage 3's
    losses within ``bound`` (the zero phase's) of stage 0's."""
    runs, counts = {}, {}
    for stage in (0, 3):
        cfg = dict(LAMB_ZERO_CONFIG, zero_optimization={"stage": stage})
        engine, batch, init_s = make_trainer(dev, "train", cfg)
        losses = [engine.train_batch(batch=batch)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(ZERO_STEPS):
            losses.append(engine.train_batch(batch=batch))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = launch_counts()
        got = {name: c[name] for name in LAMB_ZERO_KERNELS}
        want = {name: per * ZERO_STEPS
                for name, per in LAMB_ZERO_KERNELS.items()}
        if got != want:
            raise AssertionError(f"lamb_zero stage {stage}: launches {got}, "
                                 f"expected {want}")
        for name, n in got.items():
            counts[name] = counts.get(name, 0) + n
        losses = [float(x) for x in losses]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"lamb_zero stage {stage}: {losses}")
        seg = engine.opt_state.segments
        runs[stage] = dict(init_s=init_s, losses=losses,
                           step_ms=wall / ZERO_STEPS * 1e3,
                           peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                           launches=got, segments=len(seg.sizes),
                           leaves=seg.n_leaves or len(seg.sizes))
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(runs[3]["losses"], runs[0]["losses"]))
    if not rel <= bound:
        raise AssertionError(f"lamb_zero: stage 3's losses {runs[3]['losses']}"
                             f" against stage 0's {runs[0]['losses']}")
    return counts, dict(phase="lamb_zero", model="opt-1.3b", dtype="bfloat16",
                        optimizer=LAMB_ZERO_CONFIG["optimizer"],
                        loss_rel_err=rel, loss_rtol=bound, stages=runs)


# onebitadam's losses after its warm-up stay within ONEBIT_DENSE_RTOL of the
# dense AdamW run's (the JAX package's tests/unit/test_onebit.py bound)
ONEBIT_DENSE_RTOL = 0.05
ONEBIT_STEPS = 5


def onebit_config(kind: str, **params):
    return dict(TRAIN_CONFIG, optimizer={"type": kind, "params": dict(
        {"lr": 1e-4}, **params)})


def onebit_run(dev, cfg, steps: int, logged=()):
    """``steps`` train steps of OPT-1.3B under ``cfg``; the comms logger on
    for the steps in ``logged``. Returns (losses, step seconds, per logged
    step the comms summary, the engine's dense / compressed choice a
    step)."""
    engine, batch, _ = make_trainer(dev, "train", cfg)
    clog = comm.get_comms_logger()
    losses, secs, logs, kinds = [], [], {}, []
    for step in range(steps):
        ob = engine._onebit
        count = engine.opt_state.count
        kinds.append("dense" if count < ob["freeze"] or (
            ob["zero_one"] is not None
            and zero_one_var_step(count, *ob["zero_one"])) else "compressed")
        if step in logged:
            clog.reset()
            clog.enabled = True
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch=batch)))
        secs.append(time.perf_counter() - t0)
        if step in logged:
            clog.enabled = False
            logs[step] = {op: {"count": v["count"], "bytes": v["bytes"]}
                          for op, v in clog.summary().items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return losses, secs, logs, kinds, peak


def onebit_phase(dev, base_losses, bound):
    """OPT-1.3B with the train configuration under the 1-bit optimizers at
    world 1 (the exchange is a copy, but the quantization and the error
    feedback run): onebitadam with freeze_step 2 for ONEBIT_STEPS steps,
    against the train phase's dense AdamW losses: the first equal bit for
    bit, the two after the dense warm-up steps within ``bound``, the rest
    falling and within ONEBIT_DENSE_RTOL; then onebitlamb and zerooneadam 3
    steps each. The comms logger reads a dense and a compressed step."""
    torch.cuda.reset_peak_memory_stats()
    losses, secs, logs, kinds, peak = onebit_run(
        dev, onebit_config("onebitadam", freeze_step=2), ONEBIT_STEPS,
        logged=(1, ONEBIT_STEPS - 1))
    dense = base_losses[:ONEBIT_STEPS]
    warm = max(abs(a - b) / abs(b) for a, b in zip(losses[1:3], dense[1:3]))
    after = max(abs(a - b) / abs(b) for a, b in zip(losses[3:], dense[3:]))
    if not (losses[0] == dense[0] and warm <= bound
            and after <= ONEBIT_DENSE_RTOL and losses[-1] < losses[0]
            and all(np.isfinite(losses))):
        raise AssertionError(f"onebit: onebitadam losses {losses} against "
                             f"dense AdamW's {dense}")
    wire = {k: sum(v["bytes"] for op, v in log.items()
                   if op.startswith("onebit_"))
            for k, log in (("dense", logs[1]),
                           ("compressed", logs[ONEBIT_STEPS - 1]))}
    out = dict(phase="onebit", model="opt-1.3b", dtype="bfloat16",
               world=comm.get_world_size(),
               onebitadam=dict(freeze_step=2, losses=losses, kinds=kinds,
                               dense_adamw_losses=dense,
                               warmup_rel_err=warm, warmup_rtol=bound,
                               compressed_rel_err=after,
                               compressed_rtol=ONEBIT_DENSE_RTOL,
                               step_ms=[x * 1e3 for x in secs],
                               logged_steps=[1, ONEBIT_STEPS - 1],
                               comm_dense_step=logs[1],
                               comm_compressed_step=logs[ONEBIT_STEPS - 1],
                               wire_bytes_a_step=wire, peak_mem_gb=peak))
    for kind, params in (("onebitlamb", dict(freeze_step=1)),
                         ("zerooneadam", dict(freeze_step=1,
                                              var_update_scaler=1))):
        torch.cuda.reset_peak_memory_stats()
        losses, secs, _, kinds, peak = onebit_run(
            dev, onebit_config(kind, **params), 3)
        if not all(np.isfinite(losses)) or "compressed" not in kinds:
            raise AssertionError(f"onebit: {kind} losses {losses}, {kinds}")
        out[kind] = dict(params, losses=losses, kinds=kinds,
                         step_ms=[x * 1e3 for x in secs], peak_mem_gb=peak)
    return out


# elements a sub-group of the offload tiers: each of its 16-bit grads and
# params crosses the PCIe bus in one copy, and the host update works on the
# whole group in place (host_adam_flat: three fp32 scratch rows of this size,
# 1.2 GB, allocated once; two pinned staging buffers of each kind)
OFFLOAD_SUB_GROUP = 10 ** 8


def offload_config(tier: str, nvme_path: str = "", stage: int = 1,
                   sub_group: int = OFFLOAD_SUB_GROUP, **extra):
    zero = {"stage": stage, "sub_group_size": sub_group}
    if tier != "none":
        zero["offload_optimizer"] = {"device": tier, "nvme_path": nvme_path}
    cfg = dict(TRAIN_CONFIG, zero_optimization=zero,
               aio={"thread_count": 4, "queue_depth": 8})
    cfg.update(extra)
    return cfg


OFFLOAD_PARITY_S = 1024
OFFLOAD_PARITY_STEPS = 3
# fused Adam launches over the parity phase's steps: the resident engine
# once a step, the offload tiers never (their update runs on the host)
OFFLOAD_PARITY_ADAM = {"cpu": 0, "nvme": 0, "none": OFFLOAD_PARITY_STEPS}
# each step's resident loss against tier 1's, relative to that loss: every
# step starts both engines from the same params (the resident state is
# reset to tier 1's after each step's check), so they differ only by the
# forward's run-to-run rounding
OFFLOAD_PARITY_LOSS_RTOL = 1e-5


def offload_parity_phase(dev, root):
    """llama-7b's widths cut to 2 layers (bf16, 1 x OFFLOAD_PARITY_S
    tokens, AdamW with weight decay, stage 1, OFFLOAD_SUB_GROUP) trained
    OFFLOAD_PARITY_STEPS steps three ways: resident (the fused Adam
    kernel), tier 1 (host memory) and tier 2 (NVMe under ``root``). Each
    step the tier-1 engine's grads are copied into the other two after
    their backward, so they differ in the optimizer alone (the flash
    backward is not bit for bit from run to run). Tier 2's losses, master
    and moments equal tier 1's bit for bit. Every step, the resident
    master and moments are held to tier 1's by ``check_adam`` (the kernel
    against the plain version's arithmetic on the host, from the same old
    state and grads), then the resident state and params are set to tier
    1's, so the next step starts both from the same state; each step's
    losses agree within OFFLOAD_PARITY_LOSS_RTOL."""
    model = create_model("llama-7b", dtype=torch.bfloat16, num_layers=2,
                         max_seq_len=OFFLOAD_PARITY_S)
    opt = {"type": "adamw", "params": {"lr": 1e-4, "weight_decay": 0.01}}
    cfg = lambda tier: offload_config(  # noqa: E731
        tier, os.path.join(root, tier), train_micro_batch_size_per_gpu=1,
        optimizer=opt)
    engines = {tier: initialize(model=model, config=cfg(tier))[0]
               for tier in ("cpu", "nvme", "none")}
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    batch = {"input_ids": torch.randint(
        0, model.config.vocab_size, (1, OFFLOAD_PARITY_S), generator=gen,
        device=dev)}
    st = {t: e.opt_state for t, e in engines.items()}
    kinds = ("master", "exp_avg", "exp_avg_sq")
    if not torch.equal(st["none"].master.cpu(), st["cpu"].master):
        raise AssertionError("offload_parity: the tiers start from "
                             "different masters")
    losses = {t: [] for t in engines}
    counts, stats, errs, rels = {}, {}, [], []
    for step in range(OFFLOAD_PARITY_STEPS):
        old = [getattr(st["cpu"], k).to(dev) for k in kinds]
        grads = None
        for tier in ("cpu", "nvme", "none"):
            eng = engines[tier]
            reset_launch_counts()
            losses[tier].append(float(eng.forward(batch).detach()))
            eng.backward()
            if grads is None:
                grads = st[tier].grad_flat.clone()
            else:
                st[tier].grad_flat.copy_(grads)
            eng.step()
            torch.cuda.synchronize()
            c = launch_counts()
            counts[tier] = counts.get(tier, 0) + c["fused_adam"]
            if tier != "none":
                stats[tier] = dict(st[tier].offload.stats)
        kw = dict(step=step + 1, lr=1e-4, beta1=0.9, beta2=0.999, eps=1e-8,
                  weight_decay=0.01)
        ref = [getattr(st["cpu"], k).to(dev) for k in kinds]
        got = [getattr(st["none"], k) for k in kinds]
        errs.append(check_adam(f"offload_parity step {step + 1}", old, got,
                               ref, grads, torch.ones(1, device=dev), kw))
        rels.append(abs(losses["none"][-1] - losses["cpu"][-1])
                    / abs(losses["cpu"][-1]))
        for dst, src in zip(got, ref):
            dst.copy_(src)
        st["none"].shard_param.copy_(st["cpu"].shard_param)
        del old, ref, got, grads
    swapped = st["nvme"].offload.read_state(st["nvme"].n)
    same = (losses["nvme"] == losses["cpu"] and all(
        torch.equal(swapped[k], getattr(st["cpu"], k)) for k in kinds))
    if not same:
        raise AssertionError(f"offload_parity: tier 2 {losses['nvme']} is "
                             f"not tier 1 {losses['cpu']} bit for bit")
    if max(rels) > OFFLOAD_PARITY_LOSS_RTOL or counts != OFFLOAD_PARITY_ADAM:
        raise AssertionError(f"offload_parity: resident losses "
                             f"{losses['none']} against tier 1's "
                             f"{losses['cpu']}; fused_adam launches {counts}")
    n = st["cpu"].n
    st["nvme"].offload.close(remove=True)
    del engines, st, swapped
    gc.collect()
    torch.cuda.empty_cache()
    return dict(phase="offload_parity", model="llama-7b", layers=2,
                dtype="bfloat16", tokens=OFFLOAD_PARITY_S, elements=n,
                losses=losses, tier2_equals_tier1=True,
                resident_step_max_abs_err=errs,
                adam_tol=dict(rtol_of_terms=ADAM_RTOL,
                              p_round=ADAM_P_ROUND),
                resident_loss_rel_err=rels,
                loss_rtol=OFFLOAD_PARITY_LOSS_RTOL,
                fused_adam_launches=counts, last_step=stats)


# the llama-7b train path's launches a step under offload: one flash
# forward and backward a layer, two RMS norms a layer and the final one,
# and no Adam launch (the update runs on the host)
OFFLOAD_KERNELS = {"flash_attention": 32, "flash_attention_bwd": 32,
                   "fused_layer_norm": 65, "fused_adam": 0}
OFFLOAD_S = 2048
# timed steps after the warm-up one
OFFLOAD_STEPS = 2


def host_memory_gb():
    """(RSS, peak RSS) of this process in GB, from /proc/self/status."""
    vals = {}
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith(("VmRSS:", "VmHWM:")):
                key, kb = line.split()[:2]
                vals[key[:-1]] = int(kb) * 1024 / 1e9
    return vals.get("VmRSS"), vals.get("VmHWM")


def offload_phase(dev):
    """llama-7b at full size (H 4096, 32 layers, FFN 11008, vocab 32000,
    bf16) trained under tier 1: ZeRO 1, micro batch 1 x OFFLOAD_S, gas 1,
    AdamW, the master and moments (80.9 GB) in host memory, sub-groups of
    OFFLOAD_SUB_GROUP elements. A warm-up step, then OFFLOAD_STEPS timed
    step(s) on one seeded batch: losses finite and falling, exact launches
    (no Adam), the state CPU tensors and the device holding the bf16 params
    and grads alone; the step split into device forward + backward (the wall before
    the host pipeline starts), D2H, host update and H2D."""
    model = create_model("llama-7b", dtype=torch.bfloat16,
                         max_seq_len=OFFLOAD_S)
    check_llama_7b(model.config)
    cfg = offload_config("cpu", train_micro_batch_size_per_gpu=1)
    t0 = time.perf_counter()
    engine, *_ = initialize(model=model, config=cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    st = engine.opt_state
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    batch = {"input_ids": torch.randint(0, model.config.vocab_size,
                                        (1, 1, OFFLOAD_S), generator=gen,
                                        device=dev)}
    t0 = time.perf_counter()
    losses = [float(engine.train_batch(batch=batch))]
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    steps = []
    for _ in range(OFFLOAD_STEPS):
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch=batch)))
        wall = time.perf_counter() - t0
        s = dict(st.offload.stats)
        steps.append(dict(
            step_s=wall, device_fwd_bwd_s=wall - s["apply_s"],
            host_pipeline_s=s["apply_s"], host_update_s=s["update_s"],
            host_wait_s=s["wait_s"], d2h_ms=s["d2h_ms"], h2d_ms=s["h2d_ms"],
            d2h_gb=s["d2h_bytes"] / 1e9, h2d_gb=s["h2d_bytes"] / 1e9,
            d2h_gb_per_s=(s["d2h_bytes"] / 1e6 / s["d2h_ms"]
                          if s["d2h_ms"] else None),
            h2d_gb_per_s=(s["h2d_bytes"] / 1e6 / s["h2d_ms"]
                          if s["h2d_ms"] else None)))
    counts = launch_counts()
    got = {name: counts[name] for name in OFFLOAD_KERNELS}
    want = {n: per * OFFLOAD_STEPS for n, per in OFFLOAD_KERNELS.items()}
    if got != want:
        raise AssertionError(f"offload: launches {got}, expected {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"offload: losses {losses} not finite and "
                             "falling")
    on_host = all(t.device.type == "cpu" for t in (
        st.master, st.exp_avg, st.exp_avg_sq))
    n = st.n
    params_bytes = 2 * n * st.shard_param.element_size()   # params, grads
    allocated = torch.cuda.memory_allocated()
    # the state (12 bytes an element) is not on the card: what the card
    # holds between steps is the 16-bit params and grads and little else
    if not on_host or allocated > params_bytes + 2e9:
        raise AssertionError(f"offload: state on the host {on_host}, the "
                             f"card holds {allocated / 1e9:.1f} GB")
    rss, hwm = host_memory_gb()
    out = dict(phase="offload", model="llama-7b", dtype="bfloat16",
               config=cfg, tokens=OFFLOAD_S, params=n, init_s=init_s,
               warmup_s=warm_s, losses=losses, steps=steps,
               step_ms=sum(x["step_s"] for x in steps) / len(steps) * 1e3,
               tokens_per_s=OFFLOAD_S * len(steps)
               / sum(x["step_s"] for x in steps),
               launches=got, state_on_host=on_host,
               host_state_gb=st.offload.host_bytes() / 1e9,
               sub_groups=len(st.offload.groups),
               device_allocated_gb=allocated / 1e9,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               host_rss_gb=rss, host_peak_rss_gb=hwm)
    del engine, st
    gc.collect()
    torch.cuda.empty_cache()
    return counts, out


# steps before the checkpoint, and 1 after it on each engine
NVME_STEPS = 2
NVME_SUB_GROUP = OFFLOAD_SUB_GROUP
# the nvme phase: OPT-1.3B's swap files (15.8 GB of master and moments),
# the checkpoint's snapshot of them and the params, and the restoring
# engine's swap files need this much free space
NVME_NEED_BYTES = 40e9


def nvme_phase(dev, base_losses, bound):
    """OPT-1.3B, the train configuration under tier 2 (ZeRO 1, the state in
    swap files on the largest local disk, sub-groups of NVME_SUB_GROUP
    elements, 4 aio threads): NVME_STEPS steps and a checkpoint with its
    swap snapshot, then one more step; the losses within ``bound`` of the
    resident train phase's. The checkpoint restored into a fresh tier-2
    engine: its state and its next step's loss equal bit for bit. The swap
    directories are removed."""
    root = largest_disk()
    usage = shutil.disk_usage(root)
    if usage.free < NVME_NEED_BYTES:
        raise AssertionError(f"nvme: {root} has {usage.free / 1e9:.1f} GB "
                             f"free; the phase needs "
                             f"{NVME_NEED_BYTES / 1e9:.0f} GB")
    d = tempfile.mkdtemp(prefix="nvme-", dir=root)
    try:
        t0 = time.perf_counter()
        a, batch, _ = make_trainer(dev, "train", offload_config(
            "nvme", os.path.join(d, "a"), sub_group=NVME_SUB_GROUP))
        init_s = time.perf_counter() - t0
        sw = a.opt_state.offload
        losses, steps = [], []
        for _ in range(NVME_STEPS):
            t0 = time.perf_counter()
            losses.append(float(a.train_batch(batch=batch)))
            wall = time.perf_counter() - t0
            s = dict(sw.stats)
            steps.append(dict(
                step_s=wall, host_pipeline_s=s["apply_s"],
                host_update_s=s["update_s"], wait_s=s["wait_s"],
                read_gb=s["read_bytes"] / 1e9,
                written_gb=s["write_bytes"] / 1e9,
                io_gb_per_s=(s["read_bytes"] + s["write_bytes"]) / 1e9
                / s["apply_s"]))
        rel = max(abs(x - y) / abs(y) for x, y in zip(losses, base_losses))
        if not rel <= bound:
            raise AssertionError(f"nvme: losses {losses} against the train "
                                 f"phase's {base_losses[:NVME_STEPS]}")
        t0 = time.perf_counter()
        path = a.save_checkpoint(os.path.join(d, "ckpt"), tag="step2")
        save_s = time.perf_counter() - t0
        saved = {k: v for k, v in sw.read_state(a.opt_state.n).items()}
        la = float(a.train_batch(batch=batch))
        rel = max(rel, abs(la - base_losses[NVME_STEPS])
                  / abs(base_losses[NVME_STEPS]))
        if not rel <= bound:
            raise AssertionError(f"nvme: next loss {la} against the train "
                                 f"phase's {base_losses[NVME_STEPS]}")
        snap = sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in
                   os.walk(os.path.join(path, "nvme_state_p0")) for f in fs)
        sw.close(remove=True)
        del a, sw
        gc.collect()
        torch.cuda.empty_cache()
        b = make_trainer(dev, "train", offload_config(
            "nvme", os.path.join(d, "b"), sub_group=NVME_SUB_GROUP))[0]
        t0 = time.perf_counter()
        b.load_checkpoint(os.path.join(d, "ckpt"))
        load_s = time.perf_counter() - t0
        restored = b.opt_state.offload.read_state(b.opt_state.n)
        differ = [k for k in saved if not torch.equal(saved[k], restored[k])]
        del saved, restored
        lb = float(b.train_batch(batch=batch))
        if differ or la != lb or b.global_steps != NVME_STEPS + 1:
            raise AssertionError(f"nvme: restored state differs in {differ}"
                                 f", next losses {la} / {lb}")
        groups = len(b.opt_state.offload.groups)
        b.opt_state.offload.close(remove=True)
        del b
        return dict(phase="nvme", model="opt-1.3b", dtype="bfloat16",
                    disk=root, disk_free_gb=usage.free / 1e9,
                    sub_groups=groups, init_s=init_s, losses=losses + [la],
                    train_losses=base_losses[:NVME_STEPS + 1],
                    loss_rel_err=rel, loss_rtol=bound, steps=steps,
                    save_s=save_s, snapshot_gb=snap / 1e9, load_s=load_s,
                    restored_bit_equal=True, next_losses=[la, lb],
                    reads="the page cache may hold them (warm)")
    finally:
        shutil.rmtree(d, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


# parameter offload (ZeRO-3 offload_param): llama-7b, bf16, 1 x 2048 tokens,
# AdamW, the default buffer_size (1e8 bytes: one 405 MB layer a block)
PARAM_OFFLOAD_S = 2048
PARAM_OFFLOAD_OPT = {"type": "adamw",
                     "params": {"lr": 1e-4, "weight_decay": 0.01}}
# the parity phase's deferred path: gas 2 and a clip below llama-7b's grad
# norm at its random init (the phase asserts that it clips)
PARAM_PARITY_CLIP = 0.1
PARAM_PARITY_RUNS = (("fused", 1, 0.0, 3), ("deferred", 2,
                                             PARAM_PARITY_CLIP, 2))
# timed steps after the warm-up one
PARAM_OFFLOAD_STEPS = 2
# (tier, layers) of the param_offload phase. The cpu tier holds 14 bytes a
# layer param in host memory: 90.7 GB at 32 layers against the card
# machine's 101 GiB, beside the ~9.3 GB of process overhead the offload
# phase shows there, so it runs at 16 layers (45.3 GB); the nvme tier keeps the 16-bit params
# in files and 12 bytes an element of fp32 state in host memory (77.7 GB at
# 32 layers). The 4-layer nvme run is the other end of the L-independence
# check.
PARAM_OFFLOAD_RUNS = (("nvme", 32), ("cpu", 16), ("nvme", 4))
# the 32-layer nvme tier's block files (13.0 GB) and room to spare
PARAM_NVME_NEED_BYTES = 20e9
# peak device memory at 32 layers against 4: the boundary activations (G +
# 1 of them, 1 x 2048 x 4096 bf16 = 16.8 MB each: 28 more) are the only
# storage that grows with the layers; the slack covers the allocator's
# rounding of each of them (at most 2 MiB) and a reordering of frees
PARAM_PEAK_SLACK = 28 * 2 * 2 ** 20 + 64 * 2 ** 20


def param_offload_config(tier: str, swap: str = "", gas: int = 1,
                         clip: float = 0.0):
    zero = {"stage": 3}
    if tier != "none":
        zero["offload_param"] = {"device": tier, "nvme_path": swap}
    return {"train_micro_batch_size_per_gpu": 1,
            "gradient_accumulation_steps": gas, "gradient_clipping": clip,
            "steps_per_print": 1000, "optimizer": PARAM_OFFLOAD_OPT,
            "bf16": {"enabled": True}, "zero_optimization": zero,
            "aio": {"thread_count": 4, "queue_depth": 8}}


def param_offload_launches(tier: str, layers: int, blocks: int, gas: int):
    """The train path's launches a step. Resident: a flash forward and
    backward a layer and two norms a layer and the final one, a micro
    batch; one Adam launch. Under parameter offload the backward recomputes
    each block's forward (another flash forward and two norms a layer), and
    Adam launches once a block and once for the resident part."""
    if tier == "none":
        return {"flash_attention": layers * gas,
                "flash_attention_bwd": layers * gas,
                "fused_layer_norm": (2 * layers + 1) * gas, "fused_adam": 1}
    return {"flash_attention": 2 * layers * gas,
            "flash_attention_bwd": layers * gas,
            "fused_layer_norm": (4 * layers + 1) * gas,
            "fused_adam": blocks + 1}


def param_offload_state(ex):
    """Every block's params (from the files on the nvme tier), master and
    moments, and the resident part's, as CPU copies."""
    out = {}
    for g in range(ex.num_blocks):
        out[f"params{g}"] = ex.block_params(g).clone()
        for kind in ("master", "m", "v"):
            out[f"{kind}{g}"] = getattr(ex, kind)[g].clone()
    out["res_params"] = ex.res_flat.cpu()
    for kind in ("master", "m", "v"):
        out[f"res_{kind}"] = ex.res_state(kind).cpu()
    return out


def shard_runs(engine, path, lo: int, hi: int):
    """The runs of ``engine``'s shard (world 1: every unit whole) that hold
    elements [lo, hi) of leaf ``path`` in C order: (position in the shard,
    position from ``lo``, count)."""
    part = engine.partition
    out = []
    for i, pc in part.leaf_pieces()[path]:
        a, b = max(lo, pc.start), min(hi, pc.start + pc.numel)
        if a < b:
            out.append((part.shard_offsets[i] + pc.offset + a - pc.start,
                        a - lo, b - a))
    return out


def executor_runs(engine, ex):
    """For each part of the executor's layout (its blocks, then the resident
    part) the runs of ``engine``'s shard that hold it: (position in the
    shard, position in the part, count)."""
    parts = []
    for g, (lo, hi) in enumerate(ex.bounds):
        runs = []
        for i, path in enumerate(ex.layer_paths):
            n, at = ex.leaf_numel[i], ex.offsets[g][i]
            runs += [(s, at + o, c) for s, o, c in
                     shard_runs(engine, ("layers",) + path, lo * n, hi * n)]
        parts.append(runs)
    runs, at = [], 0
    for (path, _), n in zip(ex.res_items, ex.res_numel):
        runs += [(s, at + o, c) for s, o, c in shard_runs(engine, path, 0, n)]
        at += n
    parts.append(runs)
    return parts


def gather_runs(buf, runs, n: int):
    out = torch.empty(n, dtype=buf.dtype, device=buf.device)
    for s, o, c in runs:
        out[o:o + c].copy_(buf[s:s + c])
    return out


def scatter_runs(buf, runs, src) -> None:
    for s, o, c in runs:
        buf[s:s + c].copy_(src[o:o + c])


def executor_part(ex, p: int, kind: str, dev):
    """A copy on ``dev`` of part ``p`` (a block, or the resident part after
    the last) of the executor's ``kind`` (params, master, m, v)."""
    if p < ex.num_blocks:
        src = (ex.block_params(p) if kind == "params"
               else getattr(ex, kind)[p])
    else:
        src = ex.res_flat if kind == "params" else ex.res_state(kind)
    return src.to(dev, copy=True)


# the resident engine's buffers that hold each executor kind
RESIDENT_KINDS = {"params": "shard_param", "master": "master",
                  "m": "exp_avg", "v": "exp_avg_sq"}


def param_offload_parity_phase(dev, root, bound):
    """llama-7b's widths cut to 2 layers (bf16, 1 x PARAM_OFFLOAD_S
    tokens, AdamW, stage 3) trained three ways side by side: resident,
    ``offload_param`` on the cpu tier and on the nvme tier, first 3 steps of
    the fused path, then, from a fresh init, 2 steps at gas 2 with a clip
    that clips (the deferred path). Each step the cpu tier records each
    micro-batch's grads (the executor's ``grad_hook``), the nvme tier is
    fed the same ones, and the resident engine's accumulated grads are set
    to their sum after its backward; so the three differ in the update
    alone (the flash backward's dq is not bit-repeatable). Every step: the
    resident engine's master and moments, laid out as the executor's blocks
    and resident part, are held to the cpu tier's by ``check_adam`` from the
    same old state and grads (and their bit-equality reported), then the
    resident params and state are set to the cpu tier's, so each step
    starts all three from the same state; each step's losses against the
    cpu tier's within ``bound`` (the zero phase's). The nvme tier holds to
    the cpu tier bit for bit (losses, params, master, moments); exact
    launches a step (Adam blocks + 1; the recompute's flash forwards and
    norms)."""
    model = create_model("llama-7b", dtype=torch.bfloat16, num_layers=2,
                         max_seq_len=PARAM_OFFLOAD_S)
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    # a new batch each step: on one repeated batch the 2-layer model's loss
    # falls to ~6e-4 by the third step on an H100
    ids = torch.randint(0, model.config.vocab_size,
                        (max(r[3] for r in PARAM_PARITY_RUNS), 2, 1,
                         PARAM_OFFLOAD_S), generator=gen, device=dev)
    opt = PARAM_OFFLOAD_OPT["params"]
    out, blocks = {}, None
    for path, gas, clip, steps in PARAM_PARITY_RUNS:
        engines = {tier: initialize(model=model, config=param_offload_config(
            tier, os.path.join(root, f"{path}-{tier}"), gas, clip))[0]
            for tier in ("none", "cpu", "nvme")}
        res, cpu = engines["none"], engines["cpu"]._param_offload
        nvme = engines["nvme"]._param_offload
        blocks = cpu.num_blocks
        runs = executor_runs(res, cpu)
        sizes = cpu.block_numel + [sum(cpu.res_numel)]
        parts = range(len(sizes))
        ost = res.opt_state
        start = [torch.equal(gather_runs(ost.shard_param, runs[p], sizes[p]),
                             executor_part(cpu, p, "params", dev))
                 for p in parts]
        if not all(start):
            raise AssertionError(f"param_offload_parity {path}: the resident "
                                 "and offload inits differ")
        grads = {}

        def record(part, g, t):
            grads.setdefault((part, g), []).append(t.clone())
            return t

        def replay(part, g, t):
            return grads[(part, g)].pop(0)

        cpu.grad_hook, nvme.grad_hook = record, replay
        losses = {t: [] for t in engines}
        launches = {t: {} for t in engines}
        norms, errs, equal = [], [], []
        for k in range(steps):
            batch = {"input_ids": ids[k, :gas]}
            old = [[executor_part(cpu, p, kind, "cpu") for kind in
                    ("master", "m", "v")] for p in parts]
            grads.clear()
            for tier in ("cpu", "nvme", "none"):
                reset_launch_counts()
                if tier == "none":
                    micro = []
                    for j in range(gas):
                        micro.append(float(res.forward(
                            {"input_ids": ids[k, j]}).detach()))
                        res.backward()
                    for p in parts:
                        scatter_runs(res.zero.acc, runs[p], summed[p])
                    res.step()
                    loss = sum(micro) / gas
                else:
                    loss = float(engines[tier].train_batch(batch=batch))
                if tier == "cpu":
                    # its grads summed as its accumulators sum them, for
                    # the resident engine's fp32 accumulator
                    summed = [sum(t.float() for t in grads[(
                        "block", p) if p < blocks else ("resident", -1)])
                        for p in parts]
                torch.cuda.synchronize()
                losses[tier].append(loss)
                for name, n in launch_counts().items():
                    launches[tier][name] = launches[tier].get(name, 0) + n
            norm = cpu.last_step_stats["grad_norm"]
            norms.append(norm)
            scale = torch.ones(1, device=dev)
            if clip:
                scale = torch.clamp(clip / (torch.tensor(
                    [norm], device=dev) + 1e-6), max=1.0)
            kw = dict(step=k + 1, lr=opt["lr"], beta1=0.9, beta2=0.999,
                      eps=1e-8, weight_decay=opt["weight_decay"])
            same = True
            for p in parts:
                ref = [executor_part(cpu, p, kind, dev)
                       for kind in ("master", "m", "v")]
                got = [gather_runs(getattr(ost, RESIDENT_KINDS[kind]),
                                   runs[p], sizes[p])
                       for kind in ("master", "m", "v")]
                errs.append(check_adam(
                    f"param_offload_parity {path} step {k + 1} part {p}",
                    [t.to(dev) for t in old[p]], got, ref, summed[p], scale,
                    kw))
                same = same and all(torch.equal(a, b)
                                    for a, b in zip(got, ref))
                for kind, t in zip(("master", "m", "v"), ref):
                    scatter_runs(getattr(ost, RESIDENT_KINDS[kind]), runs[p],
                                 t)
                scatter_runs(ost.shard_param, runs[p],
                             executor_part(cpu, p, "params", dev))
                del ref, got
            res.zero.gather_persistent()
            equal.append(same)
            del old, summed
        want = {t: {name: n * steps for name, n in param_offload_launches(
            t, 2, blocks, gas).items()} for t in engines}
        got = {t: {name: launches[t].get(name, 0) for name in want[t]}
               for t in engines}
        if got != want:
            raise AssertionError(f"param_offload_parity {path}: launches "
                                 f"{got}, expected {want}")
        snap, swapped = param_offload_state(cpu), param_offload_state(nvme)
        differ = [k for k in snap if not torch.equal(snap[k], swapped[k])]
        if differ or losses["nvme"] != losses["cpu"]:
            raise AssertionError(f"param_offload_parity {path}: nvme differs "
                                 f"from cpu in {differ}, losses {losses}")
        rel = [abs(a - b) / abs(b) for a, b in zip(losses["none"],
                                                   losses["cpu"])]
        if not (max(rel) <= bound and all(np.isfinite(losses["none"]))):
            raise AssertionError(f"param_offload_parity {path}: losses "
                                 f"{losses} beyond {bound}")
        if clip and not min(norms) > clip:
            raise AssertionError(f"param_offload_parity: grad norms "
                                 f"{norms} do not clip at {clip}")
        out[path] = dict(gas=gas, clip=clip, steps=steps, losses=losses,
                         loss_rel_err=rel, grad_norms=norms,
                         state_max_abs_err=max(errs),
                         state_bit_equal=equal, launches=got,
                         nvme_equals_cpu=True)
        nvme.close(remove=True)
        del engines, res, cpu, nvme, ost, snap, swapped, grads
        gc.collect()
        torch.cuda.empty_cache()
    return dict(phase="param_offload_parity", model="llama-7b", layers=2,
                dtype="bfloat16", tokens=PARAM_OFFLOAD_S, blocks=blocks,
                loss_rtol=bound,
                adam_tol=dict(rtol_of_terms=ADAM_RTOL, p_round=ADAM_P_ROUND),
                **out)


def param_offload_run(dev, tier: str, layers: int, root: str):
    """llama-7b at full width and ``layers`` layers under ``offload_param``
    on ``tier`` (fused path): init, a warm-up step and PARAM_OFFLOAD_STEPS
    timed ones on one seeded batch, with the launches of the timed steps."""
    model = create_model("llama-7b", dtype=torch.bfloat16, num_layers=layers,
                         max_seq_len=PARAM_OFFLOAD_S)
    check_llama_7b(dataclasses.replace(model.config, num_layers=32))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = initialize(model=model, config=param_offload_config(
        tier, os.path.join(root, f"{tier}{layers}")))[0]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    ex = engine._param_offload
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    batch = {"input_ids": torch.randint(
        0, model.config.vocab_size, (1, 1, PARAM_OFFLOAD_S), generator=gen,
        device=dev)}
    t0 = time.perf_counter()
    losses = [float(engine.train_batch(batch=batch))]
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    steps = []
    for _ in range(PARAM_OFFLOAD_STEPS):
        losses.append(float(engine.train_batch(batch=batch)))
        st = dict(ex.last_step_stats)
        steps.append(dict(
            step_s=st["wall_s"], forward_s=st["forward_s"],
            backward_recompute_s=st["backward_s"],
            block_updates_s=st["update_s"],
            h2d_gb=st["h2d_bytes"] / 1e9, d2h_gb=st["d2h_bytes"] / 1e9,
            disk_read_gb=st["read_bytes"] / 1e9,
            disk_written_gb=st["write_bytes"] / 1e9,
            fetch_wait_s=st["fetch_wait_s"],
            host_copy_s=st["host_copy_s"],
            device_busy_s=st["device_busy_s"],
            h2d_gb_per_s=st["achieved_h2d_gbps"],
            total_gb_per_s=st["achieved_total_gbps"],
            side_stream_copies=st["side_stream_copies"]))
    counts = launch_counts()
    want = {k: n * PARAM_OFFLOAD_STEPS for k, n in param_offload_launches(
        tier, layers, ex.num_blocks, 1).items()}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"param_offload {tier} {layers}: launches "
                             f"{got}, expected {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"param_offload {tier} {layers}: losses "
                             f"{losses} not finite and falling")
    if ex.peak_live > 2:
        raise AssertionError(f"param_offload: {ex.peak_live} blocks on the "
                             "card at once")
    peak = torch.cuda.max_memory_allocated()
    rss, hwm = host_memory_gb()
    h2d, d2h = ex.stream_bytes_per_step()
    out = dict(tier=tier, layers=layers, blocks=ex.num_blocks,
               params=ex.n_params, init_s=init_s, warmup_s=warm_s,
               losses=losses, steps=steps,
               step_s=sum(x["step_s"] for x in steps) / len(steps),
               tokens_per_s=PARAM_OFFLOAD_S * len(steps)
               / sum(x["step_s"] for x in steps),
               counted_h2d_gb=h2d / 1e9, counted_d2h_gb=d2h / 1e9,
               host_state_gb=sum(ex.block_numel) * 12 / 1e9,
               init_peak_mem_gb=init_peak / 1e9, peak_mem_gb=peak / 1e9,
               peak_mem_bytes=peak, peak_live_blocks=ex.peak_live,
               host_rss_gb=rss, host_peak_rss_gb=hwm, launches=got,
               activation_bytes=PARAM_OFFLOAD_S * model.config.hidden_size
               * 2)
    ex.close(remove=True)
    del engine, ex
    gc.collect()
    torch.cuda.empty_cache()
    return counts, out


def param_offload_phase(dev):
    """llama-7b at full size (32 layers) on the nvme tier, at full width
    and 16 layers on the cpu tier, and at 4 layers on the nvme tier
    (``param_offload_run`` each, on the largest local disk, which must have
    PARAM_NVME_NEED_BYTES free); peak device memory at 32 layers within
    28 boundary activations and PARAM_PEAK_SLACK of 4 layers'. Returns the
    timed steps' launches and the phase's JSON."""
    root = largest_disk()
    usage = shutil.disk_usage(root)
    if usage.free < PARAM_NVME_NEED_BYTES:
        raise AssertionError(
            f"param_offload: {root} has {usage.free / 1e9:.1f} GB free; "
            f"the phase needs {PARAM_NVME_NEED_BYTES / 1e9:.0f} GB")
    d = tempfile.mkdtemp(prefix="param-offload-", dir=root)
    counts, runs = {}, []
    try:
        for tier, layers in PARAM_OFFLOAD_RUNS:
            c, run = param_offload_run(dev, tier, layers, d)
            runs.append(run)
            for name, n in c.items():
                counts[name] = counts.get(name, 0) + n
    finally:
        shutil.rmtree(d, ignore_errors=True)
    peaks = {r["layers"]: r["peak_mem_bytes"] for r in runs
             if r["tier"] == "nvme"}
    hi, lo = max(peaks), min(peaks)
    act = runs[0]["activation_bytes"]
    allowed = (hi - lo) * act + PARAM_PEAK_SLACK
    if not peaks[hi] - peaks[lo] <= allowed:
        raise AssertionError(f"param_offload: peak device memory {peaks[hi]}"
                             f" at {hi} layers, {peaks[lo]} at {lo}: more "
                             f"than {allowed} apart")
    return counts, dict(phase="param_offload", model="llama-7b",
                        dtype="bfloat16", tokens=PARAM_OFFLOAD_S,
                        disk=root, disk_free_gb=usage.free / 1e9,
                        runs=runs, peak_layers=[lo, hi],
                        peak_difference_bytes=peaks[hi] - peaks[lo],
                        peak_allowed_bytes=allowed,
                        reads="the page cache may hold them (warm)")


def comm_bench_phase(dev):
    """``comm/benchmark.py``'s sweep in the world-1 NCCL group: one 64 MiB
    bf16 message an op (each collective is a one-rank copy)."""
    rows = run_comm_benchmark(minsize_log2=26, maxsize_log2=26, trials=5,
                              warmups=2, dtype=torch.bfloat16, device=dev,
                              quiet=True)
    return dict(phase="comm_bench", world=comm.get_world_size(),
                backend=torch.distributed.get_backend(),
                rows=[{k: r[k] for k in ("op", "msg_bytes", "latency_ms",
                                         "algbw_gbps", "busbw_gbps")}
                      for r in rows])


SPARSE_TRAIN_CONFIG = {"train_micro_batch_size_per_gpu": SPARSE_B,
                       "gradient_accumulation_steps": 1,
                       "steps_per_print": 1000,
                       "optimizer": {"type": "lamb",
                                     "params": {"lr": 1e-3,
                                                "weight_decay": 0.01}},
                       "bf16": {"enabled": True},
                       "zero_optimization": {"stage": 0}}
# the training phases at OPT-1.3B's full size: micro batch B x S, the
# config, the seed of the token batch, the sparse layout (a key of
# sparse_path_configs, or None for dense attention) and each kernel's
# exact launches per step
TRAINS = {"train": dict(B=TRAIN_B, S=TRAIN_S, config=TRAIN_CONFIG, seed=3,
                        layout=None, kernels=TRAIN_KERNELS),
          "sparse_train": dict(B=SPARSE_B, S=SPARSE_S,
                               config=SPARSE_TRAIN_CONFIG, seed=6,
                               layout="fixed", kernels=SPARSE_TRAIN_KERNELS)}


def sparse_parity_inputs(dev, seed: int = 7, preset: str = "opt-1.3b"):
    """e2e_sparse_train_parity's model, config, plain optimizer and batch:
    ``preset`` at 2 layers, fp32, S 512, the Fixed layout as the attention
    impl, LAMB with weight decay and clipping, weights and a batch without
    a mask (so the kernel route runs) from ``seed``."""
    heads = transformer_config(preset).num_heads
    sparsity = FixedSparsityConfig(num_heads=heads, block=16,
                                   num_local_blocks=4, num_global_blocks=1,
                                   attention="unidirectional")
    model = create_model(preset, dtype=torch.float32, num_layers=2,
                         max_seq_len=512,
                         attention_impl=make_sparse_attention_impl(sparsity))
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": 1, "steps_per_print": 1000,
           "gradient_clipping": 1.0, "seed": seed,
           "optimizer": {"type": "lamb",
                         "params": {"lr": 1e-3, "weight_decay": 0.01}}}
    plain_opt = MixedPrecisionOptimizer(1e-3, grad_clip=1.0,
                                        weight_decay=0.01, plain=True,
                                        lamb=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    ids = torch.randint(0, model.config.vocab_size, (2, 512), generator=gen,
                        device=dev)
    return model, cfg, plain_opt, {"input_ids": ids}


def e2e_sparse_train_phase(dev):
    """``train_parity`` of ``sparse_parity_inputs``; the kernel path must
    have run the block-sparse forward and backward and LAMB phase 1."""
    reset_launch_counts()
    out = train_parity("e2e_sparse_train_parity", *sparse_parity_inputs(dev),
                       E2E_SPARSE_TRAIN_TOL)
    counts = launch_counts()
    for name in ("block_sparse_attention_fwd", "block_sparse_attention_bwd",
                 "fused_lamb"):
        if counts[name] <= 0:
            raise AssertionError(f"e2e_sparse_train_parity: {name} never "
                                 "launched")
    return dict(out, sparsity="FixedSparsityConfig(block 16, 4 local, "
                "1 global, unidirectional)",
                launches={n: counts[n] for n in SPARSE_TRAIN_KERNELS})


# ---------------------------------------------------------------------------
# the SD v1.5 VAE mid block, and group quantization over OPT-1.3B
# ---------------------------------------------------------------------------


def spatial_flops(B: int, HW: int, C: int, k: int = 3):
    """Multiply-adds x 2 of one mid block call: the four k x k convs, the
    attention (4 B HW^2 C: QK^T and PV) and the q / k / v / proj GEMMs."""
    return dict(convs=4 * 2.0 * B * HW * C * C * k * k,
                attention=4.0 * B * HW * HW * C,
                qkv_proj=4 * 2.0 * B * HW * C * C)


def mid_block_inputs(dev):
    """The spatial phase's seeded bf16 mid block weights and latent batch
    (SPATIAL), and its group count."""
    B, side, C, G = (SPATIAL[k] for k in ("B", "latent", "C", "groups"))
    params = init_mid_block(torch.Generator(device=dev).manual_seed(11), C,
                            device=dev, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    x = torch.randn(B, side, side, C, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    return params, x, G


def spatial_phase(dev):
    """The SD v1.5 VAE decoder's mid block at full width (SPATIAL: a 64 x
    64 latent of 512 channels, 32 groups, eps 1e-6, batch 4; seeded bf16
    weights): a warm-up call, then SPATIAL_CALLS timed calls with launch
    counts zeroed just before them and held exactly to SPATIAL_KERNELS per
    call; the output finite and within SPATIAL_TOL * max|plain| of the
    plain path (``plain=True``) on the same weights."""
    params, x, G = mid_block_inputs(dev)
    B, side, C = x.shape[0], x.shape[1], x.shape[3]
    with torch.no_grad():
        out = mid_block(x, params, G)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(SPATIAL_CALLS):
            out = mid_block(x, params, G)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        want = {name: SPATIAL_KERNELS.get(name, 0) * SPATIAL_CALLS
                for name in counts}
        if counts != want:
            raise AssertionError(f"spatial: launches {counts}, expected "
                                 f"{want}")
        plain = mid_block(x, params, G, plain=True)
    if out.shape != x.shape or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"spatial: output {tuple(out.shape)} not "
                             "finite or not of the input's shape")
    err, scale = max_err(out, plain), float(plain.float().abs().max())
    if not err <= SPATIAL_TOL * scale:
        raise AssertionError(f"spatial: max abs error {err} > "
                             f"{SPATIAL_TOL} * {scale}")
    ms = wall / SPATIAL_CALLS * 1e3
    flops = spatial_flops(B, side * side, C)
    total = sum(flops.values())
    return counts, dict(
        phase="spatial", model="sd-v1.5 vae decoder mid block",
        dtype="bfloat16", B=B, latent=[side, side], channels=C, groups=G,
        eps=SPATIAL["eps"], params=param_count(params), calls=SPATIAL_CALLS,
        ms_per_call=ms, latents_per_s=B / (ms / 1e3), flops_per_call=total,
        flops=flops, peak_share=total / (ms / 1e3) / BF16_FLOPS,
        peak_mem_gb=peak, max_abs_err=err, plain_absmax=scale,
        tol=SPATIAL_TOL,
        launches={k: v for k, v in counts.items() if v})


def e2e_spatial_phase(dev):
    """The mid block at full width (C 512, 32 groups) on a 16 x 16 latent,
    B 2, fp32: the kernel path against ``plain=True`` on the card, within
    E2E_TOL. Beside it, the plain path's own spread: its output moved by
    one fp32 ulp of noise on the input (``plain_ulp_noise``). JAX's init
    (weights N(0, 0.1^2) at fan-ins of 4608) amplifies each conv's input
    ~7x, so that spread is of the order of E2E_TOL."""
    C, G = SPATIAL["C"], SPATIAL["groups"]
    params = init_mid_block(torch.Generator(device=dev).manual_seed(13), C,
                            device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    x = torch.randn(2, 16, 16, C, generator=gen, device=dev)
    noisy = x * (1 + 2.0 ** -24 * torch.randn(x.shape, generator=gen,
                                               device=dev))
    with torch.no_grad():
        outs = [mid_block(x, params, G, plain=p) for p in (False, True)]
        floor = max_err(mid_block(noisy, params, G, plain=True), outs[1])
    if not bool(torch.isfinite(outs[0]).all()):
        raise AssertionError("e2e_spatial_parity: non-finite output")
    err = max_err(*outs)
    if not err <= E2E_TOL:
        raise AssertionError(f"e2e_spatial_parity: max abs error {err} > "
                             f"{E2E_TOL}")
    return dict(phase="e2e_spatial_parity", dtype="float32", B=2,
                latent=[16, 16], channels=C, groups=G, max_abs_err=err,
                tol=E2E_TOL, plain_ulp_noise=floor,
                out_absmax=float(outs[1].abs().max()))


def quantize_phase(dev):
    """``fake_quantize`` (int8, groups of 128) over every weight leaf of
    OPT-1.3B in bf16 (seeded), under autograd: exactly one quantize launch
    per leaf (counts zeroed just before, read just after), the gradient
    equal to the upstream one bit for bit, |deq - w| <= scale / 2 plus one
    bf16 ulp of deq. Then ``quantize_symmetric`` at int4 over the same
    leaves, bit-equal to its plain version (not counted)."""
    cfg = transformer_config("opt-1.3b", dtype=torch.bfloat16,
                             max_seq_len=SPARSE_S)
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    leaves = list(tree_leaves(init_params(gen, cfg)))
    grads = [torch.randn(w.shape, generator=gen, device=dev,
                         dtype=w.dtype) for w in leaves]
    for w in leaves:
        w.requires_grad_(True)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    outs = []
    for w, g in zip(leaves, grads):
        y = fake_quantize(w, 8, 128)
        y.backward(g)
        outs.append(y.detach())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    want = {name: len(leaves) if name == "quantize_symmetric" else 0
            for name in counts}
    if counts != want:
        raise AssertionError(f"quantize: launches {counts}, expected {want}")
    worst = 0.0       # max over elements of |deq - w| / (scale / 2 + ulp)
    for w, g, y in zip(leaves, grads, outs):
        if not torch.equal(w.grad, g):
            raise AssertionError("quantize: the gradient is not the "
                                 "upstream gradient")
        flat = w.detach().reshape(-1)
        pad = (-flat.numel()) % 128
        _, s = reference_quantize_symmetric(
            torch.nn.functional.pad(flat, (0, pad)), 8, 128)
        s = s.repeat_interleave(128)[:flat.numel()]
        yf = y.reshape(-1).float()
        ulp = torch.ldexp(torch.ones_like(yf), torch.frexp(yf).exponent - 8)
        worst = max(worst, float(((yf - flat.float()).abs()
                                  / (s / 2 + ulp)).max()))
        if not worst <= 1:
            raise AssertionError(f"quantize: |deq - w| reaches {worst} x "
                                 "(scale / 2 + one bf16 ulp)")
    int4_mismatch = 0
    for w in leaves:
        flat = w.detach().reshape(-1)
        flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % 128))
        a, b = quantize_symmetric(flat, 4, 128), \
            reference_quantize_symmetric(flat, 4, 128)
        int4_mismatch += int((a[0] != b[0]).sum()) + int((a[1] != b[1]).sum())
    if int4_mismatch:
        raise AssertionError(f"quantize: int4 differs from its plain version "
                             f"in {int4_mismatch} values")
    n = sum(w.numel() for w in leaves)
    return counts, dict(
        phase="quantize", model="opt-1.3b", dtype="bfloat16", bits=8,
        group=128, leaves=len(leaves), elements=n,
        fake_quantize_ms=wall * 1e3, launches=counts["quantize_symmetric"],
        worst_err_over_bound=worst, int4_bit_equal=True)


# ---------------------------------------------------------------------------
# Mixture-of-Experts: moe-gpt-350m-8e trained, generated and served at full
# width, and 2-layer fp32 parity
# ---------------------------------------------------------------------------


MOE_PRESET = "moe-gpt-350m-8e"
# (H, layers, heads, D, FFN, vocab, experts, top-k)
MOE_WIDTHS = (1024, 24, 16, 64, 4096, 50257, 8, 2)
MOE_B, MOE_S, MOE_STEPS, MOE_ZERO3_STEPS = 4, 1024, 3, 2
# the train phase's configuration (bf16, AdamW lr 1e-4, gas 1) at a stage
MOE_CONFIG = TRAIN_CONFIG
# the MoE train path's launches a step: the flash forward and backward once
# a layer, two norms a layer and the final one, one Adam launch; gating,
# dispatch, combine and the expert GEMMs are PyTorch, as JAX's are jnp
MOE_TRAIN_KERNELS = {"flash_attention": 24, "flash_attention_bwd": 24,
                     "fused_layer_norm": 49, "fused_adam": 1}


def check_moe_widths(cfg) -> None:
    if (cfg.hidden_size, cfg.num_layers, cfg.num_heads, cfg.head_dim,
            cfg.ffn_hidden_size, cfg.vocab_size, cfg.moe_num_experts,
            cfg.moe_top_k) != MOE_WIDTHS:
        raise AssertionError(f"{MOE_PRESET} widths changed: {cfg}")


def moe_active_params(cfg) -> int:
    """Parameters one token's forward reads: the embeddings, final norm,
    and per layer attention, norms, router and top-k experts' banks."""
    H, F_, E, k = (cfg.hidden_size, cfg.ffn_hidden_size,
                   cfg.moe_num_experts, cfg.moe_top_k)
    layer = 4 * H * H + 4 * H + 4 * H + H * E + k * 2 * H * F_
    return (cfg.vocab_size * H + cfg.max_seq_len * H + 2 * H
            + cfg.num_layers * layer)


def routing_stats(log) -> dict:
    """``parallel.moe.PLAN_LOG``'s entries of one forward (one a layer):
    the capacity, the share of top-k assignments dropped, the least and
    most tokens an expert kept in any layer, and the aux loss (mean over the
    layers; 1 is a perfect balance)."""
    kept = sum(float(e["kept"]) for e in log)
    assigned = sum(e["assigned"] for e in log)
    loads = torch.stack([e["expert_load"] for e in log])
    return dict(capacity=log[0]["capacity"], layers=len(log),
                assignments=assigned, dropped_share=1.0 - kept / assigned,
                expert_load_min=float(loads.min()),
                expert_load_max=float(loads.max()),
                aux_loss_mean=float(torch.stack(
                    [e["aux_loss"] for e in log]).mean()))


def make_moe_trainer(dev, stage: int):
    """moe-gpt-350m-8e at full width (bf16, seeded random weights) under
    the train configuration at ZeRO ``stage``, and one fixed seeded (1, B,
    S) token batch on the card. Returns (engine, batch, seconds
    ``initialize`` took)."""
    model = create_model(MOE_PRESET, dtype=torch.bfloat16,
                         max_seq_len=MOE_S)
    check_moe_widths(model.config)
    t0 = time.perf_counter()
    engine, *_ = initialize(model=model, config=dict(
        MOE_CONFIG, zero_optimization={"stage": stage}))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    ids = torch.randint(0, model.config.vocab_size, (1, MOE_B, MOE_S),
                        generator=gen, device=dev)
    return engine, {"input_ids": ids}, init_s


def moe_steps(engine, batch, steps: int, phase: str):
    """``steps`` timed ``train_batch`` calls with the launch counts zeroed
    just before and held exactly to MOE_TRAIN_KERNELS. Returns (losses as
    tensors, wall seconds, counts)."""
    reset_launch_counts()
    t0 = time.perf_counter()
    losses = [engine.train_batch(batch=batch) for _ in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    got = {name: counts[name] for name in MOE_TRAIN_KERNELS}
    want = {name: per * steps for name, per in MOE_TRAIN_KERNELS.items()}
    if got != want:
        raise AssertionError(f"{phase}: launches {got}, expected {want}")
    return losses, wall, counts


def moe_train_phase(dev, bound):
    """moe-gpt-350m-8e at stage 0: a warm-up step (routing statistics
    recorded), MOE_STEPS timed steps, losses finite and falling; then a
    repeat of stage 0 and MOE_ZERO3_STEPS steps at stage 3 from the same
    weights and batch in the world-1 group. Stage 3's losses are held to
    stage 0's within the zero phase's ``bound``, or within the zero phase's
    rule applied to this model (ZERO_SPREAD_FACTOR times the repeat's
    spread) where that is larger: a token whose top-2 gates nearly tie
    moves to another expert when the flash backward's dq sums in another
    order, so MoE's losses spread more from run to run than OPT-1.3B's.
    Returns (the timed steps' counts, the phase's JSON)."""
    engine, batch, init_s = make_moe_trainer(dev, 0)
    cfg = engine.model.config
    groups = engine.moe_groups
    if groups is None or (groups.world, groups.ep) != (1, 1):
        raise AssertionError(f"moe_train: the engine's MoE groups are "
                             f"{groups}, not world 1 at ep 1")
    moe.PLAN_LOG = []
    t0 = time.perf_counter()
    try:
        losses = [engine.train_batch(batch=batch)]
        torch.cuda.synchronize()
    finally:
        log, moe.PLAN_LOG = moe.PLAN_LOG, None
    warm_s = time.perf_counter() - t0
    routing = routing_stats(log)
    torch.cuda.reset_peak_memory_stats()
    timed, wall, counts = moe_steps(engine, batch, MOE_STEPS, "moe_train")
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses + timed]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"moe_train: losses {losses} not finite and "
                             "falling")
    n_params = param_count(engine.params)
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    def rel_err(other):
        return max(abs(a - b) / abs(b) for a, b in zip(other, losses))

    engine, batch, _ = make_moe_trainer(dev, 0)
    repeat = [float(engine.train_batch(batch=batch))
              for _ in range(MOE_ZERO3_STEPS)]
    spread = rel_err(repeat)
    moe_bound = max(bound, ZERO_SPREAD_FACTOR * spread)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    engine, batch, init3_s = make_moe_trainer(dev, 3)
    torch.cuda.reset_peak_memory_stats()
    z3, wall3, c3 = moe_steps(engine, batch, MOE_ZERO3_STEPS,
                              "moe_train stage 3")
    peak3 = torch.cuda.max_memory_allocated()
    z3 = [float(x) for x in z3]
    rel = rel_err(z3)
    if not all(np.isfinite(z3)) or not rel <= moe_bound:
        raise AssertionError(f"moe_train stage 3: losses {z3} against stage"
                             f" 0's {losses[:len(z3)]}: {rel} above "
                             f"{moe_bound}")
    units = engine.zero.peak_live
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    for name, n in c3.items():
        counts[name] = counts.get(name, 0) + n
    active = moe_active_params(cfg)
    L, H, S = cfg.num_layers, cfg.hidden_size, MOE_S
    tokens = MOE_B * S
    step_s = wall / MOE_STEPS
    flops = (6 * active + 12 * L * H * S) * tokens
    return counts, dict(
        phase="moe_train", model=MOE_PRESET, dtype="bfloat16",
        config=MOE_CONFIG, batch=[MOE_B, S], params=n_params,
        moe_groups=dict(world=groups.world, ep=groups.ep),
        active_params=active, init_s=init_s, warmup_s=warm_s,
        steps=MOE_STEPS, losses=losses, step_ms=step_s * 1e3,
        tokens_per_s=tokens / step_s, mfu_active=flops / step_s / BF16_FLOPS,
        peak_mem_gb=peak / 1e9, routing_warmup_step=routing,
        launches={n: counts[n] for n in MOE_TRAIN_KERNELS},
        stage3=dict(init_s=init3_s, steps=MOE_ZERO3_STEPS, losses=z3,
                    loss_rel_err=rel, zero_bound=bound,
                    stage0_repeat=repeat, stage0_repeat_spread=spread,
                    bound=moe_bound,
                    offload_bound=max(moe_bound, ZERO_SPREAD_FACTOR * rel),
                    step_ms=wall3 / MOE_ZERO3_STEPS * 1e3,
                    peak_mem_gb=peak3 / 1e9, gather_units_peak=units))


# moe_param_offload: the tiers in order, one layer a block (24 blocks), a
# warm-up step then this many timed ones a tier
MOE_PARAM_OFFLOAD_TIERS = ("nvme", "cpu")
MOE_PARAM_OFFLOAD_STEPS = 2


def moe_param_offload_run(dev, tier: str, root: str, stage3):
    """moe-gpt-350m-8e at full width and depth under ``offload_param`` on
    ``tier`` (bf16, the train configuration's AdamW, ZeRO 3, one layer a
    block, the moe_train batch, gas 1: the fused path). The streamed init
    draws the resident engine's weights, so its first MOE_ZERO3_STEPS
    losses are held to moe_train's stage-3 losses (``stage3``: its JSON)
    within its ``offload_bound``: ZERO_SPREAD_FACTOR times the larger of
    moe_train's two samples of MoE's run-to-run spread (its stage-0
    repeat's and stage 3's against stage 0; the flash backward's dq sums
    in another order each run and near-tied top-2 gates flip), at least
    the stage-3 bound. A warm-up step records the routing (one plan a layer:
    the backward's recompute is not logged), then MOE_PARAM_OFFLOAD_STEPS
    timed steps with exact launches (``param_offload_launches``: #16 once
    a block and once for the resident part)."""
    model = create_model(MOE_PRESET, dtype=torch.bfloat16,
                         max_seq_len=MOE_S)
    cfg = model.config
    check_moe_widths(cfg)
    block, _ = offload_numels(MOE_PRESET)
    config = dict(MOE_CONFIG, zero_optimization={
        "stage": 3, "offload_param": {
            "device": tier, "nvme_path": os.path.join(root, tier),
            "buffer_size": block * 2}},
        aio={"thread_count": 4, "queue_depth": 8})
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = initialize(model=model, config=config)[0]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    ex = engine._param_offload
    if ex.num_blocks != cfg.num_layers:
        raise AssertionError(f"moe_param_offload {tier}: {ex.num_blocks} "
                             f"blocks, not one a layer")
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    batch = {"input_ids": torch.randint(0, cfg.vocab_size, (1, MOE_B, MOE_S),
                                        generator=gen, device=dev)}
    moe.PLAN_LOG = []
    t0 = time.perf_counter()
    try:
        losses = [float(engine.train_batch(batch=batch))]
    finally:
        log, moe.PLAN_LOG = moe.PLAN_LOG, None
    warm_s = time.perf_counter() - t0
    if len(log) != cfg.num_layers:
        raise AssertionError(f"moe_param_offload {tier}: {len(log)} plans "
                             f"logged in a step of {cfg.num_layers} layers")
    routing = routing_stats(log)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    steps = []
    for _ in range(MOE_PARAM_OFFLOAD_STEPS):
        losses.append(float(engine.train_batch(batch=batch)))
        st = dict(ex.last_step_stats)
        steps.append(dict(
            step_s=st["wall_s"], forward_s=st["forward_s"],
            backward_recompute_s=st["backward_s"],
            block_updates_s=st["update_s"],
            device_busy_s=st["device_busy_s"],
            host_copy_s=st["host_copy_s"], fetch_wait_s=st["fetch_wait_s"],
            h2d_gb=st["h2d_bytes"] / 1e9, d2h_gb=st["d2h_bytes"] / 1e9,
            disk_read_gb=st["read_bytes"] / 1e9,
            disk_written_gb=st["write_bytes"] / 1e9))
    counts = launch_counts()
    want = {k: n * MOE_PARAM_OFFLOAD_STEPS for k, n in
            param_offload_launches(tier, cfg.num_layers, ex.num_blocks,
                                   1).items()}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"moe_param_offload {tier}: launches {got}, "
                             f"expected {want}")
    ref = stage3["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
    if (not all(np.isfinite(losses)) or not losses[-1] < losses[0]
            or not rel <= stage3["offload_bound"]):
        raise AssertionError(
            f"moe_param_offload {tier}: losses {losses} (the resident "
            f"stage 3's {ref}, bound {stage3['offload_bound']}) not finite, "
            "falling and within the bound")
    if ex.peak_live > 2:
        raise AssertionError(f"moe_param_offload {tier}: {ex.peak_live} "
                             "blocks on the card at once")
    peak = torch.cuda.max_memory_allocated()
    rss, hwm = host_memory_gb()
    step_s = sum(x["step_s"] for x in steps) / len(steps)
    out = dict(tier=tier, blocks=ex.num_blocks, params=ex.n_params,
               init_s=init_s, warmup_s=warm_s, losses=losses,
               resident_stage3_losses=ref, loss_rel_err=rel,
               bound=stage3["offload_bound"], steps=steps, step_s=step_s,
               tokens_per_s=MOE_B * MOE_S / step_s,
               host_state_gb=sum(ex.block_numel) * 12 / 1e9,
               init_peak_mem_gb=init_peak / 1e9, peak_mem_gb=peak / 1e9,
               resident_stage3_peak_mem_gb=stage3["peak_mem_gb"],
               peak_live_blocks=ex.peak_live, host_rss_gb=rss,
               host_peak_rss_gb=hwm, routing_warmup_step=routing,
               launches=got)
    ex.close(remove=True)
    del engine, ex
    gc.collect()
    torch.cuda.empty_cache()
    return counts, out


def moe_param_offload_phase(dev, stage3):
    """``moe_param_offload_run`` on each of MOE_PARAM_OFFLOAD_TIERS, the
    nvme tier's block files on the largest local disk. Returns the timed
    steps' launches and the phase's JSON."""
    root = tempfile.mkdtemp(prefix="moe-param-offload-", dir=largest_disk())
    counts, runs = {}, []
    try:
        for tier in MOE_PARAM_OFFLOAD_TIERS:
            c, run = moe_param_offload_run(dev, tier, root, stage3)
            runs.append(run)
            for name, n in c.items():
                counts[name] = counts.get(name, 0) + n
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return counts, dict(phase="moe_param_offload", model=MOE_PRESET,
                        dtype="bfloat16", batch=[MOE_B, MOE_S],
                        config=MOE_CONFIG["optimizer"], runs=runs,
                        reads="the page cache may hold them (warm)")


# moe_optim: steps a run on one batch, all counted and timed
MOE_OPTIM_STEPS = 3
MOE_LAMB = {"type": "lamb", "params": {"lr": 1e-4}}
# (name, the config's changes, launches a step)
MOE_OPTIM_RUNS = (
    ("offload_cpu_stage1",
     dict(zero_optimization={"stage": 1,
                             "sub_group_size": OFFLOAD_SUB_GROUP,
                             "offload_optimizer": {"device": "cpu"}}),
     dict(MOE_TRAIN_KERNELS, fused_adam=0)),
    ("lamb_stage0", dict(optimizer=MOE_LAMB, zero_optimization={"stage": 0}),
     dict(MOE_TRAIN_KERNELS, fused_adam=0, fused_lamb=1)),
    ("lamb_stage2", dict(optimizer=MOE_LAMB, zero_optimization={"stage": 2}),
     dict(MOE_TRAIN_KERNELS, fused_adam=0, fused_lamb=1)),
    ("onebitadam_stage0",
     dict(optimizer={"type": "onebitadam",
                     "params": {"lr": 1e-4, "freeze_step": 1}},
          zero_optimization={"stage": 0}),
     MOE_TRAIN_KERNELS))


def moe_optim_phase(dev):
    """moe-gpt-350m-8e at full width and depth, the moe_train batch, under
    the optimizers and state tiers MoE trains with beyond AdamW on the
    card (MOE_OPTIM_RUNS): host-memory optimizer offload at ZeRO 1 (the
    host update over 1.76 B elements), LAMB at ZeRO 0 and 2 (#17 once a
    step), onebitadam at ZeRO 0 past its freeze step (its exchange
    compressed from the second step). MOE_OPTIM_STEPS steps each, launch
    counts zeroed before the first and held exactly after the last; losses
    finite and falling. Prints step ms, peak memory and host RSS."""
    counts, runs = {}, {}
    for name, change, kernels in MOE_OPTIM_RUNS:
        model = create_model(MOE_PRESET, dtype=torch.bfloat16,
                             max_seq_len=MOE_S)
        check_moe_widths(model.config)
        t0 = time.perf_counter()
        engine = initialize(model=model, config=dict(MOE_CONFIG, **change))[0]
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        gen = torch.Generator(device=dev)
        gen.manual_seed(9)
        batch = {"input_ids": torch.randint(
            0, model.config.vocab_size, (1, MOE_B, MOE_S), generator=gen,
            device=dev)}
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        losses, secs, kinds = [], [], []
        for _ in range(MOE_OPTIM_STEPS):
            ob = engine._onebit
            if ob is not None:
                kinds.append("dense" if engine.opt_state.count < ob["freeze"]
                             else "compressed")
            t0 = time.perf_counter()
            losses.append(float(engine.train_batch(batch=batch)))
            secs.append(time.perf_counter() - t0)
        c = launch_counts()
        got = {k: c[k] for k in kernels}
        want = {k: n * MOE_OPTIM_STEPS for k, n in kernels.items()}
        if got != want:
            raise AssertionError(f"moe_optim {name}: launches {got}, "
                                 f"expected {want}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"moe_optim {name}: losses {losses} not "
                                 "finite and falling")
        if ob is not None and "compressed" not in kinds:
            raise AssertionError(f"moe_optim {name}: no compressed step "
                                 f"({kinds})")
        for k, n in got.items():
            counts[k] = counts.get(k, 0) + n
        rss, hwm = host_memory_gb()
        st = engine.opt_state
        runs[name] = dict(
            config=change, init_s=init_s, losses=losses,
            step_ms=[x * 1e3 for x in secs],
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            host_rss_gb=rss, host_peak_rss_gb=hwm, launches=got,
            exchange=kinds or None,
            host_update=(dict(st.offload.stats) if st.offload is not None
                         else None))
        del engine, st
        gc.collect()
        torch.cuda.empty_cache()
    return counts, dict(phase="moe_optim", model=MOE_PRESET,
                        dtype="bfloat16", batch=[MOE_B, MOE_S],
                        steps=MOE_OPTIM_STEPS, runs=runs)


def moe_generate_phase(dev):
    """``init_inference("moe-gpt-350m-8e")`` in bf16, then in int8 over the
    same weights: two ``generate`` calls each on GEN_LENS' 8 right-padded
    prompts, GEN_NEW greedy tokens. The first call of each mode: launch
    counts zeroed before and read after, the generate kernels run, int8's
    GEMM exactly 4 x layers x (GEN_NEW - 1) times (the attention sites of
    every decode forward; the expert banks stay dense, the head is tied).
    Returns (the counts of both first calls, the phase's JSON, the bf16
    engine)."""
    t0 = time.perf_counter()
    eng = init_inference(MOE_PRESET, dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = eng.model.config
    check_moe_widths(cfg)
    V = cfg.vocab_size
    ids, mask = generate_prompts(V)
    counts, modes, tokens = {}, {}, {}
    for mode in ("bf16", "int8"):
        if mode == "int8":
            t0 = time.perf_counter()
            qeng = init_inference(MOE_PRESET, dtype="int8",
                                  params=eng.params)
            torch.cuda.synchronize()
            q_init = time.perf_counter() - t0
        run = eng if mode == "bf16" else qeng
        torch.cuda.reset_peak_memory_stats()
        calls = []
        for i in range(2):
            toks, ttft, wall, c = generate_call(run, ids, mask)
            if toks.shape != (len(GEN_LENS), GEN_NEW) or not (
                    (toks >= 0) & (toks < V)).all():
                raise AssertionError(f"moe_generate {mode}: bad tokens "
                                     f"{toks}")
            if i == 0:
                tokens[mode] = toks
                for name in GENERATE_KERNELS:
                    if c[name] <= 0:
                        raise AssertionError(f"moe_generate {mode}: kernel "
                                             f"{name} never launched")
                want = 4 * cfg.num_layers * (GEN_NEW - 1) \
                    if mode == "int8" else 0
                for name in QUANT_MODES.values():
                    if c[name] != (want if name == "int8_matmul" else 0):
                        raise AssertionError(
                            f"moe_generate {mode}: {name} launched "
                            f"{c[name]} times, expected "
                            f"{want if name == 'int8_matmul' else 0}")
                for name, n in c.items():
                    counts[name] = counts.get(name, 0) + n
            calls.append(dict(
                ttft_ms=ttft * 1e3, wall_s=wall,
                decode_tokens_per_s=len(GEN_LENS) * (GEN_NEW - 1)
                / (wall - ttft),
                launches={n: c[n] for n in GENERATE_KERNELS
                          + ("int8_matmul",)}))
        modes[mode] = dict(calls=calls,
                           peak_mem_gb=torch.cuda.max_memory_allocated()
                           / 1e9)
        if mode == "int8":
            modes[mode].update(init_s=q_init,
                               weight_gb=tree_bytes(qeng.params) / 1e9)
            del qeng, run
            gc.collect()
            torch.cuda.empty_cache()
    agree = float((tokens["bf16"] == tokens["int8"]).mean())
    return counts, dict(
        phase="moe_generate", model=MOE_PRESET, prompt_lens=GEN_LENS,
        new_tokens=GEN_NEW, init_s=init_s,
        weight_gb=tree_bytes(eng.params) / 1e9, modes=modes,
        bf16_int8_token_agreement=agree), eng


def moe_serve_phase(params):
    """``init_serving("moe-gpt-350m-8e")`` over the generate phase's bf16
    weights: the 8-request scenario (``serve_requests``), launch counts
    zeroed before it and read after; each of the serving path's kernels
    must have run and every token be in the vocabulary."""
    srv, init_s = make_server(torch.bfloat16, params, preset=MOE_PRESET)
    V = srv.engine.model.config.vocab_size
    reset_launch_counts()
    handles, prompts, steps, wall = serve_requests(srv)
    counts = launch_counts()
    outs = [h.result() for h in handles]
    for i, out in enumerate(outs):
        if len(out) != 32 or not ((out >= 0) & (out < V)).all():
            raise AssertionError(f"moe_serve: request {i} returned {out}")
    for name in SERVE_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"moe_serve: kernel {name} never launched")
    if srv.sched.prefix_hits < 1 or srv._cow_copies < 1:
        raise AssertionError("moe_serve: prefix cache / copy-on-write did "
                             "not run")
    ttft = [h.ttft_s * 1e3 for h in handles]
    tokens = sum(len(o) for o in outs)
    out = dict(
        phase="moe_serve", model=MOE_PRESET, dtype="bfloat16",
        prompt_lens=[len(p) for p in prompts], new_tokens=32,
        init_s=init_s, wall_s=wall, iterations=steps,
        prefill_chunks=srv.prefill_chunks_run, tokens=tokens,
        tokens_per_s=tokens / wall, ttft_ms=ttft,
        ttft_ms_median=float(np.median(ttft)),
        launches={n: counts[n] for n in SERVE_KERNELS},
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    srv.close()
    return counts, out


class RouterSpy:
    """Records the router logits of every gating call, in order, while
    active. The parity checks call the kernel path then the plain path on
    the same inputs, so the records come in blocks of 2 x layers: the
    kernel path's layers, then the plain path's."""

    def __init__(self, layers: int):
        self.layers, self.seen, self.saved = layers, [], None

    def __enter__(self):
        self.saved = moe.top1_plan, moe.top2_plan

        def wrap(real):
            def spy(logits, *a, **kw):
                self.seen.append(logits.detach().clone())
                return real(logits, *a, **kw)
            return spy

        moe.top1_plan, moe.top2_plan = (wrap(f) for f in self.saved)
        return self

    def __exit__(self, *exc):
        moe.top1_plan, moe.top2_plan = self.saved

    def guard(self, k: int, phase: str) -> dict:
        """Over each (kernel, plain) pair of a layer's calls: the smallest
        gap between consecutive ranks 1..k+1 of a token's gates on the
        plain path (the routing margin) and the largest difference of a
        gate between the two paths. A margin above twice that difference
        cannot route a token differently; raises otherwise."""
        L = self.layers
        if len(self.seen) % (2 * L):
            raise AssertionError(f"{phase}: {len(self.seen)} gating calls, "
                                 f"not pairs of {L} layers")
        margin, drift = float("inf"), 0.0
        for b in range(0, len(self.seen), 2 * L):
            for li in range(L):
                gk = torch.softmax(self.seen[b + li].float(), -1)
                gp = torch.softmax(self.seen[b + L + li].float(), -1)
                drift = max(drift, max_err(gk, gp))
                top = gp.sort(-1, descending=True).values
                margin = min(margin, float((top[:, :k]
                                            - top[:, 1:k + 1]).min()))
        if not margin > 2 * drift:
            raise AssertionError(
                f"{phase}: routing margin {margin} not above twice the "
                f"paths' gate difference {drift}: a near-tie could route a "
                "token to another expert on the two paths")
        self.seen = []
        return dict(min_margin=margin, max_gate_diff=drift)


def e2e_moe_phase(dev):
    """moe-gpt-350m-8e's widths at 2 layers, fp32: the kernel path against
    ``plain=True``: cache-less logits (B 2 x S 256, right-padded; capacity
    drops on), dense-arena prefill and decode (``dense_parity``) and paged
    prefill and decode (``paged_parity``; C = T), each with its routing
    margin guarded (``RouterSpy``); then ``train_parity`` (3 AdamW steps)."""
    cfg = transformer_config(MOE_PRESET, dtype=torch.float32, num_layers=2,
                             max_seq_len=1024)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    params = init_params(gen, cfg)
    k = cfg.moe_top_k
    ids = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen,
                        device=dev)
    mask = torch.ones(2, 256, dtype=torch.int32, device=dev)
    mask[1, 190:] = 0
    spy = RouterSpy(cfg.num_layers)
    with spy:
        outs = [fn(params, ids, cfg, attention_mask=mask)[0]
                for fn in (forward, plain_forward)]
        cacheless = max_err(outs[0], outs[1])
        margins = {"cacheless": spy.guard(k, "e2e_moe cache-less")}
        if not cacheless <= E2E_TOL:
            raise AssertionError(f"e2e_moe: cache-less logits max abs error"
                                 f" {cacheless} > {E2E_TOL}")
        dense, _ = dense_parity(params, cfg, dev, gen, "e2e_moe dense")
        margins["dense"] = spy.guard(k, "e2e_moe dense")
        paged, _ = paged_parity(params, cfg, dev, gen, "e2e_moe paged")
        margins["paged"] = spy.guard(k, "e2e_moe paged")
    del params, outs
    model = create_model(MOE_PRESET, dtype=torch.float32, num_layers=2,
                         max_seq_len=256)
    tcfg = {"train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": 1, "steps_per_print": 1000,
            "gradient_clipping": 1.0,
            "optimizer": {"type": "adamw",
                          "params": {"lr": 1e-4, "weight_decay": 0.01}}}
    plain_opt = MixedPrecisionOptimizer(1e-4, grad_clip=1.0,
                                        weight_decay=0.01, plain=True)
    train = train_parity("e2e_moe", model, tcfg, plain_opt,
                         {"input_ids": ids, "attention_mask": mask},
                         preset=MOE_PRESET)
    return dict(phase="e2e_moe", model=MOE_PRESET, layers=2,
                dtype="float32", cacheless_max_abs_err=cacheless,
                dense_max_abs_err=max(dense), paged_max_abs_err=max(paged),
                tol=E2E_TOL, routing=margins,
                train={k_: v for k_, v in train.items() if k_ != "phase"})


def moe_phases(dev, smi, bound, train_only: bool = False):
    """moe_train (in the world-1 group main() opened), moe_param_offload,
    moe_optim, moe_generate, moe_serve and e2e_moe, each line with its
    seconds. Returns the launch counts of the main-path runs (moe_train's
    timed steps at both stages, moe_param_offload's timed steps of each
    tier, moe_optim's steps, the first generate call of each mode, the
    serve run). ``train_only``: the first three alone."""
    counts = {}

    def add(c):
        for name, n in c.items():
            counts[name] = counts.get(name, 0) + n

    t0 = time.perf_counter()
    c, out = moe_train_phase(dev, bound)
    add(c)
    emit(dict(out, seconds=time.perf_counter() - t0, card=smi))
    stage3 = out["stage3"]
    for run, args in ((moe_param_offload_phase, (dev, stage3)),
                      (moe_optim_phase, (dev,))):
        t0 = time.perf_counter()
        c, out = run(*args)
        add(c)
        emit(dict(out, seconds=time.perf_counter() - t0, card=smi))
        gc.collect()
        torch.cuda.empty_cache()
    if train_only:
        return counts
    t0 = time.perf_counter()
    c, out, eng = moe_generate_phase(dev)
    add(c)
    emit(dict(out, seconds=time.perf_counter() - t0, card=smi))
    t0 = time.perf_counter()
    eng._arena.clear()
    c, out = moe_serve_phase(eng.params)
    add(c)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    emit(dict(out, seconds=time.perf_counter() - t0, card=smi))
    t0 = time.perf_counter()
    out = e2e_moe_phase(dev)
    emit(dict(out, seconds=time.perf_counter() - t0, card=smi))
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def new_phases(dev, smi, base_losses, bound):
    """The phases after ``checkpoint``, in the world-1 NCCL group:
    lamb_zero, onebit, offload_parity, offload, nvme, param_offload_parity,
    param_offload and comm_bench, each line with its seconds. Returns the
    launch counts of the main-path runs (lamb_zero's timed steps,
    offload's and param_offload's)."""
    counts = {}

    def timed(fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        c, out = res if isinstance(res, tuple) else ({}, res)
        for name, n in c.items():
            counts[name] = counts.get(name, 0) + n
        emit(dict(out, seconds=time.perf_counter() - t0, card=smi))
        gc.collect()
        torch.cuda.empty_cache()

    timed(lamb_zero_phase, dev, bound)
    timed(onebit_phase, dev, base_losses, bound)
    root = tempfile.mkdtemp(prefix="offload-", dir=largest_disk())
    try:
        timed(offload_parity_phase, dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    timed(offload_phase, dev)
    timed(nvme_phase, dev, base_losses, bound)
    root = tempfile.mkdtemp(prefix="param-parity-", dir=largest_disk())
    try:
        timed(param_offload_parity_phase, dev, root, bound)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    timed(param_offload_phase, dev)
    timed(comm_bench_phase, dev)
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — nothing was run",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit(dict(phase="device", nvidia_smi=smi,
              name=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda, python=sys.version.split()[0]))

    t0 = time.perf_counter()
    registry.build()
    for src in sorted(set(registry.KERNELS.values())):
        registry.library(src)
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              build_dir=str(registry.BUILD_ROOT)))

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases, seconds = {}, {}
    for group, run in (("fused_layer_norm", norm_cases),
                       ("paged_decode_attention", decode_cases),
                       ("paged_prefill_attention", prefill_cases),
                       ("flash_attention", flash_cases),
                       ("decode_attention", decode_dense_cases),
                       ("flash_attention_bwd", flash_bwd_cases),
                       ("fused_adam", adam_cases),
                       ("quant_matmul", quant_cases),
                       ("block_sparse_attention", sparse_cases),
                       ("fused_lamb", lamb_cases),
                       ("fused_group_norm", group_norm_cases),
                       ("quantize_symmetric", quantize_cases),
                       ("flash_attention_d512", flash_wide_cases)):
        t0 = time.perf_counter()
        res = run(dev, gen)
        cases.update(res if isinstance(res, dict) else {group: res})
        seconds[group] = time.perf_counter() - t0
    emit(dict(phase="kernels", card=smi, seconds=seconds, cases=cases))
    torch.cuda.empty_cache()

    counts, serve, srv = serve_phase()
    emit(dict(serve, card=smi))
    gen_counts, bf16_tokens, generate = generate_phase(srv)
    del srv
    emit(dict(generate, card=smi))
    gc.collect()                  # the llama-7b engine's last references
    torch.cuda.empty_cache()
    emit(dict(e2e_phase(dev), card=smi))
    emit(dict(e2e_generate_phase(dev), card=smi))
    quant_counts = quant_phases(smi, bf16_tokens)
    emit(dict(e2e_quant_phase(dev), card=smi))
    gc.collect()
    torch.cuda.empty_cache()
    train_counts, train = train_phase(dev, "train")
    emit(dict(train, card=smi))
    emit(dict(e2e_train_phase(dev), card=smi))
    gc.collect()
    torch.cuda.empty_cache()
    store = tempfile.mkdtemp(prefix="nccl-store-")
    comm.init_distributed(dev, init_method=f"file://{store}/store", rank=0,
                          world_size=1, timeout=600)
    try:
        zero_counts, zero = zero_phase(dev, train["losses"])
        emit(dict(zero, card=smi))
        bound = zero["loss_rtol"]
        emit(dict(checkpoint_phase(dev, bound), card=smi))
        new_counts = new_phases(dev, smi, train["losses"], bound)
        moe_counts = moe_phases(dev, smi, bound)
    finally:
        comm.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    sparse_counts, sparse_train = train_phase(dev, "sparse_train")
    emit(dict(sparse_train, card=smi))
    emit(dict(e2e_sparse_train_phase(dev), card=smi))
    gc.collect()
    torch.cuda.empty_cache()
    spatial_counts, spatial = spatial_phase(dev)
    emit(dict(spatial, card=smi))
    emit(dict(e2e_spatial_phase(dev), card=smi))
    quantize_counts, quantize = quantize_phase(dev)
    emit(dict(quantize, card=smi))

    # the main paths' shapes: norm at the prefill chunk's 256 rows (RMSNorm,
    # bf16), paged decode over the ragged 8 rows, paged prefill at start
    # 256, flash at generate's static prefill, dense decode over 8 rows, the
    # flash backward and Adam at OPT-1.3B's training shape, the quantized
    # GEMMs at the 8-row decode of llama-7b's gate / up site (int4: G 1),
    # the block-sparse kernels at sparse_train's Fixed layout and shape,
    # LAMB segmented over OPT-1.3B's leaves
    quant_main = lambda c: (c["site"] == "gate_up"  # noqa: E731
                            and c["M"] == 8 and c["G"] == 1)
    pick = {**{name: quant_main for name in QUANT_MODES.values()},
            "fused_layer_norm": lambda c: c["rows"] == 256 and c["rms"],
            "paged_decode_attention": lambda c: c["case"] == "serve8",
            "paged_prefill_attention": lambda c: (c["case"] == "chunk"
                                                  and c["start"] == 256),
            "flash_attention": lambda c: c["case"] == "prefill",
            "decode_attention": lambda c: c["case"] == "decode",
            "flash_attention_bwd": lambda c: c["case"] == "train",
            "fused_adam": lambda c: c["case"] == "train",
            "block_sparse_attention_fwd": lambda c: c["case"] == "fixed",
            "block_sparse_attention_bwd": lambda c: c["case"] == "fixed",
            "fused_lamb": lambda c: c["case"] == "opt-1.3b",
            "fused_group_norm": lambda c: c["case"] == "vae_mid",
            "quantize_symmetric": lambda c: (c["case"] == "opt-1.3b"
                                             and c["bits"] == 8)}
    # llama-7b's training shapes under offload (1 x 2048 tokens, 32 heads
    # of 128, H 4096), as the offload phase runs them
    llama_train = {
        "fused_layer_norm": lambda c: (c["rows"] == 2048 and c["H"] == 4096
                                       and c["rms"]),
        "flash_attention": lambda c: c["case"] == "llama_train",
        "flash_attention_bwd": lambda c: c["case"] == "llama_train"}
    # moe-gpt-350m-8e's training shapes (4 x 1024 tokens, 16 heads of 64,
    # H 1024, LayerNorm with bias, 1.76 B elements updated)
    moe_train = {
        "fused_layer_norm": lambda c: (c["rows"] == 4096 and c["H"] == 1024
                                       and not c["rms"]),
        "flash_attention": lambda c: c["case"] == "moe_train",
        "flash_attention_bwd": lambda c: c["case"] == "moe_train",
        "fused_adam": lambda c: c["case"] == "moe_train"}
    kernels = []
    for name, (source, replaces, kernel) in SOURCES.items():
        bf16 = [c for c in cases[name] if c["dtype"] == str(torch.bfloat16)]
        main_case = next(c for c in bf16 if pick[name](c))
        extra = {}
        if name in llama_train:
            c = next(c for c in bf16 if llama_train[name](c))
            extra["llama_train"] = {k: c.get(k) for k in (
                "plan", "kernel", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms")}
        if name in moe_train:
            c = next(c for c in bf16 if moe_train[name](c))
            extra["moe_train"] = {k: c.get(k) for k in (
                "plan", "kernel", "n", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms")}
        if name == "fused_adam":
            # parameter offload's two calls at llama-7b's sizes, and at
            # moe-gpt-350m-8e's (moe_param_offload)
            for key, prefix in (("param_offload", "offload_"),
                                ("moe_param_offload", "moe_offload_")):
                extra[key] = {c["case"]: {k: c[k] for k in (
                    "n", "grad_dtype", "grad_scale", "max_abs_err", "ms",
                    "plain_ms", "bound_ms", "bound_by", "library_ms")}
                    for c in cases[name] if c["case"].startswith(prefix)}
        if name == "fused_lamb":
            # moe_optim's launch over moe-gpt-350m-8e's leaves
            c = next(c for c in cases[name]
                     if c["case"] == "moe-gpt-350m-8e")
            extra["moe_optim"] = {k: c[k] for k in (
                "n", "segments", "max_abs_err", "ms", "plain_ms",
                "plain_pieces", "phase2_ms", "bound_ms", "bound_by",
                "library_ms")}
        kernels.append(dict(
            name=name, kernel=kernel, route="cuda", source=source,
            replaces=replaces,
            launches=(counts.get(name, 0) + gen_counts.get(name, 0)
                      + quant_counts.get(name, 0)
                      + train_counts.get(name, 0)
                      + zero_counts.get(name, 0)
                      + new_counts.get(name, 0)
                      + sparse_counts.get(name, 0)
                      + spatial_counts.get(name, 0)
                      + quantize_counts.get(name, 0)
                      + moe_counts.get(name, 0)),
            max_abs_err=max(c["max_abs_err"] for c in bf16),
            ms=main_case["ms"], plain_ms=main_case["plain_ms"],
            bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
            library_ms=main_case["library_ms"], **extra))
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
