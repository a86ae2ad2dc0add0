"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one (a CUDA kernel
has no CPU mode; the plain versions are held against the JAX package by
``test_torch_normalization.py`` and ``test_torch_paged_attention.py``).
Dense attention (``flash_attention``, ``decode_attention``) runs at small
shapes and at the shapes of llama-7b's ``generate`` (B 8, 32 heads, D 128,
a 1024-column arena), with alibi, GQA, ragged masks with holes, and arena
slots outside every mask holding large finite values. The training kernels
(the flash backward, one call for dq, dk and dv; fused Adam) run at small
shapes and at OPT-1.3B's training shape, and the norm and flash kernels under autograd
are held against autograd through their plain versions. The norm kernel runs at the
main paths' shapes (8, 1 and 256 rows of 4096, 4096 x 4096 RMSNorm, 4096 x
2048 LayerNorm with bias) and on rows of 8192 and 768, in bf16, fp16 and
fp32; each call is one launch of the kernel its route names, two calls and
other grids give equal bits, and fp32 rows of 300 + 0.01 N(0, 1) hold to a
float64 norm within 1e-2. The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Tolerances: fp32 2e-5 (the same fp32 arithmetic in another order); bf16
2e-2, fp16 4e-3 (norm) / 5e-3 (attention): one rounding of outputs of size
~1-4 in that type, plus the plain version's own low-precision
intermediates. The 16-bit flash backward adds twice one rounding of the
type times the sum of its terms' magnitudes (``BWD_ROUND``); fused Adam
1e-6 + 1e-5 relative (the same fp32 arithmetic, FMA-contracted). The
quantized decode GEMMs (int8 / int4, weight-only and a8) run at small shapes
and at llama-7b's decode sites against the same fp32 / bf16 tolerances (the
weight-only ones also in fp16, 5e-3); the
a8 ones must equal their plain versions bit for bit (exact integer sums, the
same fp32 epilogue, grouped int4's partials summed in the kernel's order),
and the three quantizers must
give the same q and scales on the card as on the CPU. The weight-only
tensor-core kernel is also held at its edges (1, 3, 5 and 8 rows, a single
ring stage of K 64 split over a cluster, a partial stage at K 392, partial
column tiles, int4 groups of 4..128 rows, some ending inside a 16-row
unit, a zero x row and weight column, a misaligned x), to equal bits in
two calls, to one launch of the kernel of x's dtype, and through an fp16
int8 / int4 engine. The
block-sparse kernels (the forward; the backward, one call for dq, dk and
dv) run over DeepSpeed's layouts and
over layouts with a key-less q-tile, padded list slots and asymmetric
per-head masks, causal and not, against their plain versions with the
flash tolerances; the LAMB phase-1 kernel against its plain version with
the Adam tolerances, over segments that start unaligned. The GroupNorm
kernels run at JAX's test shapes, the SD v1.5 VAE mid block's (B 4, HW
4096, C 512, 32 groups), the decoder's 512 x 512 up block (B 1, HW 262144,
C 128) and rows that do not divide the resident kernel's blocks, with the
norm tolerances; on 300 + 0.01 N(0, 1) against float64 within 1e-2 on
both routes; to equal bits in eager calls and across CUDA-graph replays,
on two streams at once; one device kernel a call on the resident route,
the stats and apply pair on the streaming one; group quantization must
equal its plain version bit for bit (q and scales); the flash forward at
head_dim 264..512 (self and cross attention, masks, alibi, GQA) within the
attention
tolerances. The flash forward's TMA / wgmma routes (16-bit, D 16..128 and
264..512) are also held with NaN in masked K / V rows, with key tiles past
the last query, with 4 query heads a KV head, and to bit-equal outputs in
two calls. The split-KV decode kernel is held at its edges: kv_len at a
tile or split edge and one past it, dead chunks between live ones, kv_len
0 and key-less rows, one long row (B 1, T 4096), 8 query heads a KV head
with alibi over key positions, rows that no tensor map takes (not a
multiple of 16 bytes), NaN in dead slots, and bit-equal repeats; each call
is one launch. The split-KV paged decode kernel likewise: rows of 0, 1, BS
and BS + 1 keys with splits left without a page, blocks of 8..64 rows, G
1 / 4 / 8 with alibi, one long row with NaN in the scratch block, the tail
of its last page and the pages after it, rows that no tensor map takes,
bit-equal repeats, one launch a call and no host sync. The tensor-core
prefill kernel likewise: chunks of 16..256 queries in one or several q
tiles, both work-tile plans, ragged starts and n_valid (0 too), G 1 / 4 /
8 with alibi, pages of 4..64 rows, D 16..128, NaN in the pages a row has
not written, bit-equal repeats, and one launch of the kernel its route
names.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.models.transformer import (_quantize_int8,
                                                    alibi_slopes)
from deepspeed_tpu_torch.ops import (decode_attention,
                                     flash_attention, flash_attention_bwd,
                                     flash_attention_bwd_magnitude,
                                     fused_adam_flat,
                                     fused_layer_norm, launch_counts,
                                     paged_decode_attention,
                                     paged_prefill_attention,
                                     reference_adam_flat,
                                     reference_decode_attention,
                                     reference_flash_attention,
                                     reference_flash_attention_bwd,
                                     reference_layer_norm,
                                     reference_paged_attention)
from deepspeed_tpu_torch.ops import (LambSegments, block_sparse_attention,
                                     block_sparse_attention_bwd,
                                     block_sparse_attention_bwd_magnitude,
                                     block_sparse_attention_fwd,
                                     build_tile_plan, lamb_phase1, lamb_step,
                                     reference_block_sparse_attention,
                                     reference_block_sparse_attention_bwd,
                                     reference_lamb_phase1)
from deepspeed_tpu_torch.ops import (fake_quantize, fused_group_norm,
                                     quantize_symmetric,
                                     reference_group_norm,
                                     reference_quantize_symmetric)
from deepspeed_tpu_torch.ops import quant_matmul, sparse_attention
from deepspeed_tpu_torch.ops.normalization import _launch as _ln_launch
from deepspeed_tpu_torch.ops.normalization import ln_plan
from deepspeed_tpu_torch.ops.paged_decode_attention import prefill_kernel
from deepspeed_tpu_torch.ops.spatial import gn_plan
from deepspeed_tpu_torch.ops.quant_matmul import quantize_int4

pytestmark = pytest.mark.cuda

LOW = [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def t(a, device, dtype=None):
    x = torch.from_numpy(np.array(a)).to(device)
    return x if dtype is None else x.to(dtype)


# ---------------------------------------------------------------------------
# fused_layer_norm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,H,rms,use_bias", [
    (5, 64, False, True), (130, 96, False, False), (7, 64, True, False),
    (257, 40, True, False), (1, 72, False, True), (3, 4099, False, True),
    (8, 4096, True, False), (256, 4096, True, False),
    (1, 4096, True, False), (4096, 4096, True, False),
    (4096, 2048, False, True), (8, 8192, False, True),
    (300, 8192, True, False), (1, 768, False, True),
    (513, 768, False, False), (4096, 1024, False, True)])
@pytest.mark.parametrize("dtype,atol", LOW + [(torch.float16, 4e-3)])
def test_layer_norm_matches_plain(dev, rows, H, rms, use_bias, dtype, atol):
    rng = np.random.default_rng(rows * H)
    x = t(rng.normal(0, 2.0, (rows, H)) + rng.normal(0, 1.0, (1, H)), dev,
          dtype)
    scale = t(rng.normal(1.0, 0.3, (H,)), dev, dtype)
    bias = t(rng.normal(0, 0.3, (H,)), dev, dtype) if use_bias else None
    before = launch_counts()["fused_layer_norm"]
    got = fused_layer_norm(x, scale, bias, 1e-5, rms)
    torch.cuda.synchronize()
    assert launch_counts()["fused_layer_norm"] == before + 1
    ref = reference_layer_norm(x, scale, bias, 1e-5, rms)
    torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                               rtol=atol)


def test_layer_norm_unaligned_view_takes_scalar_path(dev):
    """A view starting mid-vector must not take the 16-byte path."""
    base = torch.randn(4 * 64 + 1, device=dev)
    x = base[1:].view(4, 64)
    scale = torch.rand(64, device=dev) + 0.5
    got = fused_layer_norm(x, scale, None, 1e-5, True)
    ref = reference_layer_norm(x, scale, None, 1e-5, True)
    torch.testing.assert_close(got, ref, atol=2e-5, rtol=2e-5)


def test_layer_norm_rejects_mismatched_scale(dev):
    x = torch.randn(4, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fused_layer_norm(x, torch.ones(64, device=dev), None, 1e-5, True)


def norm_operands(dev, rows, H, dtype, use_bias, seed):
    rng = np.random.default_rng(seed)
    x = t(rng.normal(0, 2.0, (rows, H)), dev, dtype)
    scale = t(rng.normal(1.0, 0.3, (H,)), dev, dtype)
    bias = t(rng.normal(0, 0.3, (H,)), dev, dtype) if use_bias else None
    return x, scale, bias


ROUTE_SHAPES = [(1, 768), (8, 4096), (256, 4096), (4096, 4096), (4096, 2048),
                (8, 8192), (2000, 8192), (3, 4099)]
ROUTE_PROFILE = """
import json, sys
import torch
from deepspeed_tpu_torch.ops import fused_layer_norm
dev, dtype = torch.device("cuda"), getattr(torch, sys.argv[1])
operands = [(torch.randn(rows, H, device=dev).to(dtype),
             (torch.rand(H, device=dev) + 0.5).to(dtype))
            for rows, H in json.loads(sys.argv[2])]
for x, scale in operands:
    fused_layer_norm(x, scale, None, 1e-5, True)         # build and bind
torch.cuda.synchronize()
with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    for x, scale in operands:
        fused_layer_norm(x, scale, None, 1e-5, True)
    torch.cuda.synchronize()
print(json.dumps([e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]))
"""


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_layer_norm_launches_its_route(dev, dtype):
    """One device kernel a call: ``ln_rows_kernel`` for aligned rows whose
    H is a multiple of 16 bytes (H 768..8192 here, both plan regimes),
    ``ln_scalar_kernel`` for the others. Profiled in a process of its own:
    on the card, a profiler session early in this process left later ones
    (``test_prefill_launches_its_route``) without device events."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = subprocess.run(
        [sys.executable, "-c", ROUTE_PROFILE, str(dtype).split(".")[1],
         json.dumps(ROUTE_SHAPES)], cwd=root, env=env, capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    names = json.loads(out.stdout.strip().splitlines()[-1])
    item = torch.tensor([], dtype=dtype).element_size()
    want = ["ln_scalar_kernel" if H % (16 // item) else "ln_rows_kernel"
            for _, H in ROUTE_SHAPES]
    assert len(names) == len(want), names
    assert all(w in n for w, n in zip(want, names)), names


@pytest.mark.parametrize("rows,H,rms,dtype", [
    (8, 4096, True, torch.bfloat16), (1, 4096, True, torch.float16),
    (256, 4096, True, torch.bfloat16), (4096, 4096, True, torch.bfloat16),
    (4096, 2048, False, torch.bfloat16), (8, 8192, False, torch.float32),
    (3000, 8192, False, torch.float32), (3, 4099, False, torch.float32)])
def test_layer_norm_repeatable(dev, rows, H, rms, dtype):
    """Two calls give equal bits in each plan regime (few rows, many rows,
    the scalar kernel), and the rows kernel's bits do not depend on its
    grid: the plan's own, one block, three, and twice the plan's."""
    x, scale, bias = norm_operands(dev, rows, H, dtype, not rms, 2)
    a = fused_layer_norm(x, scale, bias, 1e-5, rms)
    b = fused_layer_norm(x, scale, bias, 1e-5, rms)
    assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    plan = ln_plan(rows, H, x.element_size(),
                   torch.cuda.get_device_properties(dev).multi_processor_count)
    if plan.vectors:
        for blocks in (1, 3, 2 * plan.blocks):
            c = _ln_launch(x, scale, bias, 1e-5, rms,
                           plan._replace(blocks=blocks))
            assert torch.equal(a.view(torch.uint8), c.view(torch.uint8))


@pytest.mark.parametrize("rows,H,use_bias", [
    (8, 4096, False), (256, 4096, True), (4096, 4096, False),
    (4096, 2048, True), (5, 8192, True), (3, 4099, False)])
def test_layer_norm_offset_rows_against_float64(dev, rows, H, use_bias):
    """fp32 rows of 300 + 0.01 N(0, 1), where a one-pass variance cancels:
    within 1e-2 of a float64 norm (an fp32 mean near 300 is off by an ulp
    or two, 3e-5 each, which 1 / std = 100 scales to ~3e-3 each)."""
    rng = np.random.default_rng(rows + H)
    x = t(300.0 + 0.01 * rng.normal(size=(rows, H)), dev, torch.float32)
    scale = t(rng.normal(1.0, 0.1, H), dev, torch.float32)
    bias = t(rng.normal(0, 0.1, H), dev, torch.float32) if use_bias \
        else None
    got = fused_layer_norm(x, scale, bias, 1e-5, False)
    x64 = x.double()
    xc = x64 - x64.mean(-1, keepdim=True)
    want = xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + 1e-5) \
        * scale.double()
    if bias is not None:
        want = want + bias.double()
    err = float((got.double() - want).abs().max())
    assert err < 1e-2, err


# ---------------------------------------------------------------------------
# paged attention
# ---------------------------------------------------------------------------

BS, MAXB, NB = 16, 4, 12
ATTN = LOW + [(torch.float16, 5e-3)]
# (n, k, D): GQA groups of 1..4 at the tiny head size, and D = 128 (the
# llama-7b head) where the 16-bit kernels take their vector / MMA paths
HEADS = [(4, 4, 32), (4, 2, 32), (8, 2, 32), (32, 8, 32), (8, 8, 128),
         (8, 2, 128)]


def pools(k, seed, D=32):
    rng = np.random.default_rng(seed)
    kp = rng.normal(size=(NB, BS, k, D)).astype(np.float32)
    vp = rng.normal(size=(NB, BS, k, D)).astype(np.float32)
    for p in (kp, vp):
        p[11] = np.nan             # in no table
        p[7, 5:] = np.nan          # row 0's last page past position 36
    return kp, vp


@pytest.mark.parametrize("n,k,D", HEADS + [(32, 32, 32)])
@pytest.mark.parametrize("use_alibi", [False, True])
@pytest.mark.parametrize("dtype,atol", ATTN)
def test_decode_matches_plain(dev, n, k, D, use_alibi, dtype, atol):
    kp, vp = pools(k, seed=0, D=D)
    bt = np.zeros((3, MAXB), np.int32)
    bt[0, :3] = [5, 1, 7]
    bt[2, :4] = [8, 2, 4, 6]
    lengths = np.array([BS * 2 + 5, 0, BS * 4], np.int32)   # row 1 inactive
    q = np.random.default_rng(7).normal(size=(3, n, D))
    al = alibi_slopes(n, device=dev) if use_alibi else None
    args = (t(q, dev, dtype), t(kp, dev, dtype), t(vp, dev, dtype),
            t(bt, dev), t(lengths, dev))
    before = launch_counts()["paged_decode_attention"]
    got = paged_decode_attention(*args, al)
    torch.cuda.synchronize()
    assert launch_counts()["paged_decode_attention"] == before + 1
    q3, kpt, vpt, btt, lt = args
    ref = reference_paged_attention(q3[:, None], kpt, vpt, btt,
                                    (lt.long() - 1)[:, None], al)[:, 0]
    assert torch.isfinite(got).all()
    assert (got[1] == 0).all()
    torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                               rtol=atol)


@pytest.mark.parametrize("n,k,D", HEADS)
@pytest.mark.parametrize("start,n_valid", [(0, 16), (21, 11), (32, 5)])
@pytest.mark.parametrize("use_alibi", [False, True])
@pytest.mark.parametrize("dtype,atol", ATTN)
def test_prefill_matches_plain(dev, n, k, D, start, n_valid, use_alibi,
                               dtype, atol):
    C = 16
    kp, vp = pools(k, seed=2, D=D)
    bt = np.array([[5, 1, 7, 9], [8, 2, 4, 6]], np.int32)
    q = np.random.default_rng(8).normal(size=(2, C, n, D))
    al = alibi_slopes(n, device=dev) if use_alibi else None
    starts = t(np.array([start, 3], np.int32), dev)
    valid = t(np.array([n_valid, C], np.int32), dev)
    args = (t(q, dev, dtype), t(kp, dev, dtype), t(vp, dev, dtype),
            t(bt, dev))
    before = launch_counts()["paged_prefill_attention"]
    got = paged_prefill_attention(*args, starts, al, n_valid=valid)
    torch.cuda.synchronize()
    assert launch_counts()["paged_prefill_attention"] == before + 1
    offs = torch.arange(C, device=dev)
    pos = torch.where(offs[None] < valid.long()[:, None],
                      starts.long()[:, None] + offs[None],
                      torch.full((2, C), -1, device=dev))
    ref = reference_paged_attention(*args, pos, al)
    assert torch.isfinite(got).all()
    assert (got[0, n_valid:] == 0).all()
    torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                               rtol=atol)


def test_paged_rejects_bad_operands(dev):
    kp = torch.zeros(4, 16, 2, 32, device=dev)
    q = torch.zeros(2, 4, 32, device=dev)
    bt = torch.zeros(2, 2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):      # int64 lengths
        paged_decode_attention(q, kp, kp, bt,
                               torch.ones(2, dtype=torch.int64, device=dev))
    with pytest.raises(ValueError):      # dtype mismatch
        paged_decode_attention(q.half(), kp, kp, bt,
                               torch.ones(2, dtype=torch.int32, device=dev))


def test_paged_rejects_misaligned_rows(dev):
    """The kernels read q/k/v rows as 16-byte vectors."""
    kp = torch.zeros(4, 16, 2, 32, device=dev)
    base = torch.zeros(2 * 4 * 32 + 1, device=dev)
    q = base[1:].view(2, 4, 32)
    bt = torch.zeros(2, 2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        paged_decode_attention(q, kp, kp, bt,
                               torch.ones(2, dtype=torch.int32, device=dev))


# The split-KV paged decode kernel's edges: rows of 0, 1, BS and BS + 1 keys
# and rows whose later splits get no page; blocks of 8, 16, 32 and 64 rows;
# 1, 4 and 8 query heads a KV head with alibi; one long row over 8 splits
# with NaN in the scratch block, the tail of its last page and the page
# after it; rows that no tensor map takes; bit-equal repeats; one launch a
# call and no host sync (the wrapper never reads ``lengths``).
def paged_case(dev, lengths, BS, MAXB, n, k, D, dtype, seed, nan=True,
               stale=False):
    """Pools, table and q for rows of ``lengths``: each row's pages drawn
    from a shuffled pool, unfilled entries 0 (scratch) or, with ``stale``,
    pages no row reaches (a recycled table); with ``nan`` the scratch
    block, every page no row reaches and the tail of each row's last page
    hold NaN."""
    R = len(lengths)
    rng = np.random.default_rng(seed)
    NB = R * MAXB + 2
    kp = rng.normal(size=(NB, BS, k, D)).astype(np.float32)
    vp = rng.normal(size=(NB, BS, k, D)).astype(np.float32)
    bt = np.zeros((R, MAXB), np.int32)
    perm = rng.permutation(np.arange(1, NB))
    used = set()
    for r, length in enumerate(lengths):
        npages = -(-min(length, MAXB * BS) // BS)
        bt[r, :npages] = perm[r * MAXB:r * MAXB + npages]
        if stale:
            bt[r, npages:] = perm[r * MAXB + npages:(r + 1) * MAXB]
        used.update(bt[r, :npages].tolist())
        if nan and npages and length < npages * BS:
            for p in (kp, vp):
                p[bt[r, npages - 1], length % BS:] = np.nan
    if nan:
        for p in (kp, vp):
            p[0] = np.nan
            p[[b for b in range(1, NB) if b not in used]] = np.nan
    q = rng.normal(size=(R, n, D))
    return (t(q, dev, dtype), t(kp, dev, dtype), t(vp, dev, dtype),
            t(bt, dev), t(np.array(lengths, np.int32), dev))


def paged_once(q, kp, vp, bt, lengths, al=None):
    before = launch_counts()["paged_decode_attention"]
    got = paged_decode_attention(q, kp, vp, bt, lengths, al)
    torch.cuda.synchronize()
    assert launch_counts()["paged_decode_attention"] == before + 1
    return got


def paged_hold(args, atol, al=None):
    got = paged_once(*args, al)
    q, kp, vp, bt, lengths = args
    ref = reference_paged_attention(
        q[:, None], torch.nan_to_num(kp), torch.nan_to_num(vp), bt,
        (lengths.long() - 1)[:, None], al)[:, 0]
    assert torch.isfinite(got).all()
    assert (got[lengths == 0] == 0).all()
    torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                               rtol=atol)
    return got


@pytest.mark.parametrize("BS", [8, 16, 32, 64])
@pytest.mark.parametrize("n,k", [(4, 4), (16, 4), (32, 4)])
@pytest.mark.parametrize("dtype,atol", ATTN)
def test_paged_decode_edge_lengths(dev, BS, n, k, dtype, atol):
    """Rows of 0, 1, BS, BS + 1 keys, a full table and one past it, G 1 / 4
    / 8 with alibi; R 6 x K 4 takes 8 splits, so the short rows leave most
    splits without a page. fp32 without alibi: over these 96..768 columns
    the bias reaches ~100, where one fp32 ulp of a score (~8e-6) moves the
    weights by more than the fp32 tolerance (as ``attn_params``)."""
    MAXB = 12
    lengths = [0, 1, BS, BS + 1, MAXB * BS, MAXB * BS + 5]
    args = paged_case(dev, lengths, BS, MAXB, n, k, 128, dtype, BS + n)
    al = alibi_slopes(n, device=dev) if dtype != torch.float32 else None
    paged_hold(args, atol, al)


@pytest.mark.parametrize("dtype,atol", ATTN)
def test_paged_decode_long_row_nan(dev, dtype, atol):
    """One row of 3990 keys over a full 256-page table (llama-7b's heads: 8
    splits of 32 pages), NaN in the scratch block, in the tail of the last
    page (positions 3990..3999 of page 249) and in the pages after it."""
    args = paged_case(dev, [3990], 16, 256, 32, 32, 128, dtype, 11,
                      stale=True)
    q, kp, vp, bt, lengths = args
    for p in (kp, vp):
        assert bool(torch.isnan(p[bt[0, 250:].long()]).all())
        assert bool(torch.isnan(p[bt[0, 249], 3990 % 16:]).all())
        assert not bool(torch.isnan(p[bt[0, :249].long()]).any())
    paged_hold(args, atol)


# rows of 40 (bf16 D 20), 66 (fp16 D 33) and 132 bytes (fp32 D 33): no
# tensor map takes them; 16-byte rows in boxes of 64 bytes (bf16 D 8, block
# 4: 8 pages a stage, a box off 128 bytes); 96-byte rows (bf16 D 48) by TMA
@pytest.mark.parametrize("D,BS,dtype,atol", [
    (20, 16, torch.bfloat16, 2e-2), (33, 16, torch.float16, 5e-3),
    (33, 8, torch.float32, 2e-5), (8, 4, torch.bfloat16, 2e-2),
    (48, 16, torch.bfloat16, 2e-2)])
def test_paged_decode_rows_not_16_bytes(dev, D, BS, dtype, atol):
    lengths = [3 * BS + 1, 0, 7, 10 * BS]
    args = paged_case(dev, lengths, BS, 10, 8, 2, D, dtype, D)
    al = alibi_slopes(8, device=dev) if dtype != torch.float32 else None
    paged_hold(args, atol, al)


@pytest.mark.parametrize("R,MAXB,BS,n,k,D,dtype", [
    (8, 64, 16, 32, 32, 128, torch.bfloat16),
    (3, 20, 32, 16, 4, 64, torch.float32),
    (1, 256, 16, 32, 32, 128, torch.float16)])
def test_paged_decode_repeatable(dev, R, MAXB, BS, n, k, D, dtype):
    """Two calls on the same inputs give equal bits: the splits merge in
    rank order, with no atomics."""
    rng = np.random.default_rng(R)
    lengths = rng.integers(0, MAXB * BS + 1, R).tolist()
    args = paged_case(dev, lengths, BS, MAXB, n, k, D, dtype, R, nan=False)
    a = paged_once(*args)
    b = paged_once(*args)
    assert torch.equal(a, b)


def test_paged_decode_one_launch_no_host_sync(dev):
    """llama-7b's serve step (R 8, 32 heads of 128, block 16): one launch a
    call, and no device value read on the host (CUDA's sync debug mode
    raises on a synchronising call)."""
    lengths = [1, 1000, 0, 517, 64, 333, 800, 129]
    args = paged_case(dev, lengths, 16, 64, 32, 32, 128, torch.bfloat16, 3)
    paged_once(*args)                      # build and bind first
    torch.cuda.set_sync_debug_mode("error")
    try:
        before = launch_counts()["paged_decode_attention"]
        paged_decode_attention(*args)
        assert launch_counts()["paged_decode_attention"] == before + 1
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


# The tensor-core prefill kernel (paged_prefill_tma_kernel, bf16 / fp16 with
# D in {16, 32, 64, 128}): several q tiles and partial ones (C 64, 150, 200,
# 256), both work-tile plans (64 rows split over the warpgroups at one row
# of llama-7b's chunk, 128 rows at two), rows that differ in start and
# n_valid with starts off a page boundary, G 1 / 4 / 8 with alibi, pages of
# 4..64 rows (by TMA at multiples of 8, plain loads below), NaN in the
# scratch block, the tail of each row's last written page and the pages
# after it (the table's stale entries point at them), n_valid 0, bit-equal
# repeats, one launch a call of the kernel the route names and no host
# sync.
ATTN16 = ATTN[1:]


def prefill_case(dev, C, n, k, D, BS, starts, valid, dtype, seed,
                 nan=True):
    """Pools, table, q, start and n_valid for rows at ``starts`` with
    ``valid`` chunk queries: each row's pages drawn from a shuffled pool
    and its table filled to the end (stale entries: pages no row writes);
    with ``nan`` the scratch block, every page no row writes and the tail
    of each row's last written page hold NaN."""
    B = len(starts)
    MAXB = -(-(max(starts) + C) // BS) + 2
    rng = np.random.default_rng(seed)
    NB = B * MAXB + 2
    kp = rng.normal(size=(NB, BS, k, D)).astype(np.float32)
    vp = rng.normal(size=(NB, BS, k, D)).astype(np.float32)
    perm = rng.permutation(np.arange(1, NB))
    bt = perm[:B * MAXB].reshape(B, MAXB).astype(np.int32)
    used = set()
    for r in range(B):
        written = starts[r] + valid[r]
        npages = -(-written // BS)
        used.update(bt[r, :npages].tolist())
        if nan and written < npages * BS:
            for p in (kp, vp):
                p[bt[r, npages - 1], written % BS:] = np.nan
    if nan:
        for p in (kp, vp):
            p[0] = np.nan
            p[[x for x in range(1, NB) if x not in used]] = np.nan
    q = rng.normal(size=(B, C, n, D))
    return (t(q, dev, dtype), t(kp, dev, dtype), t(vp, dev, dtype),
            t(bt, dev), t(np.array(starts, np.int32), dev),
            t(np.array(valid, np.int32), dev))


def prefill_once(q, kp, vp, bt, st, nv, al=None):
    before = launch_counts()["paged_prefill_attention"]
    got = paged_prefill_attention(q, kp, vp, bt, st, al, n_valid=nv)
    torch.cuda.synchronize()
    assert launch_counts()["paged_prefill_attention"] == before + 1
    return got


def prefill_hold(args, atol, al=None):
    got = prefill_once(*args, al)
    q, kp, vp, bt, st, nv = args
    C = q.shape[1]
    offs = torch.arange(C, device=q.device)
    pos = torch.where(offs[None] < nv.long()[:, None],
                      st.long()[:, None] + offs[None],
                      torch.full((q.shape[0], C), -1, device=q.device))
    ref = reference_paged_attention(q, kp, vp, bt, pos, al)
    assert torch.isfinite(got).all()
    for r, v in enumerate(nv.tolist()):
        assert (got[r, v:] == 0).all()          # pads output zeros
    torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                               rtol=atol)
    return got


@pytest.mark.parametrize("C,n,k,starts,valid", [
    (64, 32, 32, [256], [64]),
    (256, 32, 32, [256], [256]),          # serve's chunk: 64-row tiles
    (256, 32, 32, [512], [188]),          # the tail of a 700-token prompt
    (200, 32, 8, [0, 37], [200, 150]),    # 128-row tiles, G 4
    (150, 32, 32, [21, 300], [150, 64]),  # a 128-row tile's half past C
    (16, 8, 1, [5, 0], [16, 3])])         # G 8, chunks shorter than 64
@pytest.mark.parametrize("use_alibi", [False, True])
@pytest.mark.parametrize("dtype,atol", ATTN16)
def test_prefill_tma_tiles(dev, C, n, k, starts, valid, use_alibi, dtype,
                           atol):
    args = prefill_case(dev, C, n, k, 128, 16, starts, valid, dtype,
                        C + n + k)
    al = alibi_slopes(n, device=dev) if use_alibi else None
    prefill_hold(args, atol, al)


@pytest.mark.parametrize("BS", [4, 8, 12, 16, 24, 32, 64])
@pytest.mark.parametrize("dtype,atol", ATTN16)
def test_prefill_tma_page_sizes(dev, BS, dtype, atol):
    """Pages of 8, 16, 24 (boxes of 8 rows), 32 and 64 rows by TMA; of 4
    and 12 rows by the producer's plain loads."""
    args = prefill_case(dev, 100, 8, 2, 64, BS, [3, 50], [100, 77], dtype,
                        BS)
    prefill_hold(args, atol, alibi_slopes(8, device=dev))


@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("n,k", [(4, 4), (8, 2), (16, 2)])
@pytest.mark.parametrize("dtype,atol", ATTN16)
def test_prefill_tma_head_dims(dev, D, n, k, dtype, atol):
    args = prefill_case(dev, 70, n, k, D, 16, [9, 130], [70, 41], dtype,
                        D + n)
    prefill_hold(args, atol, alibi_slopes(n, device=dev))


@pytest.mark.parametrize("valid", [[0, 0], [0, 5]])
def test_prefill_tma_no_valid_query(dev, valid):
    """n_valid 0: the row's output is all zeros (its blocks see no key)."""
    args = prefill_case(dev, 96, 8, 2, 128, 16, [40, 7], valid,
                        torch.bfloat16, 5)
    got = prefill_hold(args, 2e-2)
    assert (got[0] == 0).all()


def test_prefill_tma_nan_pages(dev):
    """NaN in the tail of the last written page (positions 700..703 of page
    43) and in every page after it: finite output at llama-7b's heads."""
    args = prefill_case(dev, 256, 32, 32, 128, 16, [512], [188],
                        torch.bfloat16, 9)
    q, kp, vp, bt, st, nv = args
    for p in (kp, vp):
        assert bool(torch.isnan(p[bt[0, 43], 700 % 16:]).all())
        assert bool(torch.isnan(p[bt[0, 44:].long()]).all())
        assert not bool(torch.isnan(p[bt[0, :43].long()]).any())
    prefill_hold(args, 2e-2)


@pytest.mark.parametrize("C,n,k,starts,valid", [
    (256, 32, 32, [256], [256]), (200, 32, 8, [0, 37], [200, 150])])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_prefill_tma_repeatable(dev, C, n, k, starts, valid, dtype):
    """Two calls on the same inputs give equal bits (the 64-row tiles'
    warpgroups merge in a fixed order, with no atomics)."""
    args = prefill_case(dev, C, n, k, 128, 16, starts, valid, dtype, 3,
                        nan=False)
    assert torch.equal(prefill_once(*args), prefill_once(*args))


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 128),
                                     (torch.float16, 64),
                                     (torch.float32, 128),
                                     (torch.bfloat16, 48)])
def test_prefill_launches_its_route(dev, dtype, D):
    """One device kernel a call, the one ``prefill_kernel`` names: the
    tensor-core kernel for 16-bit D 16..128, the CUDA-core one for fp32
    and other D."""
    args = prefill_case(dev, 64, 8, 2, D, 16, [30], [64], dtype, 1)
    prefill_once(*args)                     # build and bind first
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        prefill_once(*args)
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    want = prefill_kernel(dtype, D)
    assert len(names) == 1 and want in names[0], names


def test_prefill_one_launch_no_host_sync(dev):
    """llama-7b's serve chunk: one launch a call, and no device value read
    on the host (CUDA's sync debug mode raises on a synchronising call)."""
    args = prefill_case(dev, 256, 32, 32, 128, 16, [256], [200],
                        torch.bfloat16, 4)
    q, kp, vp, bt, st, nv = args
    prefill_once(*args)
    torch.cuda.set_sync_debug_mode("error")
    try:
        before = launch_counts()["paged_prefill_attention"]
        paged_prefill_attention(q, kp, vp, bt, st, n_valid=nv)
        assert launch_counts()["paged_prefill_attention"] == before + 1
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# dense attention: flash forward and decode over a (B, T, K, D) cache
# ---------------------------------------------------------------------------

STALE = 1e4      # arena slots outside every mask: large and finite


def attn_params(shapes, flags):
    """shape x flags x dtype cases, without fp32 alibi over an arena longer
    than 512 columns: there the bias slope * column reaches ~860, where one
    fp32 ulp (6e-5) exceeds the 2e-5 tolerance and both versions round the
    score differently. That combination is held in bf16 / fp16 at the path
    shape and in fp32 at the small shapes."""
    return [(*shape, *flag, dtype, atol) for shape in shapes
            for flag in flags for dtype, atol in ATTN
            # shape[-4] is T in (B, S, T, N, K, D) and (B, T, N, K, D)
            if not (dtype == torch.float32 and shape[-4] > 512
                    and flag[-1] not in (False, "none"))]


def dense_mask(B, T, seed, lo=1):
    """(B, T) int32: right padding at lengths in [lo, T], plus holes;
    column 0 always valid."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, T + 1, B)
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.int32)
    mask[:, 1::7] = 0
    mask[:, 0] = 1
    return mask


def dense_kv(B, T, K, D, mask, seed):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(B, T, K, D)).astype(np.float32)
    v = rng.normal(size=(B, T, K, D)).astype(np.float32)
    k[mask == 0] = STALE
    v[mask == 0] = -STALE
    return k, v


# (B, S, T, N, K, D): small shapes over the tensor-core head sizes and the
# CUDA-core fallback (D 48), ragged edges (S, T not multiples of 64), GQA,
# an odd count of work tiles at D 64 (the persistent route's last pair holds
# one); then the static prefill of llama-7b's generate (S 512 over a
# 1024-column arena), OPT-1.3B's training shape (S = T 1024, 32 heads of
# 64) and moe-gpt-350m-8e's (16 heads of 64)
FLASH_SHAPES = [(2, 16, 16, 4, 4, 32), (2, 12, 40, 4, 2, 32),
                (2, 37, 37, 8, 2, 64), (1, 70, 130, 8, 2, 128),
                (2, 65, 65, 4, 1, 16), (2, 20, 33, 4, 2, 48),
                (1, 70, 70, 3, 1, 64),
                (8, 512, 1024, 32, 32, 128), (4, 1024, 1024, 32, 32, 64),
                (4, 1024, 1024, 16, 16, 64)]


@pytest.mark.parametrize("B,S,T,N,K,D,causal,use_alibi,dtype,atol", attn_params(
    FLASH_SHAPES, [(c, a) for c in (True, False) for a in (False, True)]))
def test_flash_matches_plain(dev, B, S, T, N, K, D, causal, use_alibi,
                             dtype, atol):
    rng = np.random.default_rng(S * T + N)
    mask = dense_mask(B, T, seed=T, lo=max(1, T // 4))
    k, v = dense_kv(B, T, K, D, mask, seed=D)
    q = rng.normal(size=(B, S, N, D))
    al = alibi_slopes(N, device=dev) if use_alibi else None
    args = (t(q, dev, dtype), t(k, dev, dtype), t(v, dev, dtype),
            t(mask, dev))
    before = launch_counts()["flash_attention"]
    got, lse = flash_attention(*args, causal=causal, alibi=al,
                               return_lse=True)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == before + 1
    ref, ref_lse = reference_flash_attention(*args, causal=causal, alibi=al,
                                             return_lse=True)
    hold_fwd(got, lse, ref, ref_lse, atol)


def test_flash_cacheless_without_mask(dev):
    B, S, N, K, D = 2, 100, 8, 4, 128
    rng = np.random.default_rng(0)
    q, k, v = (t(rng.normal(size=shape), dev, torch.bfloat16) for shape in
               ((B, S, N, D), (B, S, K, D), (B, S, K, D)))
    got = flash_attention(q, k, v)
    ref = reference_flash_attention(q, k, v)
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_empty_rows_give_zeros(dev, dtype):
    B, S, T, N, D = 1, 8, 70, 2, 64
    rng = np.random.default_rng(1)
    mask = np.zeros((B, T), np.int32)
    mask[0, 3:60] = 1                 # query rows 0..2 see no key
    q, k, v = (t(rng.normal(size=shape), dev, dtype) for shape in
               ((B, S, N, D), (B, T, N, D), (B, T, N, D)))
    got, lse = flash_attention(q, k, v, t(mask, dev), return_lse=True)
    torch.cuda.synchronize()
    assert (got[0, :3] == 0).all() and torch.isinf(lse[0, :, :3]).all()
    assert torch.isfinite(got).all() and torch.isfinite(lse[0, :, 3:]).all()


def test_flash_rejects_bad_operands(dev):
    q = torch.zeros(2, 8, 4, 32, device=dev, dtype=torch.bfloat16)
    k = torch.zeros(2, 16, 2, 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                     # dtype mismatch
        flash_attention(q, k.float(), k.float())
    with pytest.raises(ValueError):                     # device mismatch
        flash_attention(q, k.cpu(), k.cpu())
    with pytest.raises(ValueError):                     # not contiguous
        flash_attention(q.transpose(1, 2), k, k)
    with pytest.raises(ValueError):                     # mask shape
        flash_attention(q, k, k, torch.ones(2, 8, device=dev))
    with pytest.raises(ValueError):                     # 3 query heads / 2
        flash_attention(q[:, :, :3].contiguous(), k, k)
    base = torch.zeros(2 * 8 * 4 * 32 + 1, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention(base[1:].view(2, 8, 4, 32), k, k)


# head dims of the TMA / wgmma forward (16-bit: D 16..128, and 256 < D <=
# 512 with D % 8 == 0, 264 with a partial last panel); the fp32 cases run
# the CUDA-core kernel on the same inputs
TMA_DIMS = [16, 64, 128, 264, 512]


def hold_fwd(got, lse, ref, ref_lse, atol):
    assert torch.isfinite(got).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                               rtol=atol)
    torch.testing.assert_close(lse, ref_lse, atol=atol, rtol=atol)


@pytest.mark.parametrize("D", TMA_DIMS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,atol", ATTN)
def test_flash_nan_in_masked_rows(dev, D, causal, dtype, atol):
    """Masked keys whose K / V rows hold NaN (a stale arena slot): o and
    lse finite and as the plain version's over those rows zeroed."""
    B, S, N, K = 2, 150, 4, 2
    q, k, v, _, m, _ = bwd_operands(dev, B, S, S, N, K, D, dtype, 21, S // 2,
                                    stale=float("nan"))
    kz, vz = torch.nan_to_num(k, nan=0.0), torch.nan_to_num(v, nan=0.0)
    got, lse = flash_attention(q, k, v, m, causal=causal, return_lse=True)
    ref, ref_lse = reference_flash_attention(q, kz, vz, m, causal,
                                             return_lse=True)
    hold_fwd(got, lse, ref, ref_lse, atol)


@pytest.mark.parametrize("D", TMA_DIMS)
@pytest.mark.parametrize("dtype,atol", ATTN)
def test_flash_keys_past_last_query(dev, D, dtype, atol):
    """Causal with T > S: key tiles past the last query are seen by no
    query; S = 200 is not a multiple of the q tile (64 or 128 rows), so the
    last q tile is ragged."""
    B, S, T, N, K = 2, 200, 520, 4, 2
    q, k, v, _, m, _ = bwd_operands(dev, B, S, T, N, K, D, dtype, 22, T - 20)
    got, lse = flash_attention(q, k, v, m, causal=True, return_lse=True)
    ref, ref_lse = reference_flash_attention(q, k, v, m, True,
                                             return_lse=True)
    hold_fwd(got, lse, ref, ref_lse, atol)


@pytest.mark.parametrize("D", [128, 512])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,atol", ATTN)
def test_flash_gqa_four_heads_a_group(dev, D, causal, dtype, atol):
    """G = 4 query heads read each KV head (16 over 4)."""
    B, S, T, N, K = 2, 130, 260, 16, 4
    q, k, v, _, m, _ = bwd_operands(dev, B, S, T, N, K, D, dtype, 24, T // 3)
    got, lse = flash_attention(q, k, v, m, causal=causal, return_lse=True)
    ref, ref_lse = reference_flash_attention(q, k, v, m, causal,
                                             return_lse=True)
    hold_fwd(got, lse, ref, ref_lse, atol)


@pytest.mark.parametrize("D", TMA_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_repeatable(dev, D, dtype):
    """Two calls on the same inputs give bit-equal o and lse: the forward
    has no atomics, and each output row is written once, by one block."""
    B, S, N, K = 2, 300, 4, 2
    q, k, v, _, m, _ = bwd_operands(dev, B, S, S, N, K, D, dtype, 23, S // 2)
    a = flash_attention(q, k, v, m, return_lse=True)
    b = flash_attention(q, k, v, m, return_lse=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# (B, T, N, K, D): small shapes over the vector-load paths (16-bit D 64 /
# 128) and the lane-per-dim paths, GQA up to 8 query heads per KV head; then
# llama-7b's decode step over the 1024-column arena
DECODE_SHAPES = [(3, 37, 4, 4, 32), (3, 64, 8, 2, 64), (2, 129, 8, 1, 128),
                 (2, 50, 32, 4, 128), (3, 20, 4, 2, 48),
                 (8, 1024, 32, 32, 128)]


@pytest.mark.parametrize("B,T,N,K,D,bounded,alibi_mode,dtype,atol",
                         attn_params(DECODE_SHAPES,
                                     [(b, a) for b in (False, True)
                                      for a in ("none", "column",
                                                "positions")]))
def test_decode_dense_matches_plain(dev, B, T, N, K, D, bounded, alibi_mode,
                                    dtype, atol):
    rng = np.random.default_rng(T * N + D)
    valid = dense_mask(B, T, seed=T)
    kv_len = None
    if bounded:                        # the engine's cursor + 1
        kv_len = int(valid.sum(-1).max()) - 2 if T > 8 else T
        valid[:, kv_len:] = 0
        valid[:, 0] = 1
    k, v = dense_kv(B, T, K, D, valid, seed=N)
    q = rng.normal(size=(B, N, D))
    kpos = np.sort(rng.uniform(0, 2 * T, (B, T)), axis=1).astype(np.float32)
    al = alibi_slopes(N, device=dev) if alibi_mode != "none" else None
    kp = t(kpos, dev) if alibi_mode == "positions" else None
    args = (t(q, dev, dtype), t(k, dev, dtype), t(v, dev, dtype),
            t(valid, dev))
    before = launch_counts()["decode_attention"]
    got = decode_attention(*args, alibi=al, key_positions=kp, kv_len=kv_len)
    torch.cuda.synchronize()
    assert launch_counts()["decode_attention"] == before + 1
    ref = reference_decode_attention(*args, alibi=al, key_positions=kp,
                                     kv_len=kv_len)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                               rtol=atol)


def test_decode_dense_empty_row_gives_zeros(dev):
    B, T, N, D = 2, 40, 4, 128
    rng = np.random.default_rng(2)
    valid = np.ones((B, T), np.int32)
    valid[1] = 0
    q, k, v = (t(rng.normal(size=shape), dev, torch.bfloat16) for shape in
               ((B, N, D), (B, T, N, D), (B, T, N, D)))
    got = decode_attention(q, k, v, t(valid, dev))
    torch.cuda.synchronize()
    assert (got[1] == 0).all() and torch.isfinite(got).all()


def test_decode_dense_rejects_bad_operands(dev):
    q = torch.zeros(2, 4, 32, device=dev)
    kc = torch.zeros(2, 16, 2, 32, device=dev)
    valid = torch.ones(2, 16, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):                     # dtype mismatch
        decode_attention(q.half(), kc, kc, valid)
    with pytest.raises(ValueError):                     # device mismatch
        decode_attention(q, kc.cpu(), kc.cpu(), valid)
    with pytest.raises(ValueError):                     # not contiguous
        decode_attention(q, kc.transpose(1, 2).contiguous().transpose(1, 2),
                         kc, valid)
    with pytest.raises(ValueError):                     # valid shape
        decode_attention(q, kc, kc, valid[:, :8])
    with pytest.raises(ValueError):                     # 16 heads per KV head
        decode_attention(torch.zeros(2, 32, 32, device=dev), kc, kc, valid)


# The split-KV kernel's edges: kv_len at a tile or split edge and one past
# it, dead chunks between live ones, no live key, one long row, G 8 with
# alibi and key positions, rows whose bytes are not a multiple of 16 (no
# tensor map: plain loads), NaN in dead slots, bit-equal repeats. Each call
# is one launch.
def decode_once(dev, q, k, v, valid, **kw):
    before = launch_counts()["decode_attention"]
    got = decode_attention(q, k, v, valid, **kw)
    torch.cuda.synchronize()
    assert launch_counts()["decode_attention"] == before + 1
    return got


def decode_hold(dev, B, T, N, K, D, valid, dtype, atol, seed, **kw):
    k, v = dense_kv(B, T, K, D, valid, seed=seed)
    q = np.random.default_rng(seed + 1).normal(size=(B, N, D))
    args = (t(q, dev, dtype), t(k, dev, dtype), t(v, dev, dtype),
            t(valid, dev))
    got = decode_once(dev, *args, **kw)
    ref = reference_decode_attention(*args, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                               rtol=atol)
    return got, ref


# B 1, K 2: 8 splits; 384 = 6 chunks of 64 (two splits past it), 385 puts
# one column in the seventh; 512 = 8 x 64, 513 one past
@pytest.mark.parametrize("kv_len", [31, 32, 33, 384, 385, 512, 513])
@pytest.mark.parametrize("dtype,atol", ATTN)
def test_decode_dense_kv_len_edges(dev, kv_len, dtype, atol):
    B, T, N, K, D = 1, 600, 4, 2, 128
    decode_hold(dev, B, T, N, K, D, np.ones((B, T), np.int32), dtype, atol,
                kv_len, kv_len=kv_len)


@pytest.mark.parametrize("dtype,atol", ATTN)
def test_decode_dense_dead_chunks(dev, dtype, atol):
    """Whole chunks with no live column between live ones (the split of
    columns 256..383, and 600..700 across two splits), in one row; the
    other row keeps only its first and last tiles."""
    B, T, N, K, D = 2, 1024, 8, 2, 128
    valid = np.ones((B, T), np.int32)
    valid[0, 256:384] = 0
    valid[0, 600:701] = 0
    valid[1, 32:992] = 0
    decode_hold(dev, B, T, N, K, D, valid, dtype, atol, 5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_decode_dense_no_live_key_gives_zeros(dev, dtype):
    """kv_len 0 gives zeros; a row with no live key among live rows too."""
    B, T, N, K, D = 3, 700, 8, 2, 128
    rng = np.random.default_rng(4)
    q, k, v = (t(rng.normal(size=shape), dev, dtype) for shape in
               ((B, N, D), (B, T, K, D), (B, T, K, D)))
    valid = np.ones((B, T), np.int32)
    got = decode_once(dev, q, k, v, t(valid, dev), kv_len=0)
    assert (got == 0).all()
    valid[1] = 0
    got = decode_once(dev, q, k, v, t(valid, dev), kv_len=650)
    ref = reference_decode_attention(q, k, v, t(valid, dev), kv_len=650)
    assert (got[1] == 0).all() and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), ref.float(),
                               atol=dict(ATTN)[dtype], rtol=dict(ATTN)[dtype])


@pytest.mark.parametrize("dtype,atol", ATTN)
def test_decode_dense_one_long_row(dev, dtype, atol):
    """B 1 at T 4096, llama-7b's heads, kv_len 4000 with holes."""
    B, T, N, K, D = 1, 4096, 32, 32, 128
    valid = dense_mask(B, T, seed=9, lo=T)
    decode_hold(dev, B, T, N, K, D, valid, dtype, atol, 9, kv_len=4000)


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("dtype,atol", ATTN)
def test_decode_dense_eight_heads_a_group_alibi(dev, D, dtype, atol):
    """G 8 (32 query heads over 4 KV heads), alibi over per-row key
    positions, over 8 splits. Positions below 64 keep the bias where one
    fp32 ulp (4e-6) is under the fp32 tolerance (``attn_params``)."""
    B, T, N, K = 2, 500, 32, 4
    valid = dense_mask(B, T, seed=D, lo=T // 2)
    kpos = np.sort(np.random.default_rng(D).uniform(0, 64, (B, T)),
                   axis=1).astype(np.float32)
    decode_hold(dev, B, T, N, K, D, valid, dtype, atol, D,
                alibi=alibi_slopes(N, device=dev),
                key_positions=t(kpos, dev), kv_len=480)


# rows of 40 (bf16 D 20), 66 (bf16 D 33) and 132 bytes (fp32 D 33): no
# tensor map takes them; 96 bytes (bf16 D 48): a map, sliced reads
@pytest.mark.parametrize("D,dtype,atol", [(20, torch.bfloat16, 2e-2),
                                          (33, torch.bfloat16, 2e-2),
                                          (33, torch.float16, 5e-3),
                                          (33, torch.float32, 2e-5),
                                          (48, torch.bfloat16, 2e-2)])
def test_decode_dense_rows_not_16_bytes(dev, D, dtype, atol):
    """With alibi over the columns in 16 bits (fp32: ``attn_params``)."""
    B, T, N, K = 3, 300, 8, 2
    valid = dense_mask(B, T, seed=D)
    al = alibi_slopes(N, device=dev) if dtype != torch.float32 else None
    decode_hold(dev, B, T, N, K, D, valid, dtype, atol, D, alibi=al,
                kv_len=290)


@pytest.mark.parametrize("D", [128, 20])
@pytest.mark.parametrize("dtype,atol", ATTN)
def test_decode_dense_nan_in_dead_slots(dev, D, dtype, atol):
    """Dead slots (holes inside live tiles, the padding, and columns past
    kv_len) hold NaN: the output is finite and equals the plain version's
    on the same inputs with those slots finite."""
    B, T, N, K = 4, 700, 8, 2
    valid = dense_mask(B, T, seed=3)
    k, v = dense_kv(B, T, K, D, valid, seed=3)
    q = t(np.random.default_rng(4).normal(size=(B, N, D)), dev, dtype)
    kn, vn = k.copy(), v.copy()
    kn[valid == 0] = np.nan
    vn[valid == 0] = np.nan
    kn[:, 650:] = np.nan
    vn[:, 650:] = np.nan
    got = decode_once(dev, q, t(kn, dev, dtype), t(vn, dev, dtype),
                      t(valid, dev), kv_len=650)
    ref = reference_decode_attention(q, t(k, dev, dtype), t(v, dev, dtype),
                                     t(valid, dev), kv_len=650)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                               rtol=atol)


@pytest.mark.parametrize("B,T,N,K,D,dtype", [
    (8, 1024, 32, 32, 128, torch.bfloat16),
    (2, 600, 16, 4, 64, torch.float32),
    (1, 4096, 32, 32, 128, torch.float16)])
def test_decode_dense_repeatable(dev, B, T, N, K, D, dtype):
    """Two calls on the same inputs give equal bits: the splits merge in
    rank order, with no atomics."""
    valid = dense_mask(B, T, seed=T)
    k, v = dense_kv(B, T, K, D, valid, seed=1)
    q = np.random.default_rng(2).normal(size=(B, N, D))
    args = (t(q, dev, dtype), t(k, dev, dtype), t(v, dev, dtype),
            t(valid, dev))
    a = decode_once(dev, *args, kv_len=T - 24)
    b = decode_once(dev, *args, kv_len=T - 24)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# training kernels: flash backward (dq, dkv), fused Adam; the norm under
# autograd
# ---------------------------------------------------------------------------

# (B, S, T, N, K, D): small shapes over the MMA head sizes and the CUDA-core
# fallback (D 48), ragged edges, GQA up to 4 query heads per KV head, S != T;
# then the training shape of OPT-1.3B (B 4, S = T 1024, 32 heads of 64)
BWD_SHAPES = [(2, 16, 16, 4, 4, 32), (2, 37, 37, 8, 2, 64),
              (1, 70, 130, 8, 2, 128), (2, 65, 65, 4, 1, 16),
              (2, 20, 33, 4, 2, 48), (2, 100, 100, 8, 8, 64),
              (4, 1024, 1024, 32, 32, 64), (4, 1024, 1024, 16, 16, 64)]
# twice the relative rounding error of one round-to-nearest in the type
# (2^-9 bf16, 2^-12 fp16); fp32 rounds nothing
BWD_ROUND = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11,
             torch.float32: 0.0}


def bwd_operands(dev, B, S, T, N, K, D, dtype, seed, lo, stale=STALE):
    """q, k, v, dout, mask (numpy mask too) for a backward case; masked keys'
    K / V rows hold +-stale (NaN allowed)."""
    rng = np.random.default_rng(seed)
    mask = dense_mask(B, T, seed=T + 1, lo=lo)
    k, v = dense_kv(B, T, K, D, mask, seed=D + 1)
    k[mask == 0] = stale
    v[mask == 0] = -stale
    q = rng.normal(size=(B, S, N, D))
    do = rng.normal(size=(B, S, N, D))
    return (*(t(a, dev, dtype) for a in (q, k, v, do)), t(mask, dev), mask)


def hold_bwd(got, refs, mags, dtype, atol):
    for g, ref, mag in zip(got, refs, mags):
        assert torch.isfinite(g).all()
        # 16-bit: P and dS enter the tensor-core products rounded once to
        # the input type (as in FA2), so a sum over up to T terms errs by up
        # to that rounding times the sum of its terms' magnitudes (``mag``),
        # which cancellation can leave far above the result itself
        diff = (g.float() - ref.float()).abs()
        bound = atol + atol * ref.float().abs() + BWD_ROUND[dtype] * mag
        assert bool((diff <= bound).all()), float((diff - bound).max())


@pytest.mark.parametrize("B,S,T,N,K,D,causal,use_alibi,dtype,atol",
                         attn_params(BWD_SHAPES,
                                     [(c, a) for c in (True, False)
                                      for a in (False, True)]))
def test_flash_bwd_matches_plain(dev, B, S, T, N, K, D, causal, use_alibi,
                                 dtype, atol):
    qt, kt, vt, dot, m, mask = bwd_operands(dev, B, S, T, N, K, D, dtype,
                                            S * T + N + D, max(1, T // 2))
    al = alibi_slopes(N, device=dev) if use_alibi else None
    o, lse = reference_flash_attention(qt, kt, vt, m, causal, None, al,
                                       return_lse=True)
    before = launch_counts()["flash_attention_bwd"]
    dq, dk, dv = flash_attention_bwd(qt, kt, vt, o, lse, dot, m, causal,
                                     None, al)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention_bwd"] == before + 1
    refs = reference_flash_attention_bwd(qt, kt, vt, o, lse, dot, m, causal,
                                         None, al)
    mags = flash_attention_bwd_magnitude(qt, kt, vt, o, lse, dot, m, causal,
                                         None, al)
    hold_bwd((dq, dk, dv), refs, mags, dtype, atol)
    # masked keys get no gradient
    dead = torch.from_numpy(mask == 0).to(dev)
    assert (dk[dead] == 0).all() and (dv[dead] == 0).all()


@pytest.mark.parametrize("D", [16, 64, 128, 48])
@pytest.mark.parametrize("dtype,atol", ATTN)
def test_flash_bwd_nan_in_masked_rows(dev, D, dtype, atol):
    """Masked keys whose K / V rows hold NaN: every gradient finite, masked
    keys' dk / dv exactly 0, the rest as with finite rows there."""
    B, S, N, K = 2, 150, 4, 2
    qt, kt, vt, dot, m, mask = bwd_operands(dev, B, S, S, N, K, D, dtype, 11,
                                            S // 2, stale=float("nan"))
    kz, vz = torch.nan_to_num(kt, nan=0.0), torch.nan_to_num(vt, nan=0.0)
    o, lse = reference_flash_attention(qt, kz, vz, m, True, None, None,
                                       return_lse=True)
    got = flash_attention_bwd(qt, kt, vt, o, lse, dot, m)
    refs = reference_flash_attention_bwd(qt, kz, vz, o, lse, dot, m)
    mags = flash_attention_bwd_magnitude(qt, kz, vz, o, lse, dot, m)
    hold_bwd(got, refs, mags, dtype, atol)
    dead = torch.from_numpy(mask == 0).to(dev)
    assert (got[1][dead] == 0).all() and (got[2][dead] == 0).all()


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype,atol", ATTN)
def test_flash_bwd_keys_past_last_query(dev, D, dtype, atol):
    """Causal with T > S: key tiles past the last query are seen by no
    query, so their dk / dv are exactly 0; the rest matches the plain
    version."""
    B, S, T, N, K = 2, 70, 400, 4, 2
    qt, kt, vt, dot, m, mask = bwd_operands(dev, B, S, T, N, K, D, dtype, 12,
                                            T - 20)
    o, lse = reference_flash_attention(qt, kt, vt, m, True, None, None,
                                       return_lse=True)
    got = flash_attention_bwd(qt, kt, vt, o, lse, dot, m)
    refs = reference_flash_attention_bwd(qt, kt, vt, o, lse, dot, m)
    mags = flash_attention_bwd_magnitude(qt, kt, vt, o, lse, dot, m)
    hold_bwd(got, refs, mags, dtype, atol)
    assert (got[1][:, S:] == 0).all() and (got[2][:, S:] == 0).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_flash_bwd_repeatable(dev, dtype):
    """Two calls on the same inputs: dk and dv bit-equal (each key's rows
    are written once, by one block, in a fixed order); dq may differ in
    the order its fp32 partial sums (one per 128-key tile) land by
    atomics: at most one rounding of the type at |dq| plus the reordering
    of those sums, 2^-20 (~16 fp32 ulps: at most 8 partials here) of the
    sum of its terms' magnitudes."""
    B, S, N, K, D = 2, 1024, 8, 2, 64
    qt, kt, vt, dot, m, _ = bwd_operands(dev, B, S, S, N, K, D, dtype, 13,
                                         S // 2)
    o, lse = reference_flash_attention(qt, kt, vt, m, True, None, None,
                                       return_lse=True)
    a = flash_attention_bwd(qt, kt, vt, o, lse, dot, m)
    b = flash_attention_bwd(qt, kt, vt, o, lse, dot, m)
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    mag = flash_attention_bwd_magnitude(qt, kt, vt, o, lse, dot, m)[0]
    bound = (torch.finfo(dtype).eps * a[0].float().abs() + 2.0 ** -20 * mag)
    assert bool(((a[0].float() - b[0].float()).abs() <= bound).all())


@pytest.mark.parametrize("dtype,atol", LOW)
def test_flash_autograd_matches_plain_autograd(dev, dtype, atol):
    """Gradients through ``flash_attention`` (forward kernel with lse, then
    the two backward kernels) equal autograd through the plain forward."""
    B, S, N, K, D = 2, 77, 8, 2, 64
    rng = np.random.default_rng(5)
    mask = dense_mask(B, S, seed=3, lo=S // 2)
    al = alibi_slopes(N, device=dev)
    arrays = [rng.normal(size=(B, S, n, D)) for n in (N, K, K)]
    do = t(rng.normal(size=(B, S, N, D)), dev, dtype)
    grads = []
    for fn in (flash_attention, reference_flash_attention):
        leaves = [t(a, dev, dtype).requires_grad_() for a in arrays]
        fn(*leaves, t(mask, dev), causal=True, alibi=al).backward(do)
        grads.append([x.grad for x in leaves])
    for got, ref in zip(*grads):
        torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                                   rtol=atol)


def test_flash_bwd_rejects_bad_operands(dev):
    q = torch.zeros(2, 8, 4, 32, device=dev, dtype=torch.bfloat16)
    k = torch.zeros(2, 8, 2, 32, device=dev, dtype=torch.bfloat16)
    lse = torch.zeros(2, 4, 8, device=dev)
    with pytest.raises(ValueError):                     # dout dtype
        flash_attention_bwd(q, k, k, q, lse, q.float())
    with pytest.raises(ValueError):                     # o shape
        flash_attention_bwd(q, k, k, q[:, :4], lse, q)
    with pytest.raises(ValueError):                     # lse layout
        flash_attention_bwd(q, k, k, q, lse.transpose(1, 2), q)
    with pytest.raises(ValueError):                     # dtype
        flash_attention_bwd(q.double(), k.double(), k.double(), q.double(),
                            lse, q.double())
    wide = torch.zeros(1, 8, 1, 264, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                     # head_dim > 256
        flash_attention_bwd(wide, wide, wide, wide,
                            torch.zeros(1, 1, 8, device=dev), wide)


@pytest.mark.parametrize("n", [1, 4099, 1 << 20])
@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16,
                                        torch.float16])
@pytest.mark.parametrize("wd,adam_w", [(0.0, True), (0.01, True),
                                       (0.01, False)])
@pytest.mark.parametrize("extras", [False, True])
def test_fused_adam_matches_plain(dev, n, grad_dtype, wd, adam_w, extras):
    rng = np.random.default_rng(n)
    p, m = (t(rng.normal(size=n), dev, torch.float32) for _ in range(2))
    v = t(rng.uniform(0, 1, n), dev, torch.float32)
    g = t(rng.normal(size=n), dev, grad_dtype)
    kw = dict(step=3, lr=1e-2, weight_decay=wd, adam_w_mode=adam_w)
    if extras:
        kw.update(grad_scale=torch.tensor([0.37], device=dev),
                  skip=torch.tensor([False], device=dev))
    bufs = [[x.clone() for x in (p, m, v)] for _ in range(2)]
    copies = [torch.empty(n, dtype=torch.bfloat16, device=dev)
              for _ in range(2)] if extras else [None, None]
    before = launch_counts()["fused_adam"]
    fused_adam_flat(bufs[0][0], g, bufs[0][1], bufs[0][2],
                    param_copy=copies[0], **kw)
    torch.cuda.synchronize()
    assert launch_counts()["fused_adam"] == before + 1
    reference_adam_flat(bufs[1][0], g, bufs[1][1], bufs[1][2],
                        param_copy=copies[1], **kw)
    for a, b in zip(bufs[0], bufs[1]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    if extras:
        torch.testing.assert_close(copies[0].float(), copies[1].float(),
                                   atol=0, rtol=2 ** -7)


def test_fused_adam_skip_and_unaligned(dev):
    """A set skip flag writes nothing; views starting mid-vector take the
    scalar path."""
    base = torch.randn(4 * 1031 + 1, device=dev)
    p, g, m, v = (base[1:].clone()[1:].view(-1) for _ in range(4))
    v = v.abs()
    snap = [x.clone() for x in (p, m, v)]
    fused_adam_flat(p, g, m, v, 1, skip=torch.tensor([True], device=dev))
    for a, b in zip((p, m, v), snap):
        assert torch.equal(a, b)
    ref = [x.clone() for x in snap]
    fused_adam_flat(p, g, m, v, 1)
    reference_adam_flat(ref[0], g, ref[1], ref[2], 1)
    for a, b in zip((p, m, v), ref):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("dtype,atol", LOW)
def test_layer_norm_autograd_matches_plain(dev, rms, dtype, atol):
    """Under autograd the norm kernel's gradient (the plain ``_fln_bwd``
    transcription) equals autograd through the plain forward."""
    rng = np.random.default_rng(11)
    arrays = [rng.normal(0, 2.0, (33, 256)), rng.normal(1.0, 0.3, 256),
              rng.normal(0, 0.3, 256)]
    gy = t(rng.normal(size=(33, 256)), dev, dtype)
    grads = []
    for fn in (fused_layer_norm, reference_layer_norm):
        leaves = [t(a, dev, dtype).requires_grad_() for a in arrays]
        fn(leaves[0], leaves[1], None if rms else leaves[2], 1e-5,
           rms).backward(gy)
        grads.append([x.grad for x in leaves[:2 if rms else 3]])
    for got, ref in zip(*grads):
        torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                                   rtol=atol)


# ---------------------------------------------------------------------------
# quantized decode GEMMs
# ---------------------------------------------------------------------------

QUANT = ("int8_matmul", "int8_a8_matmul", "int4_matmul", "int4_a8_matmul")
# (K, N): small, and llama-7b's decode sites (q/k/v/o, gate/up, down, head)
QSHAPES = [(256, 128), (384, 96), (4096, 4096), (4096, 11008),
           (11008, 4096), (4096, 32000)]


def quant_operands(dev, name, M, K, N, groups, dtype, seed):
    """x (M, K) with a zero row, and the weight of ``name``'s layout."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1.0, (M, K)).astype(np.float32)
    if M > 2:
        x[2] = 0.0
    w = t(rng.normal(0, 0.05, (K, N)).astype(np.float32), dev)
    w[:, 1] = 0.0
    if name.startswith("int8"):
        q, s = _quantize_int8(w).values()
    else:
        q, s = quantize_int4(w, groups)
    return t(x, dev, dtype), q, s


# x dtypes: the weight-only kernels take fp16 too (one fp16 rounding of
# outputs of size up to ~20, the fp32 sums in another order)
QDTYPES = LOW + [(torch.float16, 5e-3)]
# the a8 kernels take JAX's a8 shapes (K, N, for int4 K/2, multiples of
# 128; (384, 96) is among the refused operands below) and no fp16
QCASES = [(name, K, N, dtype, atol) for name in QUANT for K, N in QSHAPES
          for dtype, atol in QDTYPES
          if not ("_a8" in name
                  and ((K, N) == (384, 96) or dtype == torch.float16))]


def hold_quant(got, ref, dtype, atol):
    torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                               rtol=atol)
    assert got.dtype == dtype and got.shape == ref.shape


@pytest.mark.parametrize("name,K,N,dtype,atol", QCASES)
@pytest.mark.parametrize("M", [1, 3, 5, 8])
def test_quant_matmul_matches_plain(dev, name, M, K, N, dtype, atol):
    """The a8 kernels equal their plain versions bit for bit (exact
    integer sums, the same fp32 epilogue; grouped int4 scales and sums its
    group partials in the kernel's order); the weight-only ones sum in fp32
    in another order."""
    groups = [None] if name.startswith("int8") else [None, 128]
    if K == 384 and not name.startswith("int8"):
        groups = [None, 64]
    for g in groups:
        x, q, s = quant_operands(dev, name, M, K, N, g, dtype, M * K + N)
        fn = getattr(quant_matmul, name)
        before = launch_counts()[name]
        got = fn(x, q, s)
        torch.cuda.synchronize()
        assert launch_counts()[name] == before + 1
        ref = getattr(quant_matmul, "reference_" + name)(x, q, s)
        assert got.dtype == dtype and got.shape == (M, N)
        if "_a8" in name:
            assert torch.equal(got, ref), float((got - ref).abs().max())
        else:
            hold_quant(got, ref, dtype, atol)


WEIGHT_ONLY = ("int8_matmul", "int4_matmul")
TC_DTYPES = [(torch.bfloat16, 2e-2), (torch.float16, 5e-3)]


# (K, N): one ring stage of K 64, so that most blocks of the cluster get no
# rows; K 392 (int4: 196 packed rows), a partial last stage; N 96 and 416,
# a partial column tile; N 384, whole tiles
@pytest.mark.parametrize("K,N", [(64, 96), (64, 384), (392, 384),
                                 (392, 416), (136, 160)])
@pytest.mark.parametrize("name", WEIGHT_ONLY)
@pytest.mark.parametrize("M", [1, 3, 5, 8])
@pytest.mark.parametrize("dtype,atol", TC_DTYPES)
def test_quant_matmul_tc_edges(dev, name, M, K, N, dtype, atol):
    """The tensor-core kernel at its edges, with a zero x row (M > 2) and
    an all-zero weight column; the same shapes in fp32 (the CUDA-core
    kernel)."""
    for dt, tol in ((dtype, atol), (torch.float32, 2e-5)):
        x, q, s = quant_operands(dev, name, M, K, N, None, dt, K + N + M)
        got = getattr(quant_matmul, name)(x, q, s)
        ref = getattr(quant_matmul, "reference_" + name)(x, q, s)
        hold_quant(got, ref, dt, tol)
        assert not got[:, 1].any()                # the all-zero column
        if M > 2:
            assert not got[2].any()               # the zero x row


# int4 groups of 4, 8, 12, 16, 24, 48, 64 and 128 rows over 384 packed rows
# (6 ring stages over clusters of 8 blocks, some empty): groups of 4, 8, 12
# and 24 end inside a 16-row unit
@pytest.mark.parametrize("group", [4, 8, 12, 16, 24, 48, 64, 128])
@pytest.mark.parametrize("M", [1, 3, 8])
@pytest.mark.parametrize("dtype,atol", TC_DTYPES + [(torch.float32, 2e-5)])
def test_int4_matmul_groups(dev, group, M, dtype, atol):
    x, q, s = quant_operands(dev, "int4_matmul", M, 768, 416, group, dtype,
                             group + M)
    assert s.shape == (768 // group, 416)
    got = quant_matmul.int4_matmul(x, q, s)
    hold_quant(got, quant_matmul.reference_int4_matmul(x, q, s), dtype, atol)


@pytest.mark.parametrize("name", WEIGHT_ONLY)
@pytest.mark.parametrize("dtype,atol", TC_DTYPES + [(torch.float32, 2e-5)])
def test_quant_matmul_misaligned_x(dev, name, dtype, atol):
    """An x view that starts off a 16-byte boundary is copied to an aligned
    buffer: the same bits as the aligned x."""
    x, q, s = quant_operands(dev, name, 5, 4096, 4096, None, dtype, 9)
    buf = torch.empty(5 * 4096 + 1, dtype=dtype, device=dev)
    view = buf[1:].view(5, 4096)
    view.copy_(x)
    assert view.data_ptr() % 16
    fn = getattr(quant_matmul, name)
    assert torch.equal(fn(view, q, s), fn(x, q, s))


@pytest.mark.parametrize("name,groups", [("int8_matmul", None),
                                         ("int4_matmul", None),
                                         ("int4_matmul", 128),
                                         ("int4_matmul", 8)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_quant_matmul_repeatable(dev, name, groups, dtype):
    """The K split meets in a fixed order (no atomics): two calls give the
    same bits, at llama-7b's gate / up site."""
    x, q, s = quant_operands(dev, name, 8, 4096, 11008, groups, dtype, 4)
    fn = getattr(quant_matmul, name)
    assert torch.equal(fn(x, q, s), fn(x, q, s))


@pytest.mark.parametrize("name", WEIGHT_ONLY)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_quant_matmul_launches_its_route(dev, name, dtype):
    """A weight-only call is one launch of the kernel of x's dtype: the
    tensor-core kernel for bf16 / fp16, the CUDA-core one for fp32 (the
    wrapper's route); the a8 wrappers' counts do not move."""
    x, q, s = quant_operands(dev, name, 8, 4096, 4096, None, dtype, 5)
    before = launch_counts()
    getattr(quant_matmul, name)(x, q, s)
    torch.cuda.synchronize()
    after = launch_counts()
    assert {k: after[k] - before[k] for k in QUANT} == {
        k: int(k == name) for k in QUANT}
    assert quant_matmul.weight_only_kernel(dtype) == (
        "quant_matmul_kernel" if dtype == torch.float32
        else "quant_matmul_tc_kernel")


@pytest.mark.parametrize("bits", [8, 4])
def test_fp16_weight_only_engine_generates(dev, bits):
    """An fp16 int8 / int4 engine (tiny-llama widened so that every site
    passes the kernel gate) generates on the card: in-vocab tokens, and
    its decode forwards launch the weight-only GEMM at every site; w8a8 /
    w4a8 with fp16 are refused there."""
    from deepspeed_tpu_torch.inference import InferenceConfig, init_inference
    from deepspeed_tpu_torch.ops import reset_launch_counts

    wide = dict(hidden_size=256, ffn_hidden_size=512)
    eng = init_inference("tiny-llama", config=InferenceConfig(
        dtype=torch.float16, quantize_bits=bits, max_out_tokens=128),
        device="cuda", **wide)
    cfg = eng.model.config
    rng = np.random.default_rng(bits)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 12)))
    mask = torch.ones(4, 12, dtype=torch.int32)
    mask[1, 7:] = 0
    reset_launch_counts()
    out = eng.generate(ids.to(dev), attention_mask=mask.to(dev),
                       max_new_tokens=6)
    torch.cuda.synchronize()
    assert out.shape == (4, 6)
    assert bool(((out >= 0) & (out < cfg.vocab_size)).all())
    name = "int8_matmul" if bits == 8 else "int4_matmul"
    per_forward = 7 * cfg.num_layers + (0 if cfg.tie_embeddings else 1)
    assert launch_counts()[name] == per_forward * 5
    with pytest.raises(NotImplementedError, match="fp16"):
        init_inference("tiny-llama", config=InferenceConfig(
            dtype=torch.float16, quantize_bits=bits,
            quantize_activations=True, max_out_tokens=128), device="cuda",
            **wide)


@pytest.mark.parametrize("M,K,N,group", [(3, 256, 128, 16), (8, 768, 256, 48),
                                         (5, 512, 384, 32), (8, 512, 128, 256)])
@pytest.mark.parametrize("dtype,atol", LOW)
def test_int4_a8_small_groups(dev, M, K, N, group, dtype, atol):
    """W4A8 with groups that end inside a 32-row step (16, 48 rows: two
    half steps) or on its edge: bit-equal to the plain version."""
    x, q, s = quant_operands(dev, "int4_a8_matmul", M, K, N, group, dtype,
                             K + group)
    got = quant_matmul.int4_a8_matmul(x, q, s)
    ref = quant_matmul.reference_int4_a8_matmul(x, q, s)
    torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                               rtol=atol)
    assert torch.equal(got, ref), float((got - ref).abs().max())


@pytest.mark.parametrize("K,N", [(384, 256), (4096, 11008)])
def test_quantizers_match_cpu_bit_for_bit(dev, K, N):
    """The decode path's three quantizers (the a8 GEMMs' activation rows,
    int8 and int4 weights) give the same q and scales on the card as on the
    CPU: every division is an IEEE division on both devices (a division by
    a Python number on a CUDA tensor is a product with its reciprocal)."""
    rng = np.random.default_rng(K + N)
    w = rng.normal(0, 0.05, (K, N)).astype(np.float32)
    w[:, 1] = 0.0
    x = rng.normal(0, 2.0, (8, K)).astype(np.float32)
    x[2] = 0.0
    group = 128 if (K // 2) % 128 == 0 else 64
    cases = [("activation rows", quant_matmul.quantize_activation_rows, x),
             ("int8 weights", lambda a: tuple(_quantize_int8(a).values()), w),
             ("int4 weights", quantize_int4, w),
             (f"int4 weights, groups of {group}",
              lambda a: quantize_int4(a, group), w)]
    differ = []
    for label, fn, a in cases:
        on_card = fn(t(a, dev))
        on_cpu = fn(t(a, "cpu"))
        for part, got, want in zip(("q", "scales"), on_card, on_cpu):
            assert got.dtype == want.dtype and got.shape == want.shape
            diff = int((got.cpu() != want).sum())
            if diff:
                differ.append(f"{label}: {diff} of {want.numel()} {part}")
    assert not differ, "differ on the card: " + "; ".join(differ)


def test_quant_matmul_rejects_bad_operands(dev):
    x, q, s = quant_operands(dev, "int8_matmul", 2, 256, 128, None,
                             torch.float32, 0)
    with pytest.raises(ValueError):                   # 9 rows
        quant_matmul.int8_matmul(x.repeat(5, 1)[:9], q, s)
    for name in ("int8_a8_matmul", "int4_a8_matmul"):  # fp16 x (a8)
        xa, qa, sa = quant_operands(dev, name, 2, 256, 128, None,
                                    torch.float16, 3)
        with pytest.raises(ValueError, match="float16"):
            getattr(quant_matmul, name)(xa, qa, sa)
    with pytest.raises(ValueError):                   # N % 32
        quant_matmul.int8_matmul(x, q[:, :112].contiguous(),
                                 s[:, :112].contiguous())
    for name in ("int8_a8_matmul", "int4_a8_matmul"):  # JAX's a8 shapes
        x3, q3, s3 = quant_operands(dev, name, 3, 384, 96, None,
                                    torch.float32, 1)
        with pytest.raises(ValueError, match="128"):
            getattr(quant_matmul, name)(x3, q3, s3)
    x4, q4, s4 = quant_operands(dev, "int4_a8_matmul", 2, 256, 128, 32,
                                torch.float32, 2)
    with pytest.raises(ValueError, match="groups"):   # groups of 8 rows
        quant_matmul.int4_a8_matmul(x4, q4, torch.cat([s4] * 4))
    with pytest.raises(ValueError):                   # another out dtype
        quant_matmul.int8_matmul(x, q, s, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError):                   # int8 weight as int4
        quant_matmul.int4_matmul(x, q, s)
    with pytest.raises(ValueError, match="contiguous"):
        quant_matmul.int8_matmul(x, q.t().contiguous().t(), s)


# ---------------------------------------------------------------------------
# block-sparse attention (forward, dq, dkv) and the LAMB phase-1 kernel
# ---------------------------------------------------------------------------


def sparse_layout(kind, N, S):
    """(layout (N, S/16, S/16), fine block, causal) of a named case: the
    path's Fixed layout, a sliding window, BSLongformer (global row and
    column: transposed lists wider than the forward's), per-head BigBird,
    a layout with a key-less q-tile, and a random asymmetric per-head
    layout (the dkv kernel must read the q-major masks untransposed)."""
    n = S // 16
    if kind == "fixed":
        cfg = sparse_attention.FixedSparsityConfig(num_heads=N, block=16)
        return cfg.make_layout(S), 16, True
    if kind == "window":
        cfg = sparse_attention.LocalSlidingWindowSparsityConfig(
            num_heads=N, block=16, num_sliding_window_blocks=3)
        return cfg.make_layout(S), 16, True
    if kind == "longformer":
        cfg = sparse_attention.BSLongformerSparsityConfig(num_heads=N,
                                                          block=16)
        return cfg.make_layout(S), 16, False
    if kind == "bigbird_heads":
        cfg = sparse_attention.BigBirdSparsityConfig(
            num_heads=N, block=32, different_layout_per_head=True,
            num_random_blocks=2)
        return cfg.make_layout(S), 32, False
    rng = np.random.default_rng(S + N)
    layout = (rng.uniform(size=(N, n, n)) < 0.15).astype(np.int64)
    if kind == "empty_tile":
        layout[:, :8, :] = 0          # q-tile 0: no active k-tile
        return layout, 16, False
    assert kind == "asym"
    return layout, 16, False


SPARSE_KINDS = ["fixed", "window", "longformer", "bigbird_heads",
                "empty_tile", "asym"]
# (B, S, N, D): small shapes over the tensor-core head sizes (an odd count
# of key tiles at D 64 and 128) and the CUDA-core route (D 48); the path's
# shape is held by chip_smoke.py
SPARSE_SHAPES = [(2, 256, 4, 64), (1, 384, 2, 128), (2, 256, 2, 32),
                 (1, 256, 2, 48), (1, 384, 2, 64)]


@pytest.mark.parametrize("kind", SPARSE_KINDS)
@pytest.mark.parametrize("B,S,N,D", SPARSE_SHAPES)
@pytest.mark.parametrize("dtype,atol", ATTN)
def test_block_sparse_matches_plain(dev, kind, B, S, N, D, dtype, atol):
    layout, block, causal = sparse_layout(kind, N, S)
    plan = build_tile_plan(layout, block, S)
    rng = np.random.default_rng(S + D + N)
    q, k, v, do = (t(rng.normal(size=(B, S, N, D)), dev, dtype)
                   for _ in range(4))
    for c in sorted({causal, not causal}):
        before = launch_counts()
        o, lse = block_sparse_attention_fwd(q, k, v, plan, c)
        ro, rlse = reference_block_sparse_attention(q, k, v, plan, c)
        dq, dk, dv = block_sparse_attention_bwd(q, k, v, ro, rlse, do, plan,
                                                c)
        torch.cuda.synchronize()
        after = launch_counts()
        for name in ("block_sparse_attention_fwd",
                     "block_sparse_attention_bwd"):
            assert after[name] == before[name] + 1
        torch.testing.assert_close(o.float(), ro.float(), atol=atol,
                                   rtol=atol)
        live = torch.isfinite(rlse)
        assert torch.equal(torch.isfinite(lse), live)
        torch.testing.assert_close(lse[live], rlse[live], atol=atol,
                                   rtol=atol)
        if kind == "empty_tile":
            assert (o[:, :128] == 0).all() and (dq[:, :128] == 0).all()
        refs = reference_block_sparse_attention_bwd(q, k, v, ro, rlse, do,
                                                    plan, c)
        mags = block_sparse_attention_bwd_magnitude(q, k, v, ro, rlse, do,
                                                    plan, c)
        for got, ref, mag in zip((dq, dk, dv), refs, mags):
            assert torch.isfinite(got).all()
            diff = (got.float() - ref.float()).abs()
            bound = atol + atol * ref.float().abs() + BWD_ROUND[dtype] * mag
            assert bool((diff <= bound).all()), float((diff - bound).max())


@pytest.mark.parametrize("dtype,atol", LOW)
def test_block_sparse_autograd_matches_plain(dev, dtype, atol):
    """Gradients through ``block_sparse_attention`` (forward kernel, then
    the dq and dkv kernels) equal those of ``plain=True``."""
    N, S, D = 4, 256, 64
    layout, block, causal = sparse_layout("fixed", N, S)
    plan = build_tile_plan(layout, block, S)
    rng = np.random.default_rng(7)
    arrays = [rng.normal(size=(2, S, N, D)) for _ in range(3)]
    do = t(rng.normal(size=(2, S, N, D)), dev, dtype)
    grads = []
    for plain in (False, True):
        leaves = [t(a, dev, dtype).requires_grad_() for a in arrays]
        block_sparse_attention(*leaves, plan, causal, plain=plain
                               ).backward(do)
        grads.append([x.grad for x in leaves])
    for got, ref in zip(*grads):
        torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                                   rtol=atol)


def test_block_sparse_rejects_bad_operands(dev):
    layout, block, _ = sparse_layout("fixed", 2, 256)
    plan = build_tile_plan(layout, block, 256)
    q = torch.zeros(1, 256, 2, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no GQA"):
        block_sparse_attention_fwd(q, q[:, :, :1].contiguous(),
                                   q[:, :, :1].contiguous(), plan)
    with pytest.raises(ValueError, match="plan"):
        block_sparse_attention_fwd(q[:, :128].contiguous(),
                                   q[:, :128].contiguous(),
                                   q[:, :128].contiguous(), plan)
    with pytest.raises(ValueError, match="contiguous"):
        qt = q.transpose(1, 2).contiguous().transpose(1, 2)
        block_sparse_attention_fwd(qt, q, q, plan)
    lse = torch.zeros(1, 2, 256, device=dev)
    with pytest.raises(ValueError):                     # dout dtype
        block_sparse_attention_bwd(q, q, q, q, lse, q.float(), plan)
    with pytest.raises(ValueError):                     # o shape
        block_sparse_attention_bwd(q, q, q, q[:, :128], lse, q, plan)
    with pytest.raises(ValueError):                     # lse layout
        block_sparse_attention_bwd(q, q, q, q, lse.transpose(1, 2), q, plan)
    with pytest.raises(ValueError):                     # float64
        qd = q.double()
        block_sparse_attention_bwd(qd, qd, qd, qd, lse, qd, plan)
    wide = torch.zeros(1, 256, 2, 264, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                     # head_dim 264
        block_sparse_attention_bwd(wide, wide, wide, wide, lse, wide, plan)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_block_sparse_bwd_keyless_q_tile(dev, dtype):
    """The fused route with a q-tile that sees no key (its lse -inf):
    every gradient finite, the tile's rows of dq exactly 0, the rest as
    the plain version."""
    B, S, N, D = 1, 512, 4, 64
    layout = np.tile(np.tril(np.ones((32, 32), np.int64)), (N, 1, 1))
    layout[:, 8:16, :] = 0                    # q-tile 1 sees no key
    plan = build_tile_plan(layout, 16, S)
    rng = np.random.default_rng(21)
    q, k, v, do = (t(rng.normal(size=(B, S, N, D)), dev, dtype)
                   for _ in range(4))
    o, lse = reference_block_sparse_attention(q, k, v, plan, True)
    assert bool(torch.isneginf(lse[..., 128:256]).all())
    got = block_sparse_attention_bwd(q, k, v, o, lse, do, plan, True)
    assert (got[0][:, 128:256] == 0).all()
    refs = reference_block_sparse_attention_bwd(q, k, v, o, lse, do, plan,
                                                True)
    mags = block_sparse_attention_bwd_magnitude(q, k, v, o, lse, do, plan,
                                                True)
    hold_bwd(got, refs, mags, dtype, dict(ATTN)[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_block_sparse_bwd_repeatable(dev, dtype):
    """Two calls on the same inputs (the Fixed layout, causal): dk and dv
    bit-equal (each key's rows are written once, by one block, in a fixed
    order); dq within one rounding of the type at |dq| plus 2^-20 of the
    sum of its terms' magnitudes, the order in which its fp32 parts land
    by TMA reduce-add (as ``test_flash_bwd_repeatable`` holds it)."""
    B, S, N, D = 2, 1024, 4, 64
    layout, block, causal = sparse_layout("fixed", N, S)
    plan = build_tile_plan(layout, block, S)
    rng = np.random.default_rng(23)
    q, k, v, do = (t(rng.normal(size=(B, S, N, D)), dev, dtype)
                   for _ in range(4))
    o, lse = reference_block_sparse_attention(q, k, v, plan, causal)
    a = block_sparse_attention_bwd(q, k, v, o, lse, do, plan, causal)
    b = block_sparse_attention_bwd(q, k, v, o, lse, do, plan, causal)
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    mag = block_sparse_attention_bwd_magnitude(q, k, v, o, lse, do, plan,
                                               causal)[0]
    bound = (torch.finfo(dtype).eps * a[0].float().abs() + 2.0 ** -20 * mag)
    assert bool(((a[0].float() - b[0].float()).abs() <= bound).all())


def hold_sparse_fwd(q, k, v, plan, causal, atol):
    """One forward call (one launch) against the plain version: o within
    atol + atol |plain|, the same key-less rows, lse likewise."""
    before = launch_counts()["block_sparse_attention_fwd"]
    o, lse = block_sparse_attention_fwd(q, k, v, plan, causal)
    torch.cuda.synchronize()
    assert launch_counts()["block_sparse_attention_fwd"] == before + 1
    ro, rlse = reference_block_sparse_attention(q, k, v, plan, causal)
    torch.testing.assert_close(o.float(), ro.float(), atol=atol, rtol=atol)
    live = torch.isfinite(rlse)
    assert torch.equal(torch.isfinite(lse), live)
    torch.testing.assert_close(lse[live], rlse[live], atol=atol, rtol=atol)
    return o, lse


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_block_sparse_fwd_repeatable(dev, D, dtype):
    """Two calls on the same inputs (the Fixed layout, causal, S 1024): o
    and lse bit-equal (each row's stages are summed by one block in a fixed
    order)."""
    B, S, N = 2, 1024, 4
    layout, block, causal = sparse_layout("fixed", N, S)
    plan = build_tile_plan(layout, block, S)
    rng = np.random.default_rng(29)
    q, k, v = (t(rng.normal(size=(B, S, N, D)), dev, dtype)
               for _ in range(3))
    a = block_sparse_attention_fwd(q, k, v, plan, causal)
    b = block_sparse_attention_fwd(q, k, v, plan, causal)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype,atol", ATTN[1:])
def test_block_sparse_fwd_partial_stage(dev, D, dtype, atol):
    """Lists whose live group counts are not multiples of 8 (1, 3, 5, 9 and
    13 groups: a stage's tail slots are never loaded), and V rows of large
    magnitude in every key row that no query sees, right after the live
    groups: o and lse as the plain version, causal and not."""
    B, S, N = 1, 512, 2
    n = S // 16
    layout = np.zeros((N, n, n), np.int64)
    counts = [1, 3, 5, 9, 13]
    for h in range(N):
        for i in range(n // 8):
            c = counts[(i + h) % len(counts)]
            cols = [(8 * i + 7 - 2 * a) % n for a in range(c)]
            layout[h, 8 * i:8 * i + 8, cols] = 1
    plan = build_tile_plan(layout, 16, S)
    _, scount = plan.stage_plan()
    assert (scount > 1).any()
    rng = np.random.default_rng(31)
    q, k, v = (rng.normal(size=(B, S, N, D)) for _ in range(3))
    seen = plan.token_mask(torch.device("cpu")).any(dim=1).numpy()  # (N, S)
    for h in range(N):
        v[:, ~seen[h], h] = 3e4
    q, k, v = (t(x, dev, dtype) for x in (q, k, v))
    for causal in (False, True):
        hold_sparse_fwd(q, k, v, plan, causal, atol)


@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("dtype,atol", ATTN[1:])
def test_block_sparse_fwd_keyless_rows(dev, D, dtype, atol):
    """Rows that see no key on the new route: a q-tile whose list is empty,
    and inside live q-tiles rows whose 16-row block sees nothing (with
    block 8 groups that are partly dead): o exactly 0 and lse -inf there,
    the rest as the plain version."""
    B, S, N = 2, 512, 2
    n = S // 8
    layout = np.tile(np.tril(np.ones((n, n), np.int64)), (N, 1, 1))
    layout[:, 16:32] = 0                 # q-tile 1: an empty list
    layout[0, 40:42] = 0                 # rows 320..335 of head 0
    layout[1, ::5, 1::2] = 0             # block-8 holes inside live groups
    plan = build_tile_plan(layout, 8, S)
    assert plan.kcount[:, 1].sum() == 0
    rng = np.random.default_rng(37)
    q, k, v = (t(rng.normal(size=(B, S, N, D)), dev, dtype)
               for _ in range(3))
    for causal in (False, True):
        o, lse = hold_sparse_fwd(q, k, v, plan, causal, atol)
        dead = torch.isneginf(lse)                          # (B, N, S)
        assert bool(dead[:, :, 128:256].all()) and bool(dead[:, 0, 320:336]
                                                        .all())
        assert (o.transpose(1, 2)[dead] == 0).all()


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,atol", ATTN[1:])
def test_block_sparse_fwd_long_lists(dev, D, causal, dtype, atol):
    """The Fixed layout at S 2048 (up to 16 tiles, 5 stages a list), 2
    heads, causal and bidirectional (the unidirectional layout's tiles
    above the diagonal under causality too)."""
    B, S, N = 2, 2048, 2
    layout, block, _ = sparse_layout("fixed", N, S)
    plan = build_tile_plan(layout, block, S)
    assert int(plan.stage_plan()[1].max()) == 5
    rng = np.random.default_rng(41 + D)
    q, k, v = (t(rng.normal(size=(B, S, N, D)), dev, dtype)
               for _ in range(3))
    hold_sparse_fwd(q, k, v, plan, causal, atol)


@pytest.mark.parametrize("sizes", [[1 << 20], [5, 8193, 3, 40000, 1],
                                   [2048 * 2048 * 3 + 7, 2048]])
@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16,
                                        torch.float16])
@pytest.mark.parametrize("extras", [False, True])
def test_lamb_phase1_matches_plain(dev, sizes, grad_dtype, extras):
    """The phase-1 kernel against its plain version over segments whose
    starts are not 4-element aligned (their blocks take the scalar path),
    then the whole step with its 16-bit copy."""
    seg = LambSegments.from_sizes(sizes)
    n = seg.n
    rng = np.random.default_rng(n)
    p, m = (t(rng.normal(size=n), dev, torch.float32) for _ in range(2))
    v = t(rng.uniform(0, 1, n), dev, torch.float32)
    g = t(rng.normal(size=n), dev, grad_dtype)
    kw = dict(weight_decay=0.01)
    if extras:
        kw.update(grad_scale=torch.tensor([0.37], device=dev),
                  skip=torch.tensor([False], device=dev))
    bufs = [[x.clone() for x in (p, m, v, torch.zeros_like(p))]
            for _ in range(2)]
    before = launch_counts()["fused_lamb"]
    part = lamb_phase1(bufs[0][0], g, *bufs[0][1:], seg, 3, **kw)
    torch.cuda.synchronize()
    assert launch_counts()["fused_lamb"] == before + 1
    ref = reference_lamb_phase1(bufs[1][0], g, *bufs[1][1:], seg, 3, **kw)
    for a, b in zip(bufs[0][1:], bufs[1][1:]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(part, ref, atol=1e-3, rtol=1e-5)
    copies = [torch.empty(n, dtype=torch.bfloat16, device=dev)
              for _ in range(2)]
    ratios = [lamb_step(b[0], g, *b[1:], seg, 4, 1e-2, param_copy=c,
                        plain=i == 1, **kw)
              for i, (b, c) in enumerate(zip(bufs, copies))]
    torch.testing.assert_close(ratios[0], ratios[1], atol=0, rtol=1e-5)
    torch.testing.assert_close(bufs[0][0], bufs[1][0], atol=1e-6, rtol=1e-5)
    for b, c in zip(bufs, copies):       # each copy: its own params rounded
        assert torch.equal(c, b[0].bfloat16())


def test_lamb_skip_writes_nothing(dev):
    seg = LambSegments.from_sizes([4099, 77])
    p, g, m = (torch.randn(seg.n, device=dev) for _ in range(3))
    v, u = torch.rand(seg.n, device=dev), torch.randn(seg.n, device=dev)
    copy = p.bfloat16()
    snap = [x.clone() for x in (p, m, v, copy)]
    lamb_step(p, g, m, v, u, seg, 1, 1e-2, param_copy=copy,
              skip=torch.tensor([True], device=dev))
    for a, b in zip((p, m, v, copy), snap):
        assert torch.equal(a, b)
    assert (u == 0).all()


# ---------------------------------------------------------------------------
# GroupNorm over NHWC tokens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,HW,C,G", [
    (2, 256, 64, 8), (1, 1024, 96, 12), (3, 640, 128, 32), (2, 100, 24, 8),
    (1, 77, 40, 1), (2, 33, 60, 20), (4, 4096, 512, 32), (1, 262144, 128, 32),
    (3, 1000, 256, 32), (4, 1024, 512, 32)])
@pytest.mark.parametrize("dtype,atol", LOW + [(torch.float16, 4e-3)])
@pytest.mark.parametrize("affine_f32", [False, True])
def test_group_norm_matches_plain(dev, B, HW, C, G, dtype, atol, affine_f32):
    rng = np.random.default_rng(B * HW + C)
    x = t(rng.normal(size=(B, HW, C)) * 3 + 1, dev, dtype)
    adt = torch.float32 if affine_f32 else dtype
    scale = t(rng.normal(size=C) * 0.1 + 1, dev, adt)
    bias = t(rng.normal(size=C) * 0.1, dev, adt)
    before = launch_counts()["fused_group_norm"]
    got = fused_group_norm(x, scale, bias, G, eps=1e-6)
    torch.cuda.synchronize()
    assert launch_counts()["fused_group_norm"] == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    ref = reference_group_norm(x, scale, bias, G, eps=1e-6)
    torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                               rtol=atol)


def test_group_norm_stress_input_against_float64(dev):
    B, HW, C, G = 4, 4096, 512, 32
    gen = torch.Generator(device=dev).manual_seed(0)
    x = 300 + 0.01 * torch.randn(B, HW, C, generator=gen, device=dev)
    scale, bias = torch.ones(C, device=dev), torch.zeros(C, device=dev)
    got = fused_group_norm(x, scale, bias, G)
    xg = x.double().reshape(B, HW, G, C // G)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    want = ((xg - mean) / torch.sqrt(var + 1e-5)).reshape(B, HW, C)
    assert torch.isfinite(got).all()
    assert float((got.double() - want).abs().max()) <= 1e-2


def test_group_norm_resident_stress_against_float64(dev):
    """The resident route in fp32 (4 x 2048 rows of 512: 63 rows a block)
    on 300 + 0.01 N(0, 1), as the streaming route above."""
    B, HW, C, G = 4, 2048, 512, 32
    assert gn_plan(B, HW, C, G, 4, sm_count(dev)).route == "resident"
    gen = torch.Generator(device=dev).manual_seed(1)
    x = 300 + 0.01 * torch.randn(B, HW, C, generator=gen, device=dev)
    scale, bias = torch.ones(C, device=dev), torch.zeros(C, device=dev)
    got = fused_group_norm(x, scale, bias, G)
    xg = x.double().reshape(B, HW, G, C // G)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    want = ((xg - mean) / torch.sqrt(var + 1e-5)).reshape(B, HW, C)
    assert torch.isfinite(got).all()
    assert float((got.double() - want).abs().max()) <= 1e-2


def sm_count(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def gn_operands(dev, B, HW, C, dtype, seed):
    rng = np.random.default_rng(seed)
    x = t(rng.normal(size=(B, HW, C)) * 3 + 1, dev, dtype)
    scale = t(rng.normal(size=C) * 0.1 + 1, dev, dtype)
    bias = t(rng.normal(size=C) * 0.1, dev, dtype)
    return x, scale, bias


def same_bits(a, b):
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


# (B, HW, C, G, dtype): the VAE mid block in bf16 and fp16 (resident, 33
# blocks a row), rows that do not divide the blocks (resident), fp32 at the
# mid block and the 512 x 512 up block (streaming)
GN_REPEAT = [(4, 4096, 512, 32, torch.bfloat16),
             (4, 4096, 512, 32, torch.float16),
             (3, 1000, 256, 32, torch.float32),
             (4, 4096, 512, 32, torch.float32),
             (1, 262144, 128, 32, torch.bfloat16)]


@pytest.mark.parametrize("B,HW,C,G,dtype", GN_REPEAT)
def test_group_norm_repeatable(dev, B, HW, C, G, dtype):
    """Equal bits in two eager calls and in every call of a CUDA graph of
    three, replayed three times: the resident kernel's arrival counters are
    0 again after each launch (a counter left dirty by a replay would
    release the next barrier early, or trap at its timeout)."""
    x, scale, bias = gn_operands(dev, B, HW, C, dtype, B * HW)
    a = fused_group_norm(x, scale, bias, G, eps=1e-6)
    b = fused_group_norm(x, scale, bias, G, eps=1e-6)
    assert same_bits(a, b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fused_group_norm(x, scale, bias, G, eps=1e-6)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fused_group_norm(x, scale, bias, G, eps=1e-6)
                for _ in range(3)]
    for _ in range(3):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(same_bits(a, o) for o in outs)
    assert same_bits(a, fused_group_norm(x, scale, bias, G, eps=1e-6))


def test_group_norm_two_streams(dev):
    """Resident calls on two streams at once, each stream with its own
    arrival counters: every output equals the eager one."""
    x, scale, bias = gn_operands(dev, 4, 4096, 512, torch.bfloat16, 7)
    want = fused_group_norm(x, scale, bias, 32, eps=1e-6)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    torch.cuda.synchronize()
    for _ in range(8):
        for st in streams:
            with torch.cuda.stream(st):
                outs.append(fused_group_norm(x, scale, bias, 32, eps=1e-6))
    torch.cuda.synchronize()
    assert all(same_bits(want, o) for o in outs)


GN_ROUTE_PROFILE = """
import json, sys
import torch
from deepspeed_tpu_torch.ops import fused_group_norm
dev, dtype = torch.device("cuda"), getattr(torch, sys.argv[1])
operands = []
for B, HW, C, G, offset in json.loads(sys.argv[2]):
    base = torch.randn(B * HW * C + offset, device=dev).to(dtype)
    operands.append((base[offset:].view(B, HW, C),
                     torch.rand(C, device=dev) + 0.5,
                     torch.randn(C, device=dev), G))
for x, scale, bias, G in operands:
    fused_group_norm(x, scale, bias, G)                  # build and bind
torch.cuda.synchronize()
with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    for x, scale, bias, G in operands:
        fused_group_norm(x, scale, bias, G)
    torch.cuda.synchronize()
print(json.dumps([e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]))
"""
# (B, HW, C, G, offset in elements): the VAE mid block, rows that do not
# divide the blocks, the 512 x 512 up block, a view one element in
GN_ROUTE_SHAPES = [(4, 4096, 512, 32, 0), (3, 1000, 256, 32, 0),
                   (1, 262144, 128, 32, 0), (2, 64, 32, 8, 1)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_group_norm_launches_its_route(dev, dtype):
    """One device kernel a call, ``gn_resident_kernel``, where ``gn_plan``
    takes the resident route (the VAE mid block in bf16: x read once and y
    written once); ``gn_stats_kernel`` then ``gn_apply_kernel`` elsewhere
    (fp32 at the mid block, the 512 x 512 up block, an unaligned view).
    Profiled in a process of its own, as the norm's route test."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = subprocess.run(
        [sys.executable, "-c", GN_ROUTE_PROFILE, str(dtype).split(".")[1],
         json.dumps(GN_ROUTE_SHAPES)], cwd=root, env=env,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    names = json.loads(out.stdout.strip().splitlines()[-1])
    item = torch.tensor([], dtype=dtype).element_size()
    want = []
    for B, HW, C, G, offset in GN_ROUTE_SHAPES:
        plan = gn_plan(B, HW, C, G, item, sm_count(dev),
                       None if offset == 0 else 1)
        want += (["gn_resident_kernel"] if plan.route == "resident"
                 else ["gn_stats_kernel", "gn_apply_kernel"])
    assert want[0] == ("gn_resident_kernel" if item == 2
                       else "gn_stats_kernel")
    assert len(names) == len(want), names
    assert all(w in n for w, n in zip(want, names)), names


def test_group_norm_unaligned_view_takes_narrow_loads(dev):
    base = torch.randn(2 * 64 * 32 + 1, device=dev)
    x = base[1:].view(2, 64, 32)
    scale, bias = torch.rand(32, device=dev) + 0.5, torch.randn(32, device=dev)
    got = fused_group_norm(x, scale, bias, 8)
    ref = reference_group_norm(x, scale, bias, 8)
    torch.testing.assert_close(got, ref, atol=2e-5, rtol=2e-5)


def test_group_norm_rejects_bad_operands(dev):
    x = torch.zeros(1, 16, 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                     # affine dtype
        fused_group_norm(x, torch.ones(32, device=dev, dtype=torch.float16),
                         torch.zeros(32, device=dev, dtype=torch.float16), 8)
    with pytest.raises(ValueError):                     # affine shape
        fused_group_norm(x, torch.ones(16, device=dev),
                         torch.zeros(16, device=dev), 8)
    strided = torch.zeros(1, 16, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                     # not contiguous
        fused_group_norm(strided[:, :, ::2], torch.ones(32, device=dev),
                         torch.zeros(32, device=dev), 8)


# ---------------------------------------------------------------------------
# group quantization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("groups,group_size", [(1000, 128), (777, 64),
                                               (13, 100), (5, 4096),
                                               (1, 8), (3000, 2)])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_quantize_bit_identical_to_plain(dev, groups, group_size, bits,
                                         dtype):
    n = groups * group_size
    gen = torch.Generator(device=dev).manual_seed(n + bits)
    x = (torch.randn(n, generator=gen, device=dev) * 2).to(dtype)
    x[:group_size] = 0                                  # a zero group
    if groups > 2:                                      # exact .5 ties
        qmax = 2 ** (bits - 1) - 1
        tie = torch.arange(group_size, device=dev) % (2 * qmax) - qmax + 0.5
        tie[-1] = qmax
        x[group_size:2 * group_size] = tie.to(dtype)
    before = launch_counts()["quantize_symmetric"]
    q, s = quantize_symmetric(x, bits, group_size)
    torch.cuda.synchronize()
    assert launch_counts()["quantize_symmetric"] == before + 1
    qr, sr = reference_quantize_symmetric(x, bits, group_size)
    assert q.dtype == torch.int8 and s.shape == (groups,)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert s[0] == 1 and not q[:group_size].any()


def test_quantize_unaligned_view_takes_scalar_loads(dev):
    base = torch.randn(128 * 50 + 1, device=dev, dtype=torch.bfloat16)
    x = base[1:]
    q, s = quantize_symmetric(x, 8, 128)
    qr, sr = reference_quantize_symmetric(x, 8, 128)
    assert torch.equal(q, qr) and torch.equal(s, sr)


def test_fake_quantize_on_the_card(dev):
    w = torch.randn(300, 70, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    g = torch.randn(300, 70, device=dev, dtype=torch.bfloat16)
    y = fake_quantize(w, bits=8, group_size=128)
    y.backward(g)
    assert torch.equal(w.grad, g)
    flat = torch.nn.functional.pad(w.detach().reshape(-1), (0, 120))
    q, s = reference_quantize_symmetric(flat, 8, 128)
    want = (q.reshape(-1, 128).float() * s[:, None]).reshape(-1)[:21000]
    assert torch.equal(y.detach().reshape(-1), want.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# flash forward above head_dim 256
# ---------------------------------------------------------------------------

# (B, S, T, N, K, D): the VAE mid block's single head of 512 (self and
# cross attention, ragged edges), GQA, D 264 (not a multiple of 16) and 300
# (16-bit: the CUDA-core path); then the mid block's path shape, with only
# the plain non-causal flags
WIDE_SHAPES = [(2, 256, 256, 1, 1, 512), (1, 100, 77, 1, 1, 512),
               (2, 70, 130, 4, 2, 512), (1, 48, 65, 2, 1, 264),
               (1, 33, 40, 2, 2, 300), (4, 4096, 4096, 1, 1, 512)]


@pytest.mark.parametrize("B,S,T,N,K,D,causal,use_alibi,dtype,atol", [
    p for p in attn_params(WIDE_SHAPES, [(False, False), (True, False),
                                         (False, True)])
    if p[1] < 4096 or p[6:8] == (False, False)])
def test_flash_wide_matches_plain(dev, B, S, T, N, K, D, causal, use_alibi,
                                  dtype, atol):
    rng = np.random.default_rng(S * T + D)
    mask = dense_mask(B, T, seed=T, lo=max(1, T // 4))
    k, v = dense_kv(B, T, K, D, mask, seed=D)
    q = rng.normal(size=(B, S, N, D))
    al = alibi_slopes(N, device=dev) if use_alibi else None
    args = (t(q, dev, dtype), t(k, dev, dtype), t(v, dev, dtype),
            t(mask, dev))
    before = launch_counts()["flash_attention"]
    got, lse = flash_attention(*args, causal=causal, alibi=al,
                               return_lse=True)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == before + 1
    ref, ref_lse = reference_flash_attention(*args, causal=causal, alibi=al,
                                             return_lse=True)
    hold_fwd(got, lse, ref, ref_lse, atol)


def test_flash_wide_backward_raises(dev):
    q, k, v = (torch.randn(1, 16, 1, 512, device=dev, dtype=torch.bfloat16,
                           requires_grad=True) for _ in range(3))
    out = flash_attention(q, k, v, causal=False)
    with pytest.raises(ValueError, match="backward kernels take head_dim"):
        out.sum().backward()
    with pytest.raises(ValueError, match="head_dim 640 > 512"):
        flash_attention(*(torch.zeros(1, 4, 1, 640, device=dev)
                          for _ in range(3)))


# ---------------------------------------------------------------------------
# the 1-bit exchange's quantizer, and optimizer-state offload, on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1000, 1 << 20])
def test_compressed_quantizer_codes_equal_the_cpu(dev, n):
    """``comm/compressed._quantize`` divides by the scale as a tensor, so
    the codes on the card are the CPU's bit for bit (a division by a Python
    number would become a product with its reciprocal there); the scales
    too, and the residuals within one rounding of the decoded value."""
    from deepspeed_tpu_torch.comm.compressed import _quantize

    g = torch.Generator().manual_seed(n)
    for v in (torch.randn(n, generator=g) * 3,
              torch.rand(n, generator=g) * 1e-3 - 5e-4,
              torch.zeros(n)):
        q_cpu, s_cpu, r_cpu = _quantize(v.clone())
        q_gpu, s_gpu, r_gpu = _quantize(v.to(dev))
        assert torch.equal(q_gpu.cpu(), q_cpu)
        assert torch.equal(s_gpu.cpu(), s_cpu)
        # the residual v - q * s: the card may fuse it into one rounding
        tol = 2 * float(torch.finfo(torch.float32).eps) * float(
            v.abs().max())
        assert float((r_gpu.cpu() - r_cpu).abs().max()) <= tol


def test_host_offload_trains_on_the_card(dev):
    """Two steps of ``tiny`` in bf16 under optimizer offload to host memory
    (sub-groups of 5000 elements, so the pipeline runs many): the master and
    moments stay CPU tensors, no Adam launch runs, the losses are finite,
    and the master equals the resident engine's fed the same grads within
    the fused Adam tolerance."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models import create_model

    model = create_model("tiny", dtype=torch.bfloat16, max_seq_len=64)
    base = {"train_micro_batch_size_per_gpu": 2, "bf16": {"enabled": True},
            "steps_per_print": 1000,
            "optimizer": {"type": "adamw",
                          "params": {"lr": 1e-3, "weight_decay": 0.01}}}
    off = initialize(model=model, config=dict(base, zero_optimization={
        "stage": 1, "sub_group_size": 5000,
        "offload_optimizer": {"device": "cpu"}}), device=dev)[0]
    res = initialize(model=model, config=base, device=dev)[0]
    st = off.opt_state
    ids = torch.randint(0, 250, (2, 64), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    before = launch_counts()["fused_adam"]
    for _ in range(2):
        loss = off.forward({"input_ids": ids})
        off.backward()
        res.forward({"input_ids": ids})
        res.backward()
        res.opt_state.grad_flat.copy_(st.grad_flat)
        off.step()
        res.step()
        assert torch.isfinite(loss)
    torch.cuda.synchronize()
    assert launch_counts()["fused_adam"] == before + 2    # the resident's
    assert all(t.device.type == "cpu"
               for t in (st.master, st.exp_avg, st.exp_avg_sq))
    assert len(st.offload.groups) > 3 and st.offload.stats["d2h_bytes"] > 0
    torch.testing.assert_close(st.master, res.opt_state.master.cpu(),
                               atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(off.zero.shard.float().cpu(),
                               res.zero.shard.float().cpu(), atol=2 ** -7,
                               rtol=2 ** -7)


def test_param_offload_trains_on_the_card(dev):
    """Two steps of ``tiny-llama`` (2 layers, bf16) under parameter offload
    to host memory, one layer a block: the fused Adam kernel launches once a
    block and once for the resident part a step, the fetches and write-backs
    run on the side stream (the host copying through its pinned buffers),
    the step's device work is timed, at most two blocks are on the card, the
    layer params and their fp32 state stay CPU tensors, and the first loss
    equals the resident stage-3 engine's from the same seed (the same draws,
    the same kernels) within 1e-5."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models import create_model

    model = create_model("tiny-llama", dtype=torch.bfloat16, max_seq_len=64)
    base = {"train_micro_batch_size_per_gpu": 2, "bf16": {"enabled": True},
            "steps_per_print": 1000,
            "optimizer": {"type": "adamw",
                          "params": {"lr": 1e-3, "weight_decay": 0.01}}}
    off = initialize(model=model, config=dict(base, zero_optimization={
        "stage": 3, "offload_param": {"device": "cpu", "buffer_size": 1}}),
        device=dev)[0]
    ex = off._param_offload
    ids = torch.randint(0, 250, (1, 2, 64), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    before = launch_counts()["fused_adam"]
    losses = [float(off.train_batch(batch={"input_ids": ids}))
              for _ in range(2)]
    torch.cuda.synchronize()
    assert ex.num_blocks == 2
    assert launch_counts()["fused_adam"] - before == 2 * (ex.num_blocks + 1)
    assert ex.staging.stream is not None
    assert ex.last_step_stats["side_stream_copies"] > 0
    assert ex.last_step_stats["device_busy_s"] > 0
    assert ex.last_step_stats["host_copy_s"] > 0
    assert ex.peak_live == 2 and all(np.isfinite(losses))
    assert all(t.device.type == "cpu"
               for t in ex.params + ex.master + ex.m + ex.v)
    res = initialize(model=model, config=dict(base, zero_optimization={
        "stage": 3}), device=dev)[0]
    first = float(res.train_batch(batch={"input_ids": ids}))
    assert abs(first - losses[0]) <= 1e-5 * abs(first)


@pytest.mark.parametrize("preset,widths", [
    ("tiny-llama", dict(hidden_size=512, ffn_hidden_size=2048, num_heads=8)),
    ("moe-tiny", dict(hidden_size=256))])
def test_param_offload_fills_new_buffers_after_main_stream_work(
        dev, preset, widths, monkeypatch):
    """The caching allocator may hand parameter offload's card buffers
    memory that main-stream work still queued was using; the side stream
    fills them only after that work. The first update's state buffers are
    made to take memory freed while a kernel queued behind a long sleep
    will still write NaN over it: the block state lands after that write,
    so two steps stay finite and every block's fp32 master equals an
    undelayed run's within two Adam steps (4 x lr: the flash backward's dq
    is not bit-repeatable)."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models import create_model

    lr = 1e-3
    model = create_model(preset, dtype=torch.bfloat16, max_seq_len=64,
                         **widths)
    config = {"train_micro_batch_size_per_gpu": 2, "bf16": {"enabled": True},
              "steps_per_print": 1000,
              "optimizer": {"type": "adamw",
                            "params": {"lr": lr, "weight_decay": 0.01}},
              "zero_optimization": {"stage": 3, "offload_param": {
                  "device": "cpu", "buffer_size": 1}}}
    ids = torch.randint(0, 250, (1, 2, 64), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    runs = []
    for delayed in (False, True):
        eng = initialize(model=model, config=config, device=dev)[0]
        ex = eng._param_offload
        freed = []
        if delayed:
            real = ex._state_on_card

            def late(n, acc):
                if ex._dev_state is None:
                    torch.cuda.synchronize()
                    torch.cuda.empty_cache()
                    junk = torch.empty(3 * ex.max_block, dtype=torch.float32,
                                       device=dev)
                    freed.append(junk.data_ptr())
                    torch.cuda._sleep(500_000_000)
                    junk.fill_(float("nan"))
                    del junk
                return real(n, acc)

            monkeypatch.setattr(ex, "_state_on_card", late)
        losses = [float(eng.train_batch(batch={"input_ids": ids}))
                  for _ in range(2)]
        torch.cuda.synchronize()
        if delayed:
            assert ex._dev_state[0].data_ptr() == freed[0], \
                "the state buffers did not take the freed memory"
        runs.append((losses, [m.clone() for m in ex.master]))
        del eng, ex
    (_, base), (losses, late_masters) = runs
    assert all(np.isfinite(losses)), losses
    for want, got in zip(base, late_masters):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, atol=4 * lr, rtol=0)


# ---------------------------------------------------------------------------
# Mixture-of-Experts on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("top_k,impl", [(1, "sparse"), (2, "sparse"),
                                        (2, "einsum")])
def test_moe_mlp_on_the_card_reads_nothing_back(dev, top_k, impl):
    """``moe_mlp`` forward and backward on CUDA tensors with the CUDA sync
    debug mode set to error: no host read (no ``.item()``, ``nonzero`` or
    boolean-mask indexing), so a decode loop that routes never waits; the
    values and gradients equal the CPU's within fp32 tolerance."""
    from deepspeed_tpu_torch.parallel import moe

    rng = np.random.default_rng(top_k)
    E, H, Fd = 8, 64, 128
    host = [rng.normal(size=(2, 96, H)), 0.5 * rng.normal(size=(H, E)),
            0.1 * rng.normal(size=(E, H, Fd)),
            0.1 * rng.normal(size=(E, Fd, H))]
    results = []
    for device in (dev, torch.device("cpu")):
        x, router, w_up, w_down = (t(a, device, torch.float32).requires_grad_()
                                   for a in host)
        torch.cuda.set_sync_debug_mode("error" if device.type == "cuda"
                                       else "default")
        try:
            out, aux = moe.moe_mlp(x, router, {"w_up": w_up, "w_down": w_down},
                                   "gelu", top_k=top_k, capacity_factor=1.0,
                                   dispatch_impl=impl)
            (out.square().sum() + aux).backward()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        results.append([a.detach().cpu() for a in
                        (out, x.grad, router.grad, w_up.grad, w_down.grad)])
    for got, want in zip(*results):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_moe_trains_generates_and_serves_on_the_card(dev):
    """``moe-tiny`` in bf16 on the card: two training steps launch the
    train path's kernels exactly (flash forward and backward a layer, two
    norms a layer and the final one, one Adam launch a step); ``generate``
    launches the flash, decode and norm kernels; serving launches the paged
    kernels; every token is in the vocabulary."""
    from deepspeed_tpu_torch import initialize, init_inference
    from deepspeed_tpu_torch.models import create_model
    from deepspeed_tpu_torch.serving import ServingConfig, ServingEngine

    model = create_model("moe-tiny", dtype=torch.bfloat16, max_seq_len=64)
    eng = initialize(model=model, config={
        "train_micro_batch_size_per_gpu": 2, "bf16": {"enabled": True},
        "steps_per_print": 1000,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}},
        device=dev)[0]
    ids = torch.randint(0, 250, (1, 2, 64), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    before = launch_counts()
    losses = [float(eng.train_batch(batch={"input_ids": ids}))
              for _ in range(2)]
    after = launch_counts()
    L = model.config.num_layers
    want = {"flash_attention": L, "flash_attention_bwd": L,
            "fused_layer_norm": 2 * L + 1, "fused_adam": 1}
    assert {k: after[k] - before[k] for k in want} == {
        k: 2 * v for k, v in want.items()}
    assert all(np.isfinite(losses))
    inf = init_inference("moe-tiny", dtype=torch.bfloat16, device=dev)
    before = launch_counts()
    out = inf.generate(torch.randint(0, 250, (3, 20)), max_new_tokens=5)
    after = launch_counts()
    for name in ("flash_attention", "decode_attention", "fused_layer_norm"):
        assert after[name] > before[name], name
    assert out.shape == (3, 5) and int(out.max()) < 256
    srv = ServingEngine(inf, ServingConfig(block_size=8, num_blocks=24,
                                           max_seqs=4, max_model_len=64,
                                           prefill_chunk=16))
    before = launch_counts()
    hs = [srv.submit(np.arange(n) % 250, max_new_tokens=4)
          for n in (5, 23, 40)]
    srv.run()
    after = launch_counts()
    for name in ("paged_decode_attention", "paged_prefill_attention"):
        assert after[name] > before[name], name
    assert all(len(h.tokens) == 4 and max(h.tokens) < 256 for h in hs)
