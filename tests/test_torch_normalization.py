"""Fused LayerNorm / RMSNorm: the port against the JAX package.

On the CPU ``deepspeed_tpu_torch.ops.fused_layer_norm`` runs its plain
version; it is held against the JAX Pallas kernel run in interpret mode (it
still runs under this jax) and against JAX ``reference_layer_norm``. Row
counts are not multiples of the TPU kernel's 128-row block. Tolerances:
fp32 ``atol=rtol=2e-5`` (the same statistics summed in another order);
bf16 ``atol=2e-2`` (one bf16 rounding of outputs of size ~3).

The card's route is planned here on host integers: ``ln_plan`` at the
main paths' shapes (llama-7b's decode and prefill rows, generate's static
prefill, OPT-1.3B's training rows), at 1 row, at row counts that are not a
multiple of a block's rows, and at H at and just past the register route's
limit, with every row assigned to exactly one (block, group). A plain-torch
emulation of ``ln_rows_kernel``'s arithmetic (each thread's partial sums in
the plan's lane order, the warp's xor butterfly, the warps' totals in warp
order, the two-pass variance from those partials) is held against the JAX
kernel and reference within ``atol=rtol=2e-5`` (fp32), also on rows of 300
+ 0.01 N(0, 1) on a dyadic grid at H 128 and 256, where every sum is exact
in fp32 (so all three take the same mean) and a one-pass variance cancels;
off the
grid, at H 4096, against float64 within 1e-2 (an fp32 mean near 300 is off
by an ulp or two, 3e-5 each, which 1 / std = 100 scales to ~3e-3 each).

The CUDA kernel is held against the plain version on the card by
``tests/test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.normalization import \
    fused_layer_norm as jax_fused_layer_norm
from deepspeed_tpu.ops.normalization import \
    reference_layer_norm as jax_reference_layer_norm
from deepspeed_tpu_torch.ops import (fused_layer_norm, launch_counts,
                                     reference_layer_norm)
from deepspeed_tpu_torch.ops.normalization import (LN_BLOCK_THREADS,
                                                   LN_MAX_ROW_VECTORS,
                                                   LnPlan, ln_plan,
                                                   plan_rows)


CASES = [  # (rows, H, rms, bias)
    (5, 64, False, True),
    (130, 96, False, False),
    (7, 64, True, False),
    (257, 40, True, False),
    (1, 72, False, True),
]


def inputs(rows, H, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, 2.0, (rows, H)) + rng.normal(0, 1.0, (1, H))
         ).astype(np.float32)
    scale = rng.normal(1.0, 0.3, (H,)).astype(np.float32)
    bias = rng.normal(0.0, 0.3, (H,)).astype(np.float32)
    return x, scale, bias


def run_port(x, scale, bias, rms, dtype, device="cpu"):
    t = lambda a: torch.from_numpy(a).to(device=device, dtype=dtype)  # noqa
    out = fused_layer_norm(t(x), t(scale), t(bias) if bias is not None
                           else None, 1e-5, rms)
    return out.float().cpu().numpy()


@pytest.mark.parametrize("rows,H,rms,use_bias", CASES)
def test_fp32_matches_jax_kernel_and_reference(rows, H, rms, use_bias):
    x, scale, bias = inputs(rows, H)
    b = bias if use_bias else None
    got = run_port(x, scale, b, rms, torch.float32)
    kern = np.asarray(jax_fused_layer_norm(
        jnp.asarray(x), jnp.asarray(scale),
        None if b is None else jnp.asarray(b), 1e-5, rms, True))
    ref = np.asarray(jax_reference_layer_norm(
        jnp.asarray(x), jnp.asarray(scale),
        None if b is None else jnp.asarray(b), 1e-5, rms))
    np.testing.assert_allclose(got, kern, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("rows,H,rms,use_bias", CASES)
def test_bf16_matches_jax_kernel(rows, H, rms, use_bias):
    x, scale, bias = inputs(rows, H, seed=1)
    b = bias if use_bias else None
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa
    kern = np.asarray(jax_fused_layer_norm(
        bf(x), bf(scale), None if b is None else bf(b), 1e-5, rms,
        True).astype(jnp.float32))
    got = run_port(x, scale, b, rms, torch.bfloat16)
    np.testing.assert_allclose(got, kern, atol=2e-2, rtol=0)


def test_rms_ignores_bias_and_leading_dims():
    x, scale, bias = inputs(12, 64, seed=2)
    x3 = torch.from_numpy(x).reshape(3, 4, 64)
    a = fused_layer_norm(x3, torch.from_numpy(scale), torch.from_numpy(bias),
                         1e-6, True)
    b = reference_layer_norm(x3, torch.from_numpy(scale), None, 1e-6, True)
    assert a.shape == (3, 4, 64)
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_cpu_path_counts_no_launch():
    before = launch_counts()["fused_layer_norm"]
    x, scale, bias = inputs(3, 64)
    run_port(x, scale, bias, False, torch.float32)
    assert launch_counts()["fused_layer_norm"] == before


# ---------------------------------------------------------------------------
# ln_plan: the card's launch shape, from host integers
# ---------------------------------------------------------------------------

SMS = 132  # the H100's SMs

# (rows, H, itemsize) -> the plan at the main paths' shapes: decode's 8 rows
# and serve's 256-row prefill chunk take a block a row of 256 threads (2
# vectors a thread in bf16, 4 in fp32); generate's static prefill (4096 x
# 4096) and OPT-1.3B's training rows (4096 x 2048) take 4 vectors a thread
# on 4 blocks an SM that walk the rows
MAIN_PLANS = {
    (8, 4096, 2): LnPlan(2, 256, 1, 8),
    (8, 4096, 4): LnPlan(4, 256, 1, 8),
    (256, 4096, 2): LnPlan(2, 256, 1, 256),
    (256, 4096, 4): LnPlan(4, 256, 1, 256),
    (4096, 4096, 2): LnPlan(4, 128, 1, 528),
    (4096, 4096, 4): LnPlan(4, 256, 1, 528),
    (4096, 2048, 2): LnPlan(4, 64, 2, 528),
    (4096, 2048, 4): LnPlan(4, 128, 1, 528),
}


def check_plan(plan, rows, H, itemsize):
    """What ``dstt_layer_norm_fwd`` accepts (``rows_plan_ok``) and every
    row assigned to exactly one (block, group)."""
    V = 16 // itemsize
    assert plan.vectors in LN_BLOCK_THREADS
    tpr, rpb = plan.threads_per_row, plan.rows_per_block
    assert tpr % 32 == 0 and 32 <= tpr <= 512
    assert tpr * rpb <= LN_BLOCK_THREADS[plan.vectors]
    assert rpb <= 16 and (tpr == 32 or rpb <= 15)
    assert tpr * plan.vectors * V >= H > (tpr - 32) * plan.vectors * V
    assert plan.blocks >= 1
    seen = sorted(r for rs in plan_rows(plan, rows).values() for r in rs)
    assert seen == list(range(rows))


@pytest.mark.parametrize("shape,plan", list(MAIN_PLANS.items()))
def test_ln_plan_main_path_shapes(shape, plan):
    rows, H, itemsize = shape
    assert ln_plan(rows, H, itemsize, SMS) == plan
    check_plan(plan, rows, H, itemsize)


@pytest.mark.parametrize("rows", [1, 2, 7, 8, 100, 255, 264, 265, 1000, 2049,
                                  4097])
@pytest.mark.parametrize("H,itemsize", [(768, 2), (2048, 2), (4096, 2),
                                        (5120, 2), (8192, 2), (768, 4),
                                        (4096, 4), (8192, 4)])
def test_ln_plan_assigns_every_row_once(rows, H, itemsize):
    plan = ln_plan(rows, H, itemsize, SMS)
    assert plan.vectors > 0, "H 768..8192 takes the register route"
    check_plan(plan, rows, H, itemsize)
    assert plan.blocks <= 4 * SMS
    if rows <= 4 * SMS:
        assert plan.rows_per_block == 1 and plan.blocks == rows
        assert plan.threads_per_row <= 256
    else:
        assert plan.threads_per_row * plan.rows_per_block >= 128


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("rows", [1, 8, 4096])
def test_ln_plan_limit_routes_to_scalar(itemsize, rows):
    V = 16 // itemsize
    limit = LN_MAX_ROW_VECTORS * V       # H 16384 in 16 bits, 8192 in fp32
    assert limit == (16384 if itemsize == 2 else 8192)
    at = ln_plan(rows, limit, itemsize, SMS)
    assert at.vectors > 0
    check_plan(at, rows, limit, itemsize)
    for H in (limit + V, limit + 1, 4099, 40, 1):
        if H % V == 0 and H <= limit:
            continue
        assert ln_plan(rows, H, itemsize, SMS) == LnPlan(0, 256, 1, rows)


def test_ln_plan_bits_of_a_row_do_not_depend_on_rows():
    """A row's lane order depends on its plan's vectors and threads a row
    only; both regimes meet the same rows at some counts, so the kernel's
    bits for one row may differ between the regimes (both are held
    against JAX below), never between grids of one regime."""
    few, many = ln_plan(8, 4096, 2, SMS), ln_plan(4096, 4096, 2, SMS)
    assert few.threads_per_row != many.threads_per_row
    assert ln_plan(4096, 4096, 2, SMS)[:3] == ln_plan(100000, 4096, 2,
                                                      SMS)[:3]


# ---------------------------------------------------------------------------
# an emulation of ln_rows_kernel's arithmetic, against JAX
# ---------------------------------------------------------------------------


def _fma(a, b, c):
    """fp32 fma(a, b, c) (the kernel's contracted multiply-adds): the
    product exact in float64, one rounding to fp32 (up to a rare double
    rounding)."""
    return (a.double() * b.double() + c.double()).float()


def _group_sum(part, tpr):
    """The kernel's ``group_sum`` over threads' partials (rows, tpr): each
    warp's xor butterfly (which leaves the same bits in every lane), then
    the warps' totals in warp order."""
    rows = part.shape[0]
    w = part.reshape(rows, tpr // 32, 32)
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        w = w + w[:, :, lane ^ o]
    assert bool((w == w[:, :, :1]).all())
    total = w[:, 0, 0]
    for i in range(1, tpr // 32):
        total = total + w[:, i, 0]
    return total


def emulate_ln_rows(x, scale, bias, eps, rms, plan, itemsize):
    """``ln_rows_kernel`` under ``plan`` on fp32 values laid out as
    ``itemsize``-byte elements: thread t holds vectors t, t + tpr, ... of
    16 / itemsize elements and sums its values in vector, then element
    order; ``_group_sum`` gives the row's total; the mean, then the centred
    sum of squares from the same registers; rsqrt as torch's (the card's
    rsqrtf is within 2 ulp of it)."""
    rows, H = x.shape
    V = 16 // itemsize
    nv, tpr = H // V, plan.threads_per_row
    xv = x.reshape(rows, nv, V)
    slots = [torch.arange(tpr) + k * tpr for k in range(plan.vectors)]

    def partials(term):
        acc = torch.zeros(rows, tpr)
        for idx in slots:
            ok = idx < nv
            for j in range(V):
                vals = torch.zeros(rows, tpr)
                vals[:, ok] = xv[:, idx[ok], j]
                acc = term(vals, acc, ok)
        return acc

    mean = torch.zeros(rows)
    if not rms:
        s = partials(lambda v, acc, ok: torch.where(ok, acc + v, acc))
        mean = _group_sum(s, tpr) / H
    ss = partials(lambda v, acc, ok: torch.where(
        ok, _fma(v - mean[:, None], v - mean[:, None], acc), acc))
    rstd = torch.rsqrt(_group_sum(ss, tpr) / H + eps)
    t = (x - mean[:, None]) * rstd[:, None]
    if bias is None or rms:
        return t * scale
    return _fma(t, scale.expand_as(t), bias.expand_as(t))


def jax_pair(x, scale, bias, rms, eps=1e-5):
    """JAX's interpreted kernel and its reference on the same fp32 values."""
    b = None if bias is None else jnp.asarray(bias)
    kern = np.asarray(jax_fused_layer_norm(
        jnp.asarray(x), jnp.asarray(scale), b, eps, rms, True))
    ref = np.asarray(jax_reference_layer_norm(
        jnp.asarray(x), jnp.asarray(scale), b, eps, rms))
    return kern, ref


# plans of both regimes at small widths: the planner on a card of `sms` SMs
# (on 1 SM, past 4 rows take the many-rows plan), and hand-made shapes of
# one to four warps a row
EMU_PLANS = [
    ("few", 3, 256, 4, 1), ("few", 4, 512, 2, 1), ("many", 48, 256, 4, 1),
    ("many", 130, 384, 2, 1), ("many", 257, 1024, 4, 1),
    ("hand", 9, 256, 4, LnPlan(2, 32, 16, 1)),
    ("hand", 9, 256, 4, LnPlan(1, 64, 8, 2)),
    ("hand", 33, 640, 2, LnPlan(4, 32, 4, 3)),
    ("hand", 33, 640, 2, LnPlan(1, 96, 5, 2)),
    ("hand", 6, 1024, 4, LnPlan(2, 128, 2, 1)),
]


def emu_plan(spec):
    kind, rows, H, itemsize, sms = spec
    plan = sms if isinstance(sms, LnPlan) else ln_plan(rows, H, itemsize,
                                                       sms)
    if kind == "few":
        assert plan.rows_per_block == 1 and plan.blocks == rows
    if kind == "many":
        assert plan.rows_per_block > 1
    check_plan(plan, rows, H, itemsize)
    return rows, H, itemsize, plan


@pytest.mark.parametrize("spec", EMU_PLANS,
                         ids=[f"{s[0]}-{s[1]}x{s[2]}-i{s[3]}-{k}"
                              for k, s in enumerate(EMU_PLANS)])
@pytest.mark.parametrize("rms,use_bias", [(False, True), (False, False),
                                          (True, False)])
def test_emulated_kernel_matches_jax(spec, rms, use_bias):
    rows, H, itemsize, plan = emu_plan(spec)
    x, scale, bias = inputs(rows, H, seed=rows + H)
    b = bias if use_bias else None
    got = emulate_ln_rows(torch.from_numpy(x), torch.from_numpy(scale),
                          None if b is None else torch.from_numpy(b), 1e-5,
                          rms, plan, itemsize).numpy()
    for want in jax_pair(x, scale, b, rms):
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def offset_rows(rows, H, seed, grid=None):
    """300 + 0.01 N(0, 1); on ``grid`` (a power of two) every fp32 sum of
    the row, its mean and its centred squares are exact in any order."""
    x = 300.0 + 0.01 * np.random.default_rng(seed).normal(size=(rows, H))
    if grid is not None:
        x = np.round(x / grid) * grid
    return x.astype(np.float32)


# H 128 and 256: every sum of a row stays below 2^24 steps of the grid, and
# H is a power of two, so the mean is exact too (whether a division or a
# product by 1 / H)
OFFSET_PLANS = [("few", 4, 128, 4, 1), ("many", 40, 256, 4, 1),
                ("hand", 7, 256, 4, LnPlan(1, 64, 3, 2))]


@pytest.mark.parametrize("spec", OFFSET_PLANS,
                         ids=["few-warp", "many-warp", "hand-2warps"])
@pytest.mark.parametrize("use_bias", [False, True])
def test_emulated_offset_rows_match_jax(spec, use_bias):
    """On the dyadic grid 2^-7 with H * 300 below 2^24 grid steps, every
    fp32 sum of a row is exact in any order, so the emulation, the JAX
    kernel and its reference take the same mean and agree within 2e-5 though
    std / mean = 3e-5; a one-pass variance E[x^2] - mean^2 is off by more
    than 10 times its true 1e-4."""
    rows, H, itemsize, plan = emu_plan(spec)
    x = offset_rows(rows, H, seed=H, grid=2.0 ** -7)
    rng = np.random.default_rng(3)
    scale = rng.normal(1.0, 0.1, H).astype(np.float32)
    bias = rng.normal(0.0, 0.1, H).astype(np.float32) if use_bias else None
    got = emulate_ln_rows(torch.from_numpy(x), torch.from_numpy(scale),
                          None if bias is None else torch.from_numpy(bias),
                          1e-5, False, plan, itemsize).numpy()
    for want in jax_pair(x, scale, bias, False):
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    x32 = torch.from_numpy(x)
    one_pass = (x32 * x32).mean(-1) - x32.mean(-1) ** 2
    true_var = torch.from_numpy(x.astype(np.float64)).var(-1,
                                                          unbiased=False)
    assert float((one_pass.double() - true_var).abs().max()) > 1e-3


@pytest.mark.parametrize("rows,itemsize", [(8, 2), (8, 4), (300, 2)])
def test_emulated_offset_rows_match_float64(rows, itemsize):
    """Off the grid at llama-7b's H 4096, under the card's plan: within
    1e-2 of a float64 norm (the module docstring's reason)."""
    H = 4096
    plan = ln_plan(rows, H, itemsize, SMS)
    check_plan(plan, rows, H, itemsize)
    x = offset_rows(rows, H, seed=rows)
    scale = np.random.default_rng(4).normal(1.0, 0.1, H).astype(np.float32)
    got = emulate_ln_rows(torch.from_numpy(x), torch.from_numpy(scale), None,
                          1e-5, False, plan, itemsize)
    x64 = torch.from_numpy(x).double()
    xc = x64 - x64.mean(-1, keepdim=True)
    want = xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + 1e-5) \
        * torch.from_numpy(scale).double()
    err = float((got.double() - want).abs().max())
    assert err < 1e-2, err
