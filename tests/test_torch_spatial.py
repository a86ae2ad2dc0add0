"""The spatial (diffusers) path: the port's ``ops/spatial.py`` and
``models/spatial.py`` against the JAX package on the CPU.

JAX's Pallas GroupNorm cannot be built by this jax at all, not even
interpreted (it asks for ``pltpu.TPUCompilerParams``), and JAX's flash
kernel neither, so the oracles are their jnp routes:
``reference_group_norm``, ``dot_product_attention`` and
``mid_block(use_kernel=False)``. On the CPU the port's ``fused_group_norm``
and the flash attention run their plain versions; ``plain=True`` takes
JAX's ``use_kernel=False`` route (``dot_product_attention``). Weights come
from JAX's ``init_mid_block`` and are carried across; inputs are drawn
with numpy. Tolerances: GroupNorm fp32 1e-5 (the same statistics in
another order), bf16 one bf16 rounding of outputs of size ~3 (2e-2); the
mid block fp32 2e-4, JAX's own bar against its torch oracle
(``tests/unit/test_spatial_model.py:70``). The stress input 300 +
0.01 N(0, 1), where the TPU kernel's one-pass variance cancels, is held
against float64 within 1e-2.

The card's GroupNorm route is planned here on host integers: ``gn_plan``
at the SD v1.5 VAE mid block (bf16: the resident route, 33 blocks a batch
row), at fp32 there, the decoder's 512 x 512 up block, rows of 120 bytes
and an unaligned view (the streaming route), at JAX's test shapes (the
resident route), and over a grid of shapes and SM counts with every (b,
row) in exactly one block, no block past ``GN_SMEM_BYTES`` and the plan
asking the device nothing. A plain-torch fp32 emulation of
``gn_resident_kernel``'s arithmetic (each thread's sums in its row and
element order, the group totals in lane order and an xor butterfly, the
block's mean and then its sum of squares about the rounded centre, Chan's
merge in block order) is held against JAX's reference at 2e-5 under
several plans, against float64 on 300 + 0.01 N(0, 1) within
GN_STRESS_TOL, and across splits of a batch row over 8..128 blocks, whose
statistics agree within 8 fp32 ulps.

The CUDA GroupNorm kernels and the flash forward at head_dim 512 are held
against these plain versions by ``tests/test_torch_cuda_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import spatial as jsp
from deepspeed_tpu.models.transformer import \
    dot_product_attention as jax_dot_product_attention
from deepspeed_tpu.ops.spatial import \
    reference_group_norm as jax_reference_group_norm
from deepspeed_tpu_torch.models import params_from_jax, params_to_numpy
from deepspeed_tpu_torch.models import spatial as psp
from deepspeed_tpu_torch.ops import (diffusers_attention, fused_group_norm,
                                     launch_counts, reference_group_norm)
from deepspeed_tpu_torch.ops.spatial import (APPLY_ROWS, GN_SMEM_BYTES,
                                             GN_THREADS, GnPlan, gn_plan,
                                             plan_block_rows, vec_cap)


def gn_inputs(B, HW, C, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, HW, C)) * 3 + 1).astype(np.float32)
    scale = (rng.normal(size=C) * 0.1 + 1).astype(np.float32)
    bias = (rng.normal(size=C) * 0.1).astype(np.float32)
    return x, scale, bias


def t(a, dtype=None):
    x = torch.from_numpy(np.array(a, dtype=np.float32))
    return x if dtype is None else x.to(dtype)


GN_SHAPES = [(2, 256, 64, 8), (1, 1024, 96, 12), (3, 640, 128, 32)]


@pytest.mark.parametrize("B,HW,C,G", GN_SHAPES)
def test_group_norm_fp32_matches_jax(B, HW, C, G):
    x, scale, bias = gn_inputs(B, HW, C)
    want = np.asarray(jax_reference_group_norm(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), G))
    for fn in (fused_group_norm, reference_group_norm):
        got = fn(t(x), t(scale), t(bias), G)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,HW,C,G", GN_SHAPES)
def test_group_norm_bf16_io(B, HW, C, G):
    x, scale, bias = gn_inputs(B, HW, C, seed=1)
    xb = t(x, torch.bfloat16)
    got = fused_group_norm(xb, t(scale), t(bias), G)
    assert got.dtype == torch.bfloat16
    want = jax_reference_group_norm(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(scale), jnp.asarray(bias), G)
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32), atol=2e-2,
                               rtol=2e-2)


def test_group_norm_default_eps_is_jax_default():
    x, scale, bias = gn_inputs(1, 16, 8, seed=2)
    x *= 1e-3                                  # var ~1e-5: eps matters
    want = np.asarray(jax_reference_group_norm(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 4))
    np.testing.assert_allclose(
        fused_group_norm(t(x), t(scale), t(bias), 4).numpy(), want,
        atol=1e-5, rtol=1e-5)


def test_group_norm_stress_input_against_float64():
    """x = 300 + 0.01 N(0, 1): |mean| / std = 3e4. A one-pass E[x^2] -
    mean^2 in fp32 cancels here; the two-pass statistics do not."""
    B, HW, C, G = 2, 4096, 64, 8
    rng = np.random.default_rng(3)
    x = (300 + 0.01 * rng.normal(size=(B, HW, C))).astype(np.float32)
    scale = np.ones(C, np.float32)
    bias = np.zeros(C, np.float32)
    xg = x.astype(np.float64).reshape(B, HW, G, C // G)
    mean = xg.mean(axis=(1, 3), keepdims=True)
    var = ((xg - mean) ** 2).mean(axis=(1, 3), keepdims=True)
    want = ((xg - mean) / np.sqrt(var + 1e-5)).reshape(B, HW, C)
    got = fused_group_norm(t(x), t(scale), t(bias), G).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-2


def test_group_norm_rejects_what_jax_rejects():
    x = torch.zeros(1, 64, 30)
    with pytest.raises(ValueError, match="divisible"):
        fused_group_norm(x, torch.ones(30), torch.zeros(30), 4)
    x = torch.zeros(1, 16, 258)
    with pytest.raises(ValueError, match="<= 128"):
        fused_group_norm(x, torch.ones(258), torch.zeros(258), 129)


@pytest.mark.parametrize("T", [256, 128])
def test_diffusers_attention_matches_jax_dense(T):
    """Self attention (T = S) and cross attention (kv from a text encoder
    of another length)."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 256, 4, 64)).astype(np.float32)
    k = rng.normal(size=(2, T, 4, 64)).astype(np.float32)
    v = rng.normal(size=(2, T, 4, 64)).astype(np.float32)
    got = diffusers_attention(t(q), t(k), t(v))
    assert got.shape == q.shape
    want = jax_dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), None, causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def jax_block(C, seed=0, shortcut=False):
    p = jax.tree.map(np.array,
                     jsp.init_mid_block(jax.random.PRNGKey(seed), C))
    if shortcut:
        rng = np.random.default_rng(seed + 100)
        for name in ("resnet1", "resnet2"):
            p[name]["shortcut"] = {
                "w": (rng.normal(size=(1, 1, C, C)) * 0.1).astype(np.float32),
                "b": (rng.normal(size=C) * 0.1).astype(np.float32)}
    return p


@pytest.mark.parametrize("C,HW", [(32, 8), (64, 8), (32, 16), (64, 16)])
def test_mid_block_matches_jax(C, HW):
    p = jax_block(C, seed=C + HW)
    x = np.random.default_rng(C * HW).normal(size=(2, HW, HW, C)
                                             ).astype(np.float32)
    want = np.asarray(jsp.mid_block(jnp.asarray(x),
                                    jax.tree.map(jnp.asarray, p), 8,
                                    use_kernel=False))
    tp = params_from_jax(p)
    for plain in (True, False):
        got = psp.mid_block(t(x), tp, 8, plain=plain)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)


def test_resnet_block_with_shortcut_matches_jax():
    C = 32
    p = jax_block(C, seed=5, shortcut=True)
    x = np.random.default_rng(6).normal(size=(2, 8, 8, C)).astype(np.float32)
    want = np.asarray(jsp.resnet_block(jnp.asarray(x),
                                       jax.tree.map(jnp.asarray,
                                                    p["resnet1"]),
                                       8, use_kernel=False))
    got = psp.resnet_block(t(x), params_from_jax(p["resnet1"]), 8)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)


def test_attention_block_matches_jax():
    C = 64
    p = jax_block(C, seed=7)["attn"]
    x = np.random.default_rng(8).normal(size=(2, 16, 16, C)).astype(
        np.float32)
    want = np.asarray(jsp.attention_block(jnp.asarray(x),
                                          jax.tree.map(jnp.asarray, p), 8,
                                          use_kernel=False))
    got = psp.attention_block(t(x), params_from_jax(p), 8)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("H,k,stride,padding", [
    (16, 3, 1, "SAME"), (16, 3, 2, "SAME"), (15, 3, 2, "SAME"),
    (16, 4, 2, "SAME"), (16, 3, 2, "VALID"), (9, 1, 1, "SAME")])
def test_conv2d_matches_lax_conv(H, k, stride, padding):
    rng = np.random.default_rng(H * k + stride)
    x = rng.normal(size=(2, H, H + 1, 8)).astype(np.float32)
    w = rng.normal(size=(k, k, 8, 12)).astype(np.float32)
    b = rng.normal(size=12).astype(np.float32)
    want = np.asarray(jsp.conv2d(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b), stride=stride,
                                 padding=padding))
    got = psp.conv2d(t(x), t(w), t(b), stride=stride, padding=padding)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_weight_round_trip():
    p = jax_block(32, seed=9, shortcut=True)
    tp = params_from_jax(p, device="cpu", dtype=torch.bfloat16)
    assert tp["attn"]["q"]["w"].dtype == torch.bfloat16
    tp32 = params_from_jax(p)
    assert tp32["resnet1"]["conv1"]["w"].dtype == torch.float32
    back = params_to_numpy(tp32)
    flat_a = jax.tree_util.tree_leaves_with_path(p)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b) == 30   # 2 x 10 resnet, 10 attn
    for path, a in flat_a:
        np.testing.assert_array_equal(a, flat_b[path], err_msg=str(path))


def test_init_mid_block_shapes_and_device():
    p = psp.init_mid_block(torch.Generator().manual_seed(0), 16, device="cpu")
    jp = jsp.init_mid_block(jax.random.PRNGKey(0), 16)
    ja = jax.tree_util.tree_leaves_with_path(jp)
    pa = dict(jax.tree_util.tree_leaves_with_path(p))
    assert len(ja) == len(pa)
    for path, a in ja:
        assert tuple(pa[path].shape) == a.shape, path
        assert pa[path].device.type == "cpu"
    assert abs(float(p["attn"]["q"]["w"].std()) - 0.1) < 0.02
    again = psp.init_mid_block(0, 16, device="cpu")
    assert torch.equal(again["resnet2"]["conv2"]["w"],
                       psp.init_mid_block(0, 16, device="cpu")[
                           "resnet2"]["conv2"]["w"])


def test_init_mid_block_needs_a_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        psp.init_mid_block(0, 16)


def test_cpu_mid_block_launches_no_kernel():
    p = psp.init_mid_block(1, 32, device="cpu")
    x = torch.randn(1, 8, 8, 32, generator=torch.Generator().manual_seed(2))
    before = launch_counts()
    out = psp.mid_block(x, p, 8)
    assert torch.isfinite(out).all()
    assert launch_counts() == before


# ---------------------------------------------------------------------------
# gn_plan: the card's route and launch shape, from host integers
# ---------------------------------------------------------------------------

SMS = 132  # the H100's SMs
# the SD v1.5 VAE decoder's mid block (64 x 64 latent, B 4) and its last up
# block at 512 x 512 (B 1, C 128)
VAE_MID = (4, 4096, 512, 32)
VAE_UP_512 = (1, 262144, 128, 32)
# 300 + 0.01 N(0, 1) against float64 (the module docstring's bar)
GN_STRESS_TOL = 1e-2


def check_gn_plan(plan, B, HW, C, G, itemsize, sms):
    """What ``dstt_group_norm_fwd`` accepts: every (b, row) in exactly one
    block; a resident block's rows within GN_SMEM_BYTES, its threads whole
    warps within GN_THREADS that cover lanes x C / vec, the grid within one
    block an SM (all resident at once)."""
    spans = plan_block_rows(plan, HW)
    assert spans[0][0] == 0 and spans[-1][1] == HW
    assert all(a < b for a, b in spans)
    assert all(spans[k][1] == spans[k + 1][0] for k in range(len(spans) - 1))
    assert (C // G) % plan.vec == 0 and plan.vec * itemsize <= 16
    if plan.route == "resident":
        assert plan.rows * C * itemsize <= GN_SMEM_BYTES
        assert plan.threads % 32 == 0 and plan.threads <= GN_THREADS
        assert plan.threads - 32 < plan.lanes * C // plan.vec <= plan.threads
        assert 1 <= plan.lanes <= plan.rows
        assert B * plan.blocks <= sms
        assert (C * itemsize) % 16 == 0
    else:
        assert plan.route == "streaming" and plan.rows == APPLY_ROWS


def test_gn_plan_vae_mid_takes_the_resident_route():
    """16-bit x at the VAE mid block: 33 blocks a batch row of 125 rows
    (the last 96), 125 KB a block, 8 rows a step of 512 threads."""
    for itemsize in (2,):
        plan = gn_plan(*VAE_MID, itemsize, SMS)
        assert plan == GnPlan("resident", 33, 125, 8, 8, 512)
        check_gn_plan(plan, *VAE_MID, itemsize, SMS)
        assert plan_block_rows(plan, 4096)[-1] == (4000, 4096)


@pytest.mark.parametrize("shape,itemsize", [
    (VAE_MID, 4), (VAE_UP_512, 2), (VAE_UP_512, 4), ((2, 33, 60, 20), 2)])
def test_gn_plan_over_capacity_takes_the_streaming_route(shape, itemsize):
    """fp32 at the mid block (250 KB a block), the 512 x 512 up block (67 MB
    in bf16: 508 KB a block) and rows of 120 bytes stream, with the
    parent's vector width."""
    plan = gn_plan(*shape, itemsize, SMS)
    assert plan.route == "streaming"
    check_gn_plan(plan, *shape, itemsize, SMS)
    cg = shape[2] // shape[3]
    assert plan.vec == min(16 // itemsize, cg & -cg)


@pytest.mark.parametrize("shape,itemsize,blocks", [
    ((2, 256, 64, 8), 2, 4), ((2, 256, 64, 8), 4, 8),
    ((1, 1024, 96, 12), 2, 24),
    ((1, 4096, 512, 32), 2, 64), ((4, 1024, 512, 32), 2, 32),
    ((1, 8192, 1280, 32), 2, 103)])
def test_gn_plan_blocks_a_batch_row(shape, itemsize, blocks):
    """A block for each GN_MIN_BLOCK_BYTES of a batch row's x (32 KB: 4
    blocks), at most GN_MAX_ROW_BLOCKS (4 MB: 64) unless the rows need more
    to fit (20 MB: 103 blocks of 200 KB), at most sms // B (4 x 1 MB: 32)."""
    plan = gn_plan(*shape, itemsize, SMS)
    assert plan.route == "resident" and plan.blocks == blocks
    check_gn_plan(plan, *shape, itemsize, SMS)


def test_gn_plan_unaligned_view_streams():
    base = torch.zeros(2 * 64 * 32 + 1)
    x = base[1:].view(2, 64, 32)
    scale, bias = torch.ones(32), torch.zeros(32)
    cap = vec_cap(x, torch.empty_like(x), scale, bias)
    assert cap == 1
    plan = gn_plan(2, 64, 32, 8, 4, SMS, cap)
    assert plan.route == "streaming" and plan.vec == 1
    assert gn_plan(2, 64, 32, 8, 4, SMS).route == "resident"


@pytest.mark.parametrize("B,HW,C,G", GN_SHAPES)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_gn_plan_jax_shapes_take_the_resident_route(B, HW, C, G, itemsize):
    plan = gn_plan(B, HW, C, G, itemsize, SMS)
    assert plan.route == "resident"
    check_gn_plan(plan, B, HW, C, G, itemsize, SMS)


@pytest.mark.parametrize("sms", [1, 7, 66, 132, 144])
@pytest.mark.parametrize("B,HW,C,G", [
    (1, 1, 8, 1), (1, 77, 40, 1), (2, 100, 24, 8), (3, 1000, 256, 32),
    (4, 4096, 512, 32), (4, 4095, 512, 32), (5, 3000, 320, 32),
    (2, 1024, 1280, 32), (8, 16384, 64, 32), (1, 262144, 128, 32)])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_gn_plan_assigns_every_row_once(sms, B, HW, C, G, itemsize):
    plan = gn_plan(B, HW, C, G, itemsize, sms)
    if B > sms:
        assert plan.route == "streaming"
    check_gn_plan(plan, B, HW, C, G, itemsize, sms)


def test_gn_plan_reads_only_host_integers(monkeypatch):
    """The plan asks the device nothing: it runs with CUDA calls broken and
    gives the same plan of plain ints for numpy integers."""
    def no_device(*args, **kwargs):
        raise AssertionError("gn_plan queried the device")
    for name in ("is_available", "get_device_properties", "current_device",
                 "current_stream", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, no_device)
    for shape, itemsize in ((VAE_MID, 2), (VAE_MID, 4), (VAE_UP_512, 2)):
        plan = gn_plan(*shape, itemsize, SMS)
        assert plan == gn_plan(*(np.int64(v) for v in shape),
                               np.int64(itemsize), np.int64(SMS))
        assert isinstance(plan.route, str)
        assert all(type(v) is int for v in plan[1:])


# ---------------------------------------------------------------------------
# an emulation of gn_resident_kernel's arithmetic, against JAX
# ---------------------------------------------------------------------------


def _group_totals(part, G, vpg, lanes):
    """The kernel's ``group_totals`` over the threads' partials (lanes,
    C / vec): a group's lanes * vpg partials in (row lane, vector) order,
    lane l of a warp summing l, l + 32, ..., then the xor butterfly."""
    ncv = part.shape[1]
    P = lanes * vpg
    per = part.reshape(lanes, G, vpg).permute(1, 0, 2).reshape(G, P)
    per = torch.nn.functional.pad(per, (0, (-P) % 32)).reshape(G, -1, 32)
    s = torch.zeros(G, 32)
    for k in range(per.shape[1]):
        s = s + per[:, k]
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, lane ^ o]
    assert bool((s == s[:, :1]).all()) and ncv == G * vpg
    return s[:, 0]


def _thread_sums(xs, lanes, term):
    """Each thread's fp32 sum of term(values) over its rows (row lane l:
    rows l, l + lanes, ...) in row, then element order: (lanes, C / vec)."""
    rows, ncv, V = xs.shape
    acc = torch.zeros(lanes, ncv)
    for r0 in range(0, rows, lanes):
        idx = torch.arange(r0, r0 + lanes)
        ok = (idx < rows)[:, None]
        vals = xs[idx.clamp(max=rows - 1)]
        for i in range(V):
            acc = torch.where(ok, acc + term(vals[:, :, i]), acc)
    return acc


def _two_sum(a, b):
    """fp32 s = fl(a + b) and its exact rounding error (the kernel's
    ``two_sum``)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def emulate_resident(x, scale, bias, G, plan, eps=1e-5, stats=False,
                     merge=torch.float64):
    """``gn_resident_kernel`` under ``plan`` on fp32 values: per block the
    mean of x - shift from the threads' partials (``_thread_sums``,
    ``_group_totals``), then the sum of (x - c)^2 about c = shift + mean
    rounded once, less n e^2 for its rounding e; Chan's merge of the blocks'
    partials in block order with the weights n_j / N_j and N_{j-1} n_j /
    N_j, in ``merge`` (the kernel's: float64 for fp32 y, float32 for 16-bit
    y); y = (x - c) a + (bias - e a), a = rstd scale, for c and e of the
    row's mean. rsqrt as torch's (the card's rsqrtf is within 2 ulp of it),
    products not fused (the card contracts some into FMAs). With ``stats``,
    (mean, rstd) of each (b, g)."""
    B, HW, C = x.shape
    V, lanes = plan.vec, plan.lanes
    cg = C // G
    vpg = cg // V
    spans = plan_block_rows(plan, HW)
    out, means, rstds = torch.empty_like(x), [], []
    for b in range(B):
        shift = x[b, 0, ::cg]
        xv = x[b].reshape(HW, C // V, V)
        parts = []
        for r0, r1 in spans:
            xs = xv[r0:r1]
            sv = shift.repeat_interleave(vpg)[None, :]
            n = float((r1 - r0) * cg)
            mean = _group_totals(_thread_sums(xs, lanes, lambda v: v - sv),
                                 G, vpg, lanes) / torch.tensor(n)
            c, e = _two_sum(shift, mean)
            cv = c.repeat_interleave(vpg)[None, :]
            m2 = _group_totals(_thread_sums(
                xs, lanes, lambda v: (v - cv) * (v - cv)), G, vpg, lanes)
            parts.append((mean, m2 - torch.tensor(n) * e * e))
        m = torch.zeros(G, dtype=merge)
        m2 = torch.zeros(G, dtype=merge)
        for j, (mb, m2b) in enumerate(parts):
            r0, r1 = spans[j]
            w = torch.tensor(float((r1 - r0) * cg), dtype=merge) / \
                torch.tensor(float(r1 * cg), dtype=merge)
            c = torch.tensor(float(r0 * cg), dtype=merge) * w
            d = mb.to(merge) - m
            m = m + d * w
            m2 = m2 + m2b.to(merge) + d * d * c
        if merge == torch.float64:
            cd = shift.double() + m
            cn = cd.float()
            e = (cd - cn.double()).float()
            rstd = torch.rsqrt(m2 / float(HW * cg) + eps).float()
        else:
            cn, e = _two_sum(shift, m)
            rstd = torch.rsqrt(m2 / torch.tensor(float(HW * cg)) + eps)
        means.append(cn - shift)
        rstds.append(rstd)
        a = rstd.repeat_interleave(cg) * scale
        b2 = bias - e.repeat_interleave(cg) * a
        out[b] = (x[b] - cn.repeat_interleave(cg)) * a + b2
    if stats:
        return torch.stack(means), torch.stack(rstds)
    return out


def merge_dtype(itemsize):
    """The kernel's merge arithmetic for x of ``itemsize`` bytes."""
    return torch.float64 if itemsize == 4 else torch.float32


# (itemsize, sms): the plan's vector width and rows a step at 16 bits and
# fp32, on the H100 and on cards of 7 and 6 SMs (2-7 blocks a batch row of
# up to 320 rows)
EMU_PLANS = [(2, 132), (4, 132), (2, 7), (4, 6)]


@pytest.mark.parametrize("B,HW,C,G", GN_SHAPES)
@pytest.mark.parametrize("itemsize,sms", EMU_PLANS)
def test_emulated_resident_kernel_matches_jax(B, HW, C, G, itemsize, sms):
    plan = gn_plan(B, HW, C, G, itemsize, sms)
    assert plan.route == "resident"
    x, scale, bias = gn_inputs(B, HW, C, seed=HW + itemsize)
    got = emulate_resident(t(x), t(scale), t(bias), G, plan,
                           merge=merge_dtype(itemsize))
    want = np.asarray(jax_reference_group_norm(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), G))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B,HW,C,G,sms", [
    (2, 4096, 64, 8, 132), (2, 4096, 64, 8, 17), (4, 1024, 512, 32, 132)])
def test_emulated_resident_stress_against_float64(B, HW, C, G, sms):
    """300 + 0.01 N(0, 1): the shifted two-pass statistics and the merge
    stay finite and within GN_STRESS_TOL of float64."""
    plan = gn_plan(B, HW, C, G, 4, sms)
    assert plan.route == "resident"
    rng = np.random.default_rng(B * HW + sms)
    x = (300 + 0.01 * rng.normal(size=(B, HW, C))).astype(np.float32)
    got = emulate_resident(t(x), torch.ones(C), torch.zeros(C), G,
                           plan).numpy()
    xg = x.astype(np.float64).reshape(B, HW, G, C // G)
    mean = xg.mean(axis=(1, 3), keepdims=True)
    var = ((xg - mean) ** 2).mean(axis=(1, 3), keepdims=True)
    want = ((xg - mean) / np.sqrt(var + 1e-5)).reshape(B, HW, C)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= GN_STRESS_TOL


@pytest.mark.parametrize("B,HW,C,G", [(2, 4096, 64, 8), (4, 1024, 512, 32),
                                      (1, 1024, 96, 12)])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_emulated_statistics_do_not_depend_on_the_split(B, HW, C, G,
                                                       itemsize):
    """The same batch row split over 4..128 blocks (cards of 9..132 SMs),
    merged as the kernel merges for 16-bit x (fp32) and fp32 x (fp64):
    each (b, g)'s mean (of x - shift) and rstd within 8 fp32 ulps of the
    132-SM plan's (measured: 0-3), and y within 2^-20 max|y| (~4e-6, a
    fifth of the fp32 tolerance): another SM count cannot move a result
    out of tolerance."""
    x, scale, bias = gn_inputs(B, HW, C, seed=5)
    ulp = 2.0 ** -23
    merge = merge_dtype(itemsize)
    base = gn_plan(B, HW, C, G, itemsize, SMS)
    m0, r0 = emulate_resident(t(x), t(scale), t(bias), G, base, stats=True,
                              merge=merge)
    y0 = emulate_resident(t(x), t(scale), t(bias), G, base, merge=merge)
    splits = {base.blocks}
    for sms in (66, 40, 17, 9):
        plan = gn_plan(B, HW, C, G, itemsize, sms)
        if plan.route != "resident":
            continue
        splits.add(plan.blocks)
        m, r = emulate_resident(t(x), t(scale), t(bias), G, plan,
                                stats=True, merge=merge)
        assert float((m - m0).abs().max()) <= 8 * ulp * float(
            m0.abs().max())
        assert float(((r - r0) / r0).abs().max()) <= 8 * ulp
        y = emulate_resident(t(x), t(scale), t(bias), G, plan, merge=merge)
        assert float((y - y0).abs().max()) <= 2.0 ** -20 * float(
            y0.abs().max())
    assert len(splits) >= 2
