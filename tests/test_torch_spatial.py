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

The CUDA GroupNorm kernel and the flash forward at head_dim 512 are held
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
