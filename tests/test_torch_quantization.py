"""Group quantization: the port's ``ops/quantization.py`` against the JAX
package.

On the CPU ``quantize_symmetric`` runs its plain version. It is held bit
for bit (q and scales) against JAX's eager ``reference_quantize_symmetric``,
which divides in IEEE arithmetic as the port does. JAX's Pallas kernel
still runs here interpreted (``interpret=True``), but under ``jit``: XLA
turns its ``absmax / qmax`` into ``absmax * (1 / qmax)``, which moves some
scales by one ulp. Against it, q is equal on these draws and the scales
are equal or one ulp apart, and the test asserts that such ulp differences
exist, so that a change of the port's convention is a conscious one.

The CUDA kernel is held against this plain version, bit for bit, by
``tests/test_torch_cuda_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import quantization as jq
from deepspeed_tpu_torch.ops import (dequantize_symmetric, fake_quantize,
                                     launch_counts, quantize_symmetric,
                                     reference_quantize_symmetric)


def draw(n, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=n) * scale
            ).astype(np.float32)


def jax_ref(x, bits, group_size):
    q, s = jq.reference_quantize_symmetric(jnp.asarray(x), bits=bits,
                                           group_size=group_size)
    return np.asarray(q), np.asarray(s)


def port(x, bits, group_size, dtype=torch.float32):
    q, s = quantize_symmetric(torch.from_numpy(x).to(dtype), bits,
                              group_size)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    return q.numpy(), s.numpy()


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("group_size", [64, 128])
def test_bit_identical_to_jax_reference(bits, group_size):
    x = draw(group_size * 203, seed=bits + group_size)   # 203 groups: not % 8
    x[group_size * 5:group_size * 6] = 0.0               # a zero group
    q, s = port(x, bits, group_size)
    qj, sj = jax_ref(x, bits, group_size)
    np.testing.assert_array_equal(q, qj)
    np.testing.assert_array_equal(s, sj)
    assert s[5] == 1.0 and not q[group_size * 5:group_size * 6].any()
    qmax = 2 ** (bits - 1) - 1
    assert q.min() >= -qmax - 1 and q.max() <= qmax


@pytest.mark.parametrize("bits", [4, 8])
def test_exact_ties_round_half_to_even(bits):
    """Groups whose x / scale land exactly on .5: absmax qmax makes the
    scale 1, so x = k + 0.5 divides exactly."""
    qmax = 2 ** (bits - 1) - 1
    g = 16
    halves = np.arange(-qmax, qmax, dtype=np.float32) + 0.5
    x = np.zeros(g * 4, np.float32)
    for i in range(4):
        row = np.resize(halves[i::4], g - 1)
        x[i * g:(i + 1) * g] = np.concatenate([row, [float(qmax)]])
    q, s = port(x, bits, g)
    qj, sj = jax_ref(x, bits, g)
    np.testing.assert_array_equal(s, np.ones(4, np.float32))
    np.testing.assert_array_equal(q, qj)
    np.testing.assert_array_equal(q, np.clip(np.round(x), -qmax - 1, qmax))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_16bit_input_bit_identical(dtype):
    x = draw(128 * 40, seed=3, scale=3.0)
    xt = torch.from_numpy(x).to(dtype)
    q, s = quantize_symmetric(xt, 8, 128)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float16
    qj, sj = jq.reference_quantize_symmetric(
        jnp.asarray(xt.float().numpy()).astype(jdt), bits=8, group_size=128)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))


@pytest.mark.parametrize("bits", [4, 8])
def test_against_jax_kernel_interpreted(bits):
    x = draw(128 * 1024, seed=11)
    q, s = port(x, bits, 128)
    qk, sk = jq.quantize_symmetric(jnp.asarray(x), bits=bits, group_size=128,
                                   interpret=True)
    qk, sk = np.asarray(qk), np.asarray(sk)
    np.testing.assert_array_equal(q, qk)
    ulps = np.abs(s.view(np.int32).astype(np.int64)
                  - sk.view(np.int32).astype(np.int64))
    assert ulps.max() == 1          # the jit reciprocal: one ulp at most
    assert (ulps == 1).any()        # ... and it shows on these draws
    # the jitted scale is absmax times the rounded reciprocal of qmax
    absmax = np.abs(x.reshape(-1, 128)).max(-1)
    np.testing.assert_array_equal(
        sk, absmax * (np.float32(1) / np.float32(2 ** (bits - 1) - 1)))


def test_dequantize_matches_jax():
    x = draw(64 * 30, seed=5)
    q, s = port(x, 8, 64)
    got = dequantize_symmetric(torch.from_numpy(q), torch.from_numpy(s), 64)
    want = jq.dequantize_symmetric(jnp.asarray(q), jnp.asarray(s), 64)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.abs(got.numpy() - x).max() <= s.max() / 2


def test_reference_is_the_cpu_route():
    x = torch.from_numpy(draw(128 * 9, seed=6))
    before = launch_counts()["quantize_symmetric"]
    for a, b in zip(quantize_symmetric(x, 4, 128),
                    reference_quantize_symmetric(x, 4, 128)):
        assert torch.equal(a, b)
    assert launch_counts()["quantize_symmetric"] == before


@pytest.mark.parametrize("shape,dtype", [((7, 50), torch.float32),
                                         ((3, 128), torch.float32),
                                         ((5, 9, 33), torch.bfloat16)])
def test_fake_quantize_forward_matches_jax(shape, dtype):
    """Shapes whose size is not a multiple of the group: padded with zeros
    to whole groups, as JAX pads."""
    x = draw(int(np.prod(shape)), seed=7).reshape(shape)
    xt = torch.from_numpy(x).to(dtype)
    got = fake_quantize(xt, bits=8, group_size=128)
    assert got.dtype == dtype and got.shape == xt.shape
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jq.fake_quantize(jnp.asarray(xt.float().numpy()).astype(jdt),
                            bits=8, group_size=128, interpret=True)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want).astype(np.float32))


def test_fake_quantize_gradient_is_straight_through():
    x = draw(6 * 40, seed=8).reshape(6, 40)
    g = draw(6 * 40, seed=9).reshape(6, 40)
    xt = torch.from_numpy(x).requires_grad_(True)
    (fake_quantize(xt, bits=4, group_size=64) * torch.from_numpy(g)
     ).sum().backward()
    want = jax.grad(lambda a: jnp.sum(
        jq.fake_quantize(a, bits=4, group_size=64, interpret=True)
        * jnp.asarray(g)))(jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy(), g)


def test_rejects_what_jax_rejects():
    with pytest.raises(ValueError, match="bits"):
        quantize_symmetric(torch.zeros(128), bits=2)
    with pytest.raises(ValueError, match="%"):
        quantize_symmetric(torch.zeros(130), bits=8, group_size=128)
    with pytest.raises(AssertionError):
        jq.quantize_symmetric(jnp.zeros(130), bits=8, group_size=128,
                              interpret=True)
    with pytest.raises(ValueError, match="flat"):
        quantize_symmetric(torch.zeros(2, 128))
