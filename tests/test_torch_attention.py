"""The plain versions of the port's dense attention kernels against the JAX
package's oracles, on the CPU, in fp32.

* ``reference_flash_attention`` (and ``flash_attention`` on a CPU tensor)
  computes the Pallas flash kernel's function: 0-based causality, (B, T)
  key padding, alibi over the key column. The JAX kernel does not run under
  the installed jax (``TPUCompilerParams`` is gone), and JAX's jnp
  ``dot_product_attention`` is END-aligned under ``causal=True``, so the
  oracle is ``dot_product_attention`` given the explicit 0-based (B, S, T)
  mask. lse is held against a numpy logsumexp of the same scores.
* ``reference_decode_attention`` against JAX ``reference_decode_attention``:
  ragged validity with holes, alibi with per-row key positions, GQA.
* The port's ``dot_product_attention`` (end-aligned causal, key positions)
  against JAX's.

Inputs come from seeded numpy; fp32 outputs agree at 2e-5 (the JAX kernel
tests' tolerance: the same sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.transformer import (
    alibi_slopes as jax_alibi, dot_product_attention as jax_dpa)
from deepspeed_tpu.ops.decode_attention import \
    reference_decode_attention as jax_decode
from deepspeed_tpu_torch.models.transformer import (alibi_slopes,
                                                    dot_product_attention)
from deepspeed_tpu_torch.ops import (decode_attention, flash_attention,
                                     launch_counts, reference_decode_attention,
                                     reference_flash_attention)
from deepspeed_tpu_torch.ops.decode_attention import (MAX_SPLITS, TILE,
                                                      decode_split_plan)

TOL = 2e-5
HEADS = [(4, 4), (4, 2), (8, 2)]


def qkv(B, S, T, N, K, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, N, D)).astype(np.float32)
    k = rng.normal(size=(B, T, K, D)).astype(np.float32)
    v = rng.normal(size=(B, T, K, D)).astype(np.float32)
    return q, k, v


def key_padding(B, T, seed):
    """(B, T) int32 right padding plus a hole; column 0 always valid, so
    every query row sees at least one key."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(max(1, T // 3), T + 1, B)
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.int32)
    mask[:, min(3, T - 1)] = 0 if T > 4 else 1
    mask[:, 0] = 1
    return mask


def zero_based_mask(mask, S, T, causal):
    """The flash kernel's visibility as an explicit (B, S, T) mask."""
    keep = np.ones((S, T), bool)
    if causal:
        keep = np.arange(T)[None] <= np.arange(S)[:, None]
    full = keep[None] & np.ones((mask.shape[0], 1, 1), bool)
    return (full & (mask[:, None, :] != 0)).astype(np.int32)


class TestFlashPlainVsJax:
    @pytest.mark.parametrize("N,K", HEADS)
    @pytest.mark.parametrize("S,T", [(16, 16), (12, 40), (37, 37),
                                     (64, 100), (100, 130)])
    @pytest.mark.parametrize("use_alibi", [False, True])
    def test_matches_dot_product_attention(self, N, K, S, T, use_alibi):
        B, D = 2, 16
        q, k, v = qkv(B, S, T, N, K, D, seed=S * T + N)
        mask = key_padding(B, T, seed=T)
        al = np.array(jax_alibi(N)) if use_alibi else None
        want = np.asarray(jax_dpa(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(zero_based_mask(mask, S, T, True)), causal=False,
            alibi=None if al is None else jnp.asarray(al)))
        got = reference_flash_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(mask), causal=True,
            alibi=None if al is None else torch.from_numpy(al))
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)

    @pytest.mark.parametrize("N,K", HEADS)
    def test_non_causal_and_no_mask(self, N, K):
        B, S, T, D = 2, 9, 21, 8
        q, k, v = qkv(B, S, T, N, K, D, seed=5)
        want = np.asarray(jax_dpa(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), None, causal=False))
        got = reference_flash_attention(torch.from_numpy(q),
                                        torch.from_numpy(k),
                                        torch.from_numpy(v), causal=False)
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)

    def test_equals_end_aligned_causal_when_s_equals_t(self):
        """The cache-less forward's case: with S == T the 0-based and the
        end-aligned conventions are one function."""
        B, S, N, K, D = 2, 23, 4, 2, 16
        q, k, v = qkv(B, S, S, N, K, D, seed=9)
        mask = key_padding(B, S, seed=3)
        want = np.asarray(jax_dpa(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(mask),
                                  causal=True))
        got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)

    @pytest.mark.parametrize("N,K", HEADS)
    @pytest.mark.parametrize("use_alibi", [False, True])
    def test_lse_is_logsumexp_of_the_scores(self, N, K, use_alibi):
        B, S, T, D = 2, 19, 70, 16
        q, k, v = qkv(B, S, T, N, K, D, seed=N + K)
        mask = key_padding(B, T, seed=4)
        al = alibi_slopes(N) if use_alibi else None
        _, lse = reference_flash_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(mask), causal=True, alibi=al, return_lse=True)
        kk = np.repeat(k, N // K, axis=2).astype(np.float64)
        s = np.einsum("bsnd,btnd->bnst", q.astype(np.float64), kk) * D ** -0.5
        if al is not None:
            s = s + al.numpy()[None, :, None, None] * np.arange(T)
        keep = zero_based_mask(mask, S, T, True)[:, None] != 0
        s = np.where(keep, s, -np.inf)
        mx = s.max(-1, keepdims=True)
        want = (mx + np.log(np.exp(s - mx).sum(-1, keepdims=True)))[..., 0]
        assert lse.shape == (B, N, S) and lse.dtype == torch.float32
        np.testing.assert_allclose(lse.numpy(), want, atol=TOL, rtol=TOL)

    def test_empty_row_gives_zeros_and_minus_inf_lse(self):
        B, S, T, N, D = 1, 4, 8, 2, 8
        q, k, v = qkv(B, S, T, N, N, D, seed=1)
        mask = np.zeros((B, T), np.int32)
        mask[0, 2:] = 1                  # rows 0 and 1 see no key
        o, lse = reference_flash_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(mask), return_lse=True)
        assert (o[0, :2] == 0).all() and torch.isinf(lse[0, :, :2]).all()
        assert torch.isfinite(o).all() and torch.isfinite(lse[0, :, 2:]).all()

    def test_cpu_wrapper_is_the_plain_version_and_launches_nothing(self):
        q, k, v = (torch.from_numpy(a) for a in qkv(2, 8, 12, 4, 2, 16, 3))
        before = launch_counts()["flash_attention"]
        a = flash_attention(q, k, v, causal=True, return_lse=True)
        b = reference_flash_attention(q, k, v, causal=True, return_lse=True)
        assert launch_counts()["flash_attention"] == before
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, atol=0, rtol=0)


def decode_inputs(B, T, N, K, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, N, D)).astype(np.float32)
    kc = rng.normal(size=(B, T, K, D)).astype(np.float32)
    vc = rng.normal(size=(B, T, K, D)).astype(np.float32)
    lens = rng.integers(1, T + 1, B)
    valid = (np.arange(T)[None] < lens[:, None]).astype(np.int32)
    valid[:, 1::5] = 0                  # holes
    valid[:, 0] = 1
    # stale slots: large finite values outside every valid column
    kc[valid == 0] = 1e4
    vc[valid == 0] = -1e4
    kpos = np.sort(rng.uniform(0, 2 * T, (B, T)), axis=1).astype(np.float32)
    return q, kc, vc, valid, kpos


class TestDecodePlainVsJax:
    @pytest.mark.parametrize("N,K", HEADS + [(8, 1)])
    @pytest.mark.parametrize("T", [1, 7, 64, 129])
    @pytest.mark.parametrize("alibi_mode", ["none", "column", "positions"])
    def test_matches_reference_decode_attention(self, N, K, T, alibi_mode):
        B, D = 3, 16
        q, kc, vc, valid, kpos = decode_inputs(B, T, N, K, D, seed=T + N)
        al = np.array(jax_alibi(N)) if alibi_mode != "none" else None
        kp = kpos if alibi_mode == "positions" else None
        want = np.asarray(jax_decode(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
            jnp.asarray(valid), alibi=None if al is None else jnp.asarray(al),
            key_positions=None if kp is None else jnp.asarray(kp)))
        got = reference_decode_attention(
            torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
            torch.from_numpy(valid),
            alibi=None if al is None else torch.from_numpy(al),
            key_positions=None if kp is None else torch.from_numpy(kp))
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)

    @pytest.mark.parametrize("N,K", HEADS)
    def test_kv_len_is_a_bound_not_a_change(self, N, K):
        """Columns at or past kv_len are invalid: passing the bound with a
        mask that already ends there changes nothing."""
        B, T, D = 2, 50, 16
        q, kc, vc, valid, _ = decode_inputs(B, T, N, K, D, seed=2)
        valid[:, 31:] = 0
        args = [torch.from_numpy(a) for a in (q, kc, vc, valid)]
        full = reference_decode_attention(*args)
        bounded = decode_attention(*args, kv_len=31)
        torch.testing.assert_close(bounded, full, atol=0, rtol=0)
        # and the bound does mask: columns >= 10 vanish
        cut = valid.copy()
        cut[:, 10:] = 0
        torch.testing.assert_close(
            decode_attention(*args, kv_len=10),
            reference_decode_attention(*args[:3], torch.from_numpy(cut)),
            atol=0, rtol=0)

    def test_empty_row_gives_zeros(self):
        q, kc, vc, valid, _ = decode_inputs(2, 9, 4, 2, 8, seed=0)
        valid[1] = 0
        out = reference_decode_attention(*(torch.from_numpy(a) for a in
                                           (q, kc, vc, valid)))
        assert (out[1] == 0).all() and torch.isfinite(out).all()


class TestDecodeSplitPlan:
    """The dense decode kernel's split, chosen on the host: every column
    below kv_len falls in exactly one split, and the split-KV merge of the
    kernel (each split's (m, l, acc), merged in split order) computes the
    plain version's function."""

    @pytest.mark.parametrize("B,K", [(1, 1), (1, 32), (8, 32), (2, 4),
                                     (64, 8)])
    @pytest.mark.parametrize("kv_len", [0, 1, 32, 33, 385, 1000, 4000,
                                        4096, 32768])
    @pytest.mark.parametrize("D,itemsize,sms", [(128, 2, 132),
                                                (256, 4, 114)])
    def test_every_column_in_one_split(self, B, K, kv_len, D, itemsize, sms):
        splits, chunk, stages = decode_split_plan(B, K, D, itemsize, kv_len,
                                                  sms)
        assert 1 <= splits <= MAX_SPLITS and splits & (splits - 1) == 0
        assert chunk >= TILE and chunk % TILE == 0
        assert 2 <= stages <= 8
        cover = np.zeros(max(kv_len, 1), np.int64)
        for i in range(splits):
            lo, hi = i * chunk, min((i + 1) * chunk, kv_len)
            cover[lo:max(lo, hi)] += 1
        assert (cover[:kv_len] == 1).all()
        # no split is wholly past kv_len except those a power of two forces
        assert splits == 1 or (splits // 2) * chunk < kv_len

    def test_splits_at_llama_decode_shapes(self):
        """B 1 at llama-7b's heads (K 32) over 4000 keys takes every split a
        cluster allows (256 blocks); B 8 over 1000 keys takes 2 (512
        blocks, within 4 an SM of 132); bf16 D 128 rings hold 2 stages."""
        assert decode_split_plan(1, 32, 128, 2, 4000, 132) == (8, 512, 2)
        assert decode_split_plan(8, 32, 128, 2, 1000, 132) == (2, 512, 2)
        assert decode_split_plan(8, 32, 128, 2, 517, 132) == (2, 288, 2)

    @pytest.mark.parametrize("kv_len", [0, 33, 200, 385])
    def test_split_merge_matches_plain(self, kv_len):
        """The kernel's arithmetic in float64 numpy: per split the online
        softmax state over its live columns (none: l = 0, m = -1e30, acc =
        0), then the merge in split order; a row with no live key gives 0."""
        B, T, N, K, D = 3, 400, 8, 2, 16
        q, kc, vc, valid, _ = decode_inputs(B, T, N, K, D, seed=kv_len)
        valid[1, :] = 0                   # a row with no live key
        valid[2, 64:160] = 0              # dead chunks between live ones
        splits, chunk, _ = decode_split_plan(B, K, D, 4, kv_len, 132)
        G, scale = N // K, D ** -0.5
        live = (valid != 0) & (np.arange(T)[None] < kv_len)
        want = reference_decode_attention(
            *(torch.from_numpy(a) for a in (q, kc, vc, valid)),
            kv_len=kv_len).numpy()
        got = np.zeros_like(want, dtype=np.float64)
        for b in range(B):
            for n in range(N):
                kh = n // G
                parts = []
                for i in range(splits):
                    cols = [j for j in range(i * chunk,
                                             min((i + 1) * chunk, kv_len))
                            if live[b, j]]
                    if not cols:
                        parts.append((-1e30, 0.0, np.zeros(D)))
                        continue
                    s = (q[b, n].astype(np.float64) * scale) @ \
                        kc[b, cols, kh].astype(np.float64).T
                    m = s.max()
                    p = np.exp(s - m)
                    parts.append((m, p.sum(), p @ vc[b, cols, kh]))
                M = max(m for m, _, _ in parts)
                L = sum(l * np.exp(m - M) for m, l, _ in parts)
                O = sum(a * np.exp(m - M) for m, _, a in parts)
                got[b, n] = O / L if L > 0 else 0.0
        assert (got[1] == 0).all()
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


class TestDotProductAttentionVsJax:
    @pytest.mark.parametrize("N,K", HEADS)
    @pytest.mark.parametrize("S,T", [(5, 5), (3, 11)])
    @pytest.mark.parametrize("with_kpos", [False, True])
    def test_end_aligned_causal_and_key_positions(self, N, K, S, T,
                                                  with_kpos):
        B, D = 2, 8
        q, k, v = qkv(B, S, T, N, K, D, seed=7)
        mask = key_padding(B, T, seed=1)
        kpos = (np.random.default_rng(0).uniform(0, 20, (B, T))
                .astype(np.float32) if with_kpos else None)
        al = np.array(jax_alibi(N))
        want = np.asarray(jax_dpa(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(mask), causal=True, alibi=jnp.asarray(al),
            key_positions=None if kpos is None else jnp.asarray(kpos)))
        got = dot_product_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(mask), causal=True, alibi=torch.from_numpy(al),
            key_positions=None if kpos is None else torch.from_numpy(kpos))
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
