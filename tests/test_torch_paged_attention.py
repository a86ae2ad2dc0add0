"""Paged decode / chunked-prefill attention: the port against the JAX package.

The port's wrappers on the CPU run their plain versions; they are held
against JAX ``reference_paged_attention`` (the Pallas paged kernels cannot
be built under this jax, not even in interpret mode). Cases: ragged,
out-of-order block tables, (N, K) in {(4,4), (4,2), (8,2)}, alibi, a
length-0 decode row, prefill pads, and NaN-poisoned pages outside every
live range, which must leave live outputs finite. fp32 tolerance 2e-5
(another summation order of the same fp32 softmax).

The decode kernel's host plan (``paged_split_plan``: splits and ring
stages from shapes alone) and its device-side division of a row's pages
among the splits (``split_pages``) are held here too: every page of every
possible length lands in exactly one split, and an emulation of the
kernel's arithmetic (each split's online-softmax state over its own pages,
the splits merged in rank order) matches JAX's reference at 2e-5 in fp32.

The CUDA kernels are held against these plain versions on the card by
``tests/test_torch_cuda_kernels.py``.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.transformer import alibi_slopes as jax_alibi
from deepspeed_tpu.ops.paged_decode_attention import \
    reference_paged_attention as jax_reference
from deepspeed_tpu_torch.models.transformer import alibi_slopes
from deepspeed_tpu_torch.ops import (launch_counts, paged_decode_attention,
                                     paged_prefill_attention,
                                     reference_paged_attention)
from deepspeed_tpu_torch.ops.paged_decode_attention import (paged_split_plan,
                                                            split_pages,
                                                            unit_pages)

BS, MAXB, NB, D = 16, 4, 12, 32
HEADS = [(4, 4), (4, 2), (8, 2)]


def pools(k, seed=0, poison=True):
    """(NB, BS, K, D) pools; block 11 (in no table) and the tail of row 0's
    last page are NaN when ``poison``."""
    rng = np.random.default_rng(seed)
    kp = rng.normal(size=(NB, BS, k, D)).astype(np.float32)
    vp = rng.normal(size=(NB, BS, k, D)).astype(np.float32)
    if poison:
        for p in (kp, vp):
            p[11] = np.nan
            p[7, 5:] = np.nan      # row 0 page 2 holds positions 32..47
    return kp, vp


def ragged():
    """Three rows at different occupancy; physical pages non-contiguous and
    out of order (tests/kernels/test_paged_attention.py:33-41)."""
    bt = np.zeros((3, MAXB), np.int32)
    bt[0, :3] = [5, 1, 7]
    bt[1, :1] = [3]
    bt[2, :4] = [8, 2, 4, 6]
    lengths = np.array([BS * 2 + 5, 9, BS * 4], np.int32)
    return bt, lengths


def jax_ref(q, kp, vp, bt, pos, alibi=None):
    return np.asarray(jax_reference(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(pos), alibi=None if alibi is None else jnp.asarray(alibi)))


def t(a, device="cpu", dtype=None):
    x = torch.from_numpy(np.array(a)).to(device)
    return x if dtype is None else x.to(dtype)


class TestDecodeParity:
    @pytest.mark.parametrize("n,k", HEADS)
    @pytest.mark.parametrize("use_alibi", [False, True])
    def test_matches_jax_reference(self, n, k, use_alibi):
        kp, vp = pools(k)
        bt, lengths = ragged()
        q = np.random.default_rng(3).normal(size=(3, n, D)).astype(np.float32)
        al = np.asarray(jax_alibi(n)) if use_alibi else None
        got = paged_decode_attention(t(q), t(kp), t(vp), t(bt), t(lengths),
                                     None if al is None else t(al)).numpy()
        ref = jax_ref(q[:, None], kp, vp, bt, lengths[:, None] - 1, al)[:, 0]
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)

    def test_zero_length_row_outputs_zero(self):
        kp, vp = pools(2)
        bt, lengths = ragged()
        lengths[1] = 0
        q = np.random.default_rng(5).normal(size=(3, 4, D)).astype(np.float32)
        got = paged_decode_attention(t(q), t(kp), t(vp), t(bt),
                                     t(lengths)).numpy()
        assert (got[1] == 0).all()
        ref = jax_ref(q[:, None], kp, vp, bt, lengths[:, None] - 1)[:, 0]
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)

    def test_port_alibi_slopes_match_jax(self):
        for n in (4, 6, 8, 32):
            np.testing.assert_array_equal(alibi_slopes(n).numpy(),
                                          np.asarray(jax_alibi(n)))


class TestPrefillParity:
    @pytest.mark.parametrize("n,k", HEADS)
    @pytest.mark.parametrize("start,n_valid", [(0, 16), (16, 16), (21, 11),
                                               (32, 5)])
    @pytest.mark.parametrize("use_alibi", [False, True])
    def test_matches_jax_reference(self, n, k, start, n_valid, use_alibi):
        C = 16
        kp, vp = pools(k, seed=1)
        bt = np.array([[5, 1, 7, 9], [8, 2, 4, 6]], np.int32)
        starts = np.array([start, 3], np.int32)
        valid = np.array([n_valid, C], np.int32)
        q = np.random.default_rng(4).normal(size=(2, C, n, D)
                                            ).astype(np.float32)
        al = np.asarray(jax_alibi(n)) if use_alibi else None
        got = paged_prefill_attention(
            t(q), t(kp), t(vp), t(bt), t(starts),
            None if al is None else t(al), n_valid=t(valid)).numpy()
        offs = np.arange(C)
        pos = np.where(offs[None] < valid[:, None], starts[:, None] + offs,
                       -1)
        ref = jax_ref(q, kp, vp, bt, pos, al)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)
        assert (got[0, n_valid:] == 0).all()          # pads output zeros

    def test_default_n_valid_is_whole_chunk(self):
        kp, vp = pools(2, poison=False)
        bt = np.array([[5, 1, 7, 9]], np.int32)
        q = np.random.default_rng(6).normal(size=(1, 8, 4, D)
                                            ).astype(np.float32)
        got = paged_prefill_attention(t(q), t(kp), t(vp), t(bt),
                                      t(np.array([10], np.int32))).numpy()
        ref = jax_ref(q, kp, vp, bt, (10 + np.arange(8))[None])
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)


class TestPlainVersion:
    def test_nan_pages_never_reach_live_rows(self):
        """0 x NaN = NaN: a NaN v row past a row's last position must not
        be multiplied in (positions 37..47 of row 0 are NaN above)."""
        kp, vp = pools(2)
        bt, lengths = ragged()
        q = torch.randn(3, 1, 4, D, generator=torch.Generator().manual_seed(0))
        out = reference_paged_attention(q, t(kp), t(vp), t(bt),
                                        t(lengths - 1)[:, None].long())
        assert torch.isfinite(out).all()

    def test_cpu_path_counts_no_launch(self):
        before = launch_counts()
        kp, vp = pools(2)
        bt, lengths = ragged()
        q = np.zeros((3, 4, D), np.float32)
        paged_decode_attention(t(q), t(kp), t(vp), t(bt), t(lengths))
        assert launch_counts() == before


class TestSplitPlan:
    """The decode kernel's split: ``splits`` and the ring's stages chosen on
    the host from shapes alone, the row's pages divided among the splits on
    the device (``split_pages`` repeats the kernel's integer arithmetic)."""

    # (R, K, MAXB, BS): llama-7b's serve batch and one long row at block 16;
    # blocks of 1..256 rows, below, at and above a 32-key stage, some not
    # dividing 32; tables of one page and of many
    @pytest.mark.parametrize("R,K,MAXB,BS", [
        (8, 32, 64, 16), (1, 32, 256, 16), (3, 4, 5, 8), (2, 2, 40, 1),
        (2, 2, 9, 12), (64, 8, 32, 16), (1, 1, 33, 32), (4, 2, 17, 48),
        (1, 8, 20, 64), (2, 4, 12, 256), (5, 2, 1, 16), (1, 2, 7, 24)])
    @pytest.mark.parametrize("D,itemsize,sms", [(128, 2, 132), (256, 4, 114)])
    def test_every_page_in_one_split(self, R, K, MAXB, BS, D, itemsize, sms):
        splits, stages = paged_split_plan(R, K, D, itemsize, BS, MAXB, sms)
        assert 1 <= splits <= 8 and splits & (splits - 1) == 0
        assert 2 <= stages <= 8
        assert splits == 1 or 2 * splits * R * K <= 2 * 4 * sms
        up = unit_pages(BS)
        for length in range(MAXB * BS + 3):     # and two past the table
            runs = split_pages(length, BS, MAXB, splits)
            npages = -(-min(length, MAXB * BS) // BS)
            cover = np.zeros(MAXB + 1, np.int64)
            for p0, p1 in runs:
                assert 0 <= p0 <= p1 <= npages
                cover[p0:p1] += 1
            assert (cover[:npages] == 1).all() and (cover[npages:] == 0).all()
            # in rank order, each run whole units, near-equal: all but the
            # last non-empty run take the same number of units
            assert [p0 for p0, _ in runs] == sorted(p0 for p0, _ in runs)
            sizes = [-(-(p1 - p0) // up) for p0, p1 in runs if p1 > p0]
            assert all(p0 % up == 0 for p0, p1 in runs if p1 > p0)
            assert len(set(sizes[:-1])) <= 1
            assert not sizes or sizes[-1] <= sizes[0]

    def test_splits_at_llama_serve_shapes(self):
        """R 8 at llama-7b's heads (K 32) over a 64-page table of 16 rows
        takes 2 splits (512 blocks, within 4 an SM of 132); one row over 256
        pages takes every split a cluster allows; bf16 D 128 rings hold 2
        stages."""
        assert paged_split_plan(8, 32, 128, 2, 16, 64, 132) == (2, 2)
        assert paged_split_plan(1, 32, 128, 2, 16, 256, 132) == (8, 2)
        # R 8's ragged serve lengths: the 1000-key row's 63 pages in runs
        # of 32 pages; a 1-key row's second split reads nothing
        assert split_pages(1000, 16, 64, 2) == [(0, 32), (32, 63)]
        assert split_pages(1, 16, 64, 2) == [(0, 1), (1, 1)]
        assert split_pages(4000, 16, 256, 8)[-1] == (224, 250)

    def test_plan_takes_only_host_integers(self):
        """The plan reads no tensor (so the wrapper never syncs on
        ``lengths``): every parameter is a host int."""
        sig = inspect.signature(paged_split_plan)
        assert all(p.annotation in (int, "int")
                   for p in sig.parameters.values())
        plan = paged_split_plan(8, 32, 128, 2, 16, 64, 132)
        assert all(type(x) is int for x in plan)


def split_merge_emulation(q, kp, vp, bt, lengths, splits, alibi=None):
    """The decode kernel's arithmetic in fp32 numpy: per (row, query head)
    each split's online-softmax state over its own pages' live columns
    (none: m = -1e30, l = 0, acc = 0), then the splits merged in rank order;
    a row with no key gives 0. Reads only pages below ceil(len / BS)."""
    R, N, D = q.shape
    BS, K = kp.shape[1], kp.shape[2]
    MAXB = bt.shape[1]
    G, scale = N // K, np.float32(D ** -0.5)
    out = np.zeros((R, N, D), np.float32)
    for r in range(R):
        length = min(int(lengths[r]), MAXB * BS)
        for n in range(N):
            kh = n // G
            parts = []
            for p0, p1 in split_pages(length, BS, MAXB, splits):
                cols = np.arange(p0 * BS, min(p1 * BS, length))
                if cols.size == 0:
                    parts.append((np.float32(-1e30), np.float32(0),
                                  np.zeros(D, np.float32)))
                    continue
                pages, offs = bt[r, cols // BS], cols % BS
                k = kp[pages, offs, kh]
                v = vp[pages, offs, kh]
                s = (k @ (q[r, n] * scale)).astype(np.float32)
                if alibi is not None:
                    s = s + np.float32(alibi[n]) * cols.astype(np.float32)
                m = s.max()
                p = np.exp(s - m)
                parts.append((m, p.sum(), p @ v))
            M = max(m for m, _, _ in parts)
            L = np.float32(0)
            O = np.zeros(D, np.float32)
            for m, l, acc in parts:
                e = np.exp(np.float32(m - M))
                L = L + l * e
                O = O + acc * e
            out[r, n] = O / L if L > 0 else 0
    return out


class TestSplitEmulation:
    MAXB = 16

    @pytest.mark.parametrize("BS", [8, 16, 32, 64])
    @pytest.mark.parametrize("case", ["edges", "full", "ragged"])
    @pytest.mark.parametrize("use_alibi", [False, True])
    def test_matches_jax_reference(self, BS, case, use_alibi):
        """Rows of 0, 1, BS and BS + 1 keys (the short ones leave splits
        without a page), a full table (and one past it), and a ragged batch;
        NaN in the scratch block, in the tail of each row's last page and in
        every page no row reaches, which the split never reads."""
        MAXB, cap = self.MAXB, self.MAXB * BS
        lengths = {"edges": [0, 1, BS, BS + 1],
                   "full": [cap, cap + 7],
                   "ragged": [2 * BS + 5, 9, cap - 3, 0, 3 * BS]}[case]
        R, N, K, D = len(lengths), 8, 2, 16
        splits, _ = paged_split_plan(R, K, D, 4, BS, MAXB, 132)
        assert splits >= 4
        rng = np.random.default_rng(BS)
        NB = R * MAXB + 2
        kp = rng.normal(size=(NB, BS, K, D)).astype(np.float32)
        vp = rng.normal(size=(NB, BS, K, D)).astype(np.float32)
        bt = np.zeros((R, MAXB), np.int32)
        perm = rng.permutation(np.arange(1, NB))
        used = set()
        for r, length in enumerate(lengths):
            npages = -(-min(length, cap) // BS)
            bt[r, :npages] = perm[r * MAXB:r * MAXB + npages]
            used.update(bt[r, :npages].tolist())
            if npages and length < npages * BS:
                for p in (kp, vp):
                    p[bt[r, npages - 1], length % BS:] = np.nan
        for p in (kp, vp):
            p[0] = np.nan
            p[[b for b in range(1, NB) if b not in used]] = np.nan
        q = rng.normal(size=(R, N, D)).astype(np.float32)
        al = np.asarray(jax_alibi(N)) if use_alibi else None
        lens = np.array(lengths, np.int32)
        got = split_merge_emulation(q, kp, vp, bt, lens, splits, al)
        ref = jax_ref(q[:, None], np.nan_to_num(kp), np.nan_to_num(vp), bt,
                      np.minimum(lens, cap)[:, None] - 1, al)[:, 0]
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)
        assert (got[lens == 0] == 0).all()
