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

The prefill kernel's host plan (``paged_prefill_plan``: 64- or 128-row
work tiles, the rows of a page's TMA box) and the key range of each of
its q tiles (``prefill_keys``) are held here too, and an emulation of its
walk (key tiles gathered box by box into stages that start as NaN, the V
rows past the written keys zeroed, each warpgroup's exp2 online softmax,
the 64-row tiles' key split and merge) matches JAX's reference at 2e-5 in
fp32 over ragged rows and NaN-poisoned pages, reading no table entry past
a row's written pages.

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
from deepspeed_tpu_torch.ops.paged_decode_attention import (
    PREFILL_KEYS, paged_prefill_plan, paged_split_plan, prefill_keys,
    split_pages, unit_pages)

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


class TestPrefillPlan:
    """The prefill kernel's launch: work tiles of 64 or 128 chunk queries
    and the rows of a page's TMA box, chosen on the host from shapes alone
    (the wrapper never reads ``start`` or ``n_valid`` there)."""

    def test_llama_serve_chunk_takes_64_row_tiles(self):
        """B 1, C 256, 32 heads: 64 tiles of 128 rows on 132 SMs, so 128
        blocks of 64 rows; block 16 pages go by TMA in 16-row boxes."""
        assert paged_prefill_plan(1, 256, 32, 16, 132) == (64, 16)
        # two rows of the chunk, or a 512-query chunk, fill the card with
        # 128-row tiles
        assert paged_prefill_plan(2, 256, 32, 16, 132) == (128, 16)
        assert paged_prefill_plan(1, 512, 32, 16, 132) == (128, 16)
        # GQA counts query heads (a work tile is one query head): a short
        # chunk (C 16) of 8 heads over 2 rows has 16 tiles
        assert paged_prefill_plan(2, 16, 8, 16, 132) == (64, 16)

    @pytest.mark.parametrize("BS,box", [
        (8, 8), (16, 16), (24, 8), (32, 32), (48, 16), (64, 64), (128, 128),
        (256, 128), (1, 0), (4, 0), (12, 0), (20, 0), (7, 0)])
    def test_box_rows(self, BS, box):
        """Boxes of gcd(BS, 128) rows, whole 8-row swizzle atoms that tile
        both the page and the 128-key stage; other page sizes go by plain
        loads (0)."""
        rows, box_rows = paged_prefill_plan(1, 256, 32, BS, 132)
        assert box_rows == box
        if box_rows:
            assert box_rows % 8 == 0 and BS % box_rows == 0
            assert PREFILL_KEYS % box_rows == 0

    def test_plan_takes_only_host_integers(self):
        sig = inspect.signature(paged_prefill_plan)
        assert all(p.annotation in (int, "int")
                   for p in sig.parameters.values())
        assert all(type(x) is int
                   for x in paged_prefill_plan(1, 256, 32, 16, 132))

    @pytest.mark.parametrize("rows", [64, 128])
    def test_tile_keys_cover_each_row(self, rows):
        """prefill_keys (the device's tile_keys): a q tile walks exactly
        the columns up to its last valid query's position, within the
        table; a tile of pads walks none."""
        C, T = 200, 600
        for start in (0, 5, 256, 512):
            for nv in (0, 1, 63, 64, 65, 188, 200, 250):
                for qt in range(-(-C // rows)):
                    kend = prefill_keys(start, nv, C, rows, qt, T)
                    valid = [c for c in range(qt * rows,
                                              min((qt + 1) * rows, C))
                             if c < nv]
                    want = min(start + valid[-1] + 1, T) if valid else 0
                    assert kend == want


def prefill_emulation(q, kp, vp, bt, start, n_valid, rows, box_rows,
                      alibi=None):
    """The prefill kernel's walk in fp32 numpy: per (row, query head, q tile
    of ``rows`` chunk queries) the key tiles of 128 columns below
    ``prefill_keys``, each gathered into a stage that starts as NaN (stale
    shared memory) box by box (``box_rows`` rows of one page, only boxes
    that hold a written key) or, with ``box_rows`` 0, row by row over the
    written rows; V rows at or past kend zeroed; then per consumer
    warpgroup an exp2 online softmax with invisible pairs selected to
    -inf (128-row tiles: warpgroup w rows 64 w.., every key tile; 64-row
    tiles: both the same rows, warpgroup w key tiles w, w + 2, .., merged
    in that order). Asserts that no table entry at or past ceil(kend / BS)
    is read."""
    B, C, N, D = q.shape
    BS, K = kp.shape[1], kp.shape[2]
    MAXB = bt.shape[1]
    G, KT = N // K, PREFILL_KEYS
    scale2 = np.float32(D ** -0.5 * np.log2(np.e))
    out = np.zeros_like(q)
    for b in range(B):
        st, nv = int(start[b]), min(max(int(n_valid[b]), 0), C)

        def entry(col, kend):
            assert col // BS < -(-kend // BS), "a page past the written ones"
            return bt[b, col // BS]

        for n in range(N):
            kh = n // G
            slope2 = np.float32(0 if alibi is None
                                else alibi[n] * np.log2(np.e))
            for qt in range(-(-C // rows)):
                c0 = qt * rows
                kend = prefill_keys(st, nv, C, rows, qt, MAXB * BS)
                nt = -(-kend // KT)
                stages = []
                for i in range(nt):
                    t0 = i * KT
                    ks = np.full((KT, D), np.nan, np.float32)
                    vs = np.full((KT, D), np.nan, np.float32)
                    if box_rows:
                        for j in range(KT // box_rows):
                            col = t0 + j * box_rows
                            if col >= kend:
                                break
                            pg, r = entry(col, kend), col % BS
                            ks[j * box_rows:(j + 1) * box_rows] = \
                                kp[pg, r:r + box_rows, kh]
                            vs[j * box_rows:(j + 1) * box_rows] = \
                                vp[pg, r:r + box_rows, kh]
                    else:
                        for r in range(min(KT, kend - t0)):
                            pg = entry(t0 + r, kend)
                            ks[r] = kp[pg, (t0 + r) % BS, kh]
                            vs[r] = vp[pg, (t0 + r) % BS, kh]
                    vs[max(0, kend - t0):] = 0
                    stages.append((t0, ks, vs))
                groups = ([(c0, stages)] if rows == 64 else
                          [(c0, stages), (c0 + 64, stages)])
                parts = []
                for w in range(2):
                    r0, walk = groups[0] if rows == 64 else groups[w]
                    if rows == 64:
                        walk = stages[w::2]
                    rr = np.arange(r0, r0 + 64)
                    qs = np.zeros((64, D), np.float32)
                    inside = rr < C
                    qs[inside] = q[b, rr[inside], n]
                    lim = np.where(rr < nv, np.minimum(st + rr, kend - 1), -1)
                    m = np.full(64, -np.inf, np.float32)
                    l = np.zeros(64, np.float32)
                    o = np.zeros((64, D), np.float32)
                    for t0, ks, vs in walk:
                        with np.errstate(invalid="ignore"):
                            s = qs @ ks.T
                        cols = t0 + np.arange(KT)
                        vis = cols[None] <= lim[:, None]
                        s = np.where(vis, s * scale2 + slope2 * cols, -np.inf)
                        mn = np.maximum(m, s.max(axis=1))
                        mu = np.where(mn == -np.inf, 0, mn).astype(np.float32)
                        corr = np.exp2(m - mu)
                        p = np.exp2(s - mu[:, None])
                        l = l * corr + p.sum(axis=1)
                        o = o * corr[:, None] + p @ vs
                        m = mn
                    parts.append((rr, m, l, o))
                if rows == 64:
                    (rr, m0, l0, o0), (_, m1, l1, o1) = parts
                    mn = np.maximum(m0, m1)
                    mu = np.where(mn == -np.inf, 0, mn)
                    f0, f1 = np.exp2(m0 - mu), np.exp2(m1 - mu)
                    parts = [(rr, mn, l0 * f0 + l1 * f1,
                              o0 * f0[:, None] + o1 * f1[:, None])]
                for rr, m, l, o in parts:
                    keep = rr < C
                    res = np.where(l[:, None] > 0,
                                   o / np.where(l > 0, l, 1)[:, None], 0)
                    out[b, rr[keep], n] = res[keep]
    return out


class TestPrefillEmulation:
    """The prefill kernel's work split (``prefill_emulation``: q tiles,
    pages into stages box by box, the warpgroups' key split and its merge)
    against JAX's reference at 2e-5 in fp32: ragged rows (a start off a
    page boundary, a partial chunk, a row of pads), NaN in the scratch
    block, in the tail of each row's last written page and in every page
    no row reaches (the stale entries of a recycled table point at them),
    G 1 and 4, alibi."""

    @pytest.mark.parametrize("BS", [4, 8, 16, 24])
    @pytest.mark.parametrize("rows", [64, 128])
    @pytest.mark.parametrize("n,k,use_alibi", [(4, 4, False), (8, 2, True)])
    def test_matches_jax_reference(self, BS, rows, n, k, use_alibi):
        C, D = 150, 16
        starts = [0, 21, 130, 40]
        valid = [C, 11, 150 - 3, 0]
        B = len(starts)
        MAXB = -(-(max(starts) + C + 10) // BS)
        _, box_rows = paged_prefill_plan(B, C, n, BS, 132)
        rng = np.random.default_rng(BS + rows + n)
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
            if written < npages * BS:
                for p in (kp, vp):
                    p[bt[r, npages - 1], written % BS:] = np.nan
        for p in (kp, vp):
            p[0] = np.nan
            p[[x for x in range(1, NB) if x not in used]] = np.nan
        q = rng.normal(size=(B, C, n, D)).astype(np.float32)
        al = np.asarray(jax_alibi(n)) if use_alibi else None
        st, nv = np.array(starts, np.int32), np.array(valid, np.int32)
        got = prefill_emulation(q, kp, vp, bt, st, nv, rows, box_rows, al)
        offs = np.arange(C)
        pos = np.where(offs[None] < nv[:, None], st[:, None] + offs, -1)
        ref = jax_ref(q, np.nan_to_num(kp), np.nan_to_num(vp), bt, pos, al)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)
        assert (got[3] == 0).all() and (got[1, 11:] == 0).all()
