"""Block-sparse attention: the port against the JAX package, on the CPU.

* Every ``SparsityConfig``'s ``make_layout`` and ``build_tile_plan``'s
  arrays equal JAX's bit for bit, over configs, lengths and seeds; the
  port's list lengths match the lists; ``tile_plan_for`` caches by value.
* ``sparse_self_attention`` on the dense-mask route against JAX's, with and
  without a key-padding mask, shared and per-head layouts (fp32, 2e-5).
* The kernels' plain versions (``reference_block_sparse_attention`` and
  its backward, reached through ``block_sparse_attention``,
  ``block_sparse_attention_bwd`` and the kernel route of
  ``sparse_self_attention``) against JAX's dense-mask route and
  ``jax.vjp`` of it, on layouts without key-less rows (2e-5 forward, 5e-5
  gradients); a key-less q-tile gives the JAX kernels' output 0 and zero
  gradients, as ``tests/unit/test_sparse_attention.py`` pins; k / v with
  fewer heads than q are refused on the kernel route;
  ``block_sparse_attention_bwd`` on CPU tensors is its plain version and
  launches nothing; the backward's quadrant flags and key-major mask words
  agree with the mask table.
* The impl factory's checks, ``forward`` with a sparse impl against JAX's,
  20-step ``train_batch`` trajectories with a sparse impl and LAMB against
  the JAX engine, and a sparse model's decode refused as JAX refuses it.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.inference import kv_cache as jax_kv_cache
from deepspeed_tpu.models.presets import create_model as jax_create_model
from deepspeed_tpu.models.transformer import \
    dot_product_attention as jax_attention
from deepspeed_tpu.models.transformer import forward as jax_forward
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.inference import init_cache, init_paged_cache
from deepspeed_tpu_torch.models import (Model, create_model, params_from_jax,
                                        params_to_numpy)
from deepspeed_tpu_torch.models.transformer import (active_attention_impl,
                                                    forward)
from deepspeed_tpu_torch.ops import (block_sparse_attention,
                                     block_sparse_attention_bwd,
                                     block_sparse_attention_fwd,
                                     build_tile_plan, launch_counts,
                                     reference_block_sparse_attention,
                                     reference_block_sparse_attention_bwd)
from deepspeed_tpu_torch.ops import sparse_attention as P

# the JAX modules (``deepspeed_tpu.ops`` re-exports functions of the same
# names, which shadow the submodules as attributes)
J = importlib.import_module("deepspeed_tpu.ops.sparse_attention")
JB = importlib.import_module("deepspeed_tpu.ops.block_sparse_attention")

ATOL = 2e-5
GRAD_ATOL = 5e-5

CONFIGS = [
    ("DenseSparsityConfig", {}),
    ("FixedSparsityConfig", {}),
    ("FixedSparsityConfig", dict(num_local_blocks=2,
                                 attention="bidirectional",
                                 horizontal_global_attention=True)),
    ("FixedSparsityConfig", dict(num_local_blocks=4, num_global_blocks=2,
                                 different_layout_per_head=True)),
    ("LocalSlidingWindowSparsityConfig", {}),
    ("LocalSlidingWindowSparsityConfig", dict(num_sliding_window_blocks=5,
                                              attention="bidirectional")),
    ("BigBirdSparsityConfig", {}),
    ("BigBirdSparsityConfig", dict(num_random_blocks=2, seed=7,
                                   different_layout_per_head=True)),
    ("BigBirdSparsityConfig", dict(attention="unidirectional", seed=3)),
    ("VariableSparsityConfig", dict(num_random_blocks=1, seed=5,
                                    local_window_blocks=(2, 3),
                                    global_block_indices=(0, 5),
                                    different_layout_per_head=True)),
    ("VariableSparsityConfig", dict(attention="unidirectional",
                                    global_block_indices=(1,),
                                    global_block_end_indices=(3,))),
    ("BSLongformerSparsityConfig", {}),
    ("BSLongformerSparsityConfig", dict(global_block_indices=(0, 3),
                                        attention="unidirectional")),
]


def _configs(name, kw, heads=4, block=16):
    return (getattr(J, name)(num_heads=heads, block=block, **kw),
            getattr(P, name)(num_heads=heads, block=block, **kw))


def _id(case):
    name, kw = case
    return name.replace("SparsityConfig", "") + "-" + "-".join(
        f"{k}={v}" for k, v in kw.items())


# ---------------------------------------------------------------------------
# layouts and tile plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", CONFIGS, ids=_id)
@pytest.mark.parametrize("seq_len,block", [(64, 16), (256, 16), (512, 32)])
def test_layouts_and_plans_match_jax(case, seq_len, block):
    jc, pc = _configs(*case, block=block)
    want, got = jc.make_layout(seq_len), pc.make_layout(seq_len)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if seq_len % 128:
        with pytest.raises(ValueError, match="multiple of 128"):
            build_tile_plan(got, block, seq_len)
        return
    jplan = JB.build_tile_plan(want, block, seq_len)
    plan = build_tile_plan(got, block, seq_len)
    for f in ("kidx", "mid", "qidx_t", "mid_t", "masks"):
        a, b = getattr(plan, f), getattr(jplan, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert plan.density == jplan.density
    # the lengths: each q-tile's active k-tiles, and the transposed count
    r = 128 // block
    nt = seq_len // 128
    tiles = got.reshape(-1, nt, r, nt, r).any(axis=(2, 4))
    np.testing.assert_array_equal(plan.kcount, tiles.sum(-1))
    np.testing.assert_array_equal(plan.qcount_t, tiles.sum(-2))
    assert plan.active_tiles == int(tiles.sum())


def test_tile_plan_cache_is_keyed_by_value():
    a = P.FixedSparsityConfig(num_heads=2, block=16)
    b = P.FixedSparsityConfig(num_heads=2, block=16)
    assert P.tile_plan_for(a, 256) is P.tile_plan_for(b, 256)
    c = P.FixedSparsityConfig(num_heads=2, block=32)
    assert P.tile_plan_for(c, 256) is not P.tile_plan_for(a, 256)
    v = P.VariableSparsityConfig(num_heads=2, local_window_blocks=[2, 3])
    assert P.tile_plan_for(v, 256) is P.tile_plan_for(
        P.VariableSparsityConfig(num_heads=2, local_window_blocks=[2, 3]), 256)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_layouts_match_jax_per_seed(seed):
    for name in ("BigBirdSparsityConfig", "VariableSparsityConfig"):
        kw = dict(seed=seed, different_layout_per_head=True,
                  num_random_blocks=2)
        jc, pc = _configs(name, kw, heads=3)
        np.testing.assert_array_equal(pc.make_layout(384),
                                      jc.make_layout(384))


def test_layout_to_token_mask_matches_jax():
    jc, pc = _configs("BigBirdSparsityConfig", {})
    layout = pc.make_layout(128)
    want = np.asarray(J.layout_to_token_mask(layout, 16))
    got = P.layout_to_token_mask(layout, 16)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# sparse_self_attention, dense-mask route
# ---------------------------------------------------------------------------


def _qkv(rng, B, S, N, D, K=None):
    K = K or N
    return (rng.normal(size=(B, S, N, D)).astype(np.float32),
            rng.normal(size=(B, S, K, D)).astype(np.float32),
            rng.normal(size=(B, S, K, D)).astype(np.float32))


DENSE_CASES = [("FixedSparsityConfig", dict(num_local_blocks=2), False),
               ("FixedSparsityConfig", dict(num_local_blocks=2), True),
               ("BigBirdSparsityConfig",
                dict(different_layout_per_head=True), False),
               ("BigBirdSparsityConfig",
                dict(different_layout_per_head=True), True),
               ("BSLongformerSparsityConfig",
                dict(attention="unidirectional"), True),
               ("LocalSlidingWindowSparsityConfig", {}, False)]


@pytest.mark.parametrize("name,kw,padded", DENSE_CASES)
def test_dense_route_matches_jax(name, kw, padded):
    rng = np.random.default_rng(1)
    B, S, N, D = 2, 96, 4, 16
    q, k, v = _qkv(rng, B, S, N, D)
    jc, pc = _configs(name, kw, heads=N)
    mask = None
    if padded:
        mask = np.ones((B, S), np.int32)
        mask[0, 70:] = 0
        mask[1, 5::9] = 0
    want = np.asarray(J.sparse_self_attention(
        *(jnp.asarray(x) for x in (q, k, v)), jc,
        key_padding_mask=None if mask is None else jnp.asarray(mask)))
    got = P.sparse_self_attention(
        *(torch.tensor(x) for x in (q, k, v)), pc,
        key_padding_mask=None if mask is None else torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)


def test_kernel_route_refuses_a_padding_mask():
    pc = P.FixedSparsityConfig(num_heads=2, block=32, num_local_blocks=2)
    q, k, v = (torch.zeros(1, 128, 2, 16) for _ in range(3))
    with pytest.raises(NotImplementedError, match="key_padding_mask"):
        P.sparse_self_attention(q, k, v, pc, torch.ones(1, 128),
                                use_kernel=True)
    with pytest.raises(ValueError, match="heads"):
        P.sparse_self_attention(torch.zeros(1, 128, 3, 16), k, v, pc)


# ---------------------------------------------------------------------------
# the kernels' plain versions
# ---------------------------------------------------------------------------

KERNEL_CASES = [
    ("FixedSparsityConfig", dict(num_local_blocks=2), 256, 16),
    ("FixedSparsityConfig", dict(num_local_blocks=4, num_global_blocks=2,
                                 different_layout_per_head=True), 256, 16),
    ("BigBirdSparsityConfig", dict(different_layout_per_head=True,
                                   num_random_blocks=2), 256, 32),
    ("BSLongformerSparsityConfig", dict(attention="unidirectional"), 384,
     16),
    ("LocalSlidingWindowSparsityConfig", dict(num_sliding_window_blocks=5),
     256, 32),
    ("VariableSparsityConfig", dict(local_window_blocks=(3,),
                                    global_block_indices=(2,)), 256, 32),
]


@pytest.mark.parametrize("name,kw,S,D", KERNEL_CASES)
def test_plain_kernels_match_jax(name, kw, S, D):
    rng = np.random.default_rng(S + D)
    B, N = 2, 4
    q, k, v = _qkv(rng, B, S, N, D)
    do = rng.normal(size=(B, S, N, D)).astype(np.float32)
    jc, pc = _configs(name, kw, heads=N)
    plan = P.tile_plan_for(pc, S)
    assert (plan.kcount > 0).all()

    def jfn(q_, k_, v_):
        return J.sparse_self_attention(q_, k_, v_, jc, use_kernel=False)

    want, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (q, k, v)))
    want_g = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    causal = kw.get("attention", getattr(pc, "attention")) == "unidirectional"

    o, lse = reference_block_sparse_attention(tq, tk, tv, plan, causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)
    o2, lse2 = block_sparse_attention_fwd(tq, tk, tv, plan, causal)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    grads = reference_block_sparse_attention_bwd(tq, tk, tv, o, lse, tdo,
                                                 plan, causal)
    wrapped = block_sparse_attention_bwd(tq, tk, tv, o, lse, tdo, plan,
                                         causal)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = P.sparse_self_attention(*leaves, pc, use_kernel=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=ATOL)
    out.backward(tdo)
    for got in (grads, wrapped, [x.grad for x in leaves]):
        for g, w in zip(got, want_g):
            np.testing.assert_allclose(g.numpy(), w, atol=GRAD_ATOL,
                                       rtol=GRAD_ATOL)


def test_keyless_rows_give_zero_output_and_gradients():
    """The JAX kernels' semantics (``test_sparse_attention.py``
    ``test_empty_layout_row_outputs_zero``): q-tile 1 has no active k-tile;
    its rows output 0 and get 0 gradients, and the rows of q-tile 0 equal
    dense attention over the 128 keys they see."""
    layout = np.zeros((1, 2, 2), np.int64)
    layout[0, 0, 0] = 1
    plan = build_tile_plan(layout, 128, 256)
    assert plan.kcount.tolist() == [[1, 0]]
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 1, 256, 1, 32)
    tq, tk, tv = (torch.tensor(x).requires_grad_() for x in (q, k, v))
    out = block_sparse_attention(tq, tk, tv, plan)
    _, lse = reference_block_sparse_attention(tq, tk, tv, plan)
    assert torch.equal(out[:, 128:], torch.zeros_like(out[:, 128:]))
    assert bool(torch.isneginf(lse[..., 128:]).all())
    ref = jax_attention(*(jnp.asarray(x[:, :128]) for x in (q, k, v)), None,
                        causal=False)
    np.testing.assert_allclose(out[:, :128].detach().numpy(),
                               np.asarray(ref), atol=ATOL, rtol=ATOL)
    (out ** 2).sum().backward()
    ref_g = jax.grad(lambda a, b, c: jnp.sum(jax_attention(
        a, b, c, None, causal=False) ** 2), argnums=(0, 1, 2))(
        *(jnp.asarray(x[:, :128]) for x in (q, k, v)))
    for t, w in zip((tq, tk, tv), ref_g):
        assert bool(torch.isfinite(t.grad).all())
        np.testing.assert_allclose(t.grad[:, :128].numpy(), np.asarray(w),
                                   atol=GRAD_ATOL, rtol=GRAD_ATOL)
        assert float(t.grad[:, 128:].abs().max()) == 0.0


SPARSE_BWD_CPU_CASES = [
    ("FixedSparsityConfig", dict(num_local_blocks=4, num_global_blocks=1,
                                 attention="unidirectional"), 256, 16),
    ("LocalSlidingWindowSparsityConfig", dict(num_sliding_window_blocks=3,
                                              attention="unidirectional"),
     384, 16),
    ("BigBirdSparsityConfig", dict(different_layout_per_head=True,
                                   num_random_blocks=2), 256, 32),
]


@pytest.mark.parametrize("name,kw,S,block", SPARSE_BWD_CPU_CASES)
def test_sparse_bwd_on_cpu_is_the_plain_version(name, kw, S, block):
    """On CPU tensors ``block_sparse_attention_bwd`` launches nothing and
    returns ``reference_block_sparse_attention_bwd`` exactly."""
    pc = getattr(P, name)(num_heads=4, block=block, **kw)
    plan = P.tile_plan_for(pc, S)
    causal = kw.get("attention") == "unidirectional"
    rng = np.random.default_rng(S + block)
    tq, tk, tv, tdo = (torch.tensor(x) for x in (
        *_qkv(rng, 2, S, 4, 32), rng.normal(size=(2, S, 4, 32)).astype(
            np.float32)))
    o, lse = reference_block_sparse_attention(tq, tk, tv, plan, causal)
    before = launch_counts()
    got = block_sparse_attention_bwd(tq, tk, tv, o, lse, tdo, plan, causal)
    assert launch_counts() == before
    want = reference_block_sparse_attention_bwd(tq, tk, tv, o, lse, tdo,
                                                plan, causal)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name,kw,S,block", SPARSE_BWD_CPU_CASES)
def test_device_arrays_quadrants_and_bits(name, kw, S, block):
    """The backward's mask operands, from the plan's mask table: each 64 x
    64 quadrant's flag (0 empty, 1 full, 2 partial), the key-major words
    (bit r of ``bits[m, c, h]`` is ``masks[m, 64 h + r, c]``) and the key
    tiles ordered by falling transposed-list length."""
    plan = P.tile_plan_for(getattr(P, name)(num_heads=4, block=block, **kw),
                           S)
    arrs = plan.device_arrays(torch.device("cpu"))
    masks = plan.masks != 0
    bits = arrs["bits"].numpy().view(np.uint64)
    quad = arrs["quad"].numpy()
    assert bits.shape == (masks.shape[0], 128, 2)
    assert set(np.unique(quad)) <= {0, 1, 2}
    for m in range(masks.shape[0]):
        for h in range(2):
            for w in range(2):
                sub = masks[m, 64 * h:64 * h + 64, 64 * w:64 * w + 64]
                assert quad[m, h, w] == (1 if sub.all() else
                                         2 if sub.any() else 0)
            for c in range(128):
                word = int(bits[m, c, h])
                assert [(word >> r) & 1 for r in range(64)] == \
                    masks[m, 64 * h:64 * h + 64, c].astype(int).tolist()
    lengths = plan.qcount_t.sum(axis=0)[arrs["korder"].numpy()]
    assert sorted(arrs["korder"].tolist()) == list(range(S // 128))
    assert (np.diff(lengths) <= 0).all()


STAGE_CASES = (
    SPARSE_BWD_CPU_CASES
    + [(name, kw, S, 16) for name, kw, S, _ in KERNEL_CASES]
    + [("FixedSparsityConfig", dict(num_local_blocks=4,
                                    attention="unidirectional"), 256, 8),
       ("BigBirdSparsityConfig", dict(num_random_blocks=3, seed=11,
                                      different_layout_per_head=True), 256,
        8),
       ("empty_q_tile", {}, 384, 16)])


def _stage_case(name, kw, S, block, N=4):
    """(JAX config or None, plan, causal, the fine layout) of a STAGE_CASES
    entry; ``empty_q_tile``: a causal lower-triangular layout whose q-tile
    1 sees no key."""
    if name == "empty_q_tile":
        n = S // block
        layout = np.tile(np.tril(np.ones((n, n), np.int64)), (N, 1, 1))
        layout[:, 128 // block:256 // block] = 0
        return None, build_tile_plan(layout, block, S), True, layout
    jc, pc = _configs(name, kw, heads=N, block=block)
    causal = kw.get("attention", getattr(pc, "attention")) == "unidirectional"
    return jc, P.tile_plan_for(pc, S), causal, pc.make_layout(S)


def _cases_id(case):
    return f"{_id(case[:2])}-S{case[2]}-b{case[3]}"


@pytest.mark.parametrize("case", STAGE_CASES, ids=_cases_id)
def test_stage_plan_covers_each_visible_pair_once(case):
    """The forward's packed stages: every visible pair of every (head,
    q-tile) lies in exactly one slot column, each slot's mask id and column
    offset are its tile's, no slot holds a group that no row of the q-tile
    sees, each half's flag matches the mask, slots fill in list order with
    the empty ones last, and each ``scount`` is ceil(live groups / 8)."""
    _, plan, _, layout = _stage_case(*case)
    slots, scount = plan.stage_plan()
    N, nq = plan.kcount.shape
    S = plan.seq_len
    tok = plan.token_mask(torch.device("cpu")).numpy()
    masks = plan.masks != 0
    for n in range(N):
        for i in range(nq):
            rows = tok[n, 128 * i:128 * i + 128]
            seen = np.zeros((128, S), np.int64)
            live = rows.reshape(128, S // 16, 16).any(axis=(0, 2))
            assert scount[n, i] == -(-int(live.sum()) // 8)
            ent = slots[n, i].reshape(-1, 4)
            keys = ent[:, 0]
            used = int((keys >= 0).sum())
            assert used == live.sum() and (keys[:used] >= 0).all()
            assert (keys[used:] == -1).all()
            assert (np.diff(keys[:used]) > 0).all()  # list order
            for key0, mk, coff, fl in ent[:used]:
                assert coff == key0 % 128 and coff % 16 == 0
                sub = masks[mk, :, coff:coff + 16]
                np.testing.assert_array_equal(sub,
                                              rows[:, key0:key0 + 16])
                assert sub.any()
                for h in range(2):
                    half = sub[64 * h:64 * h + 64]
                    want = 1 if half.all() else 2 if half.any() else 0
                    assert (fl >> 2 * h) & 3 == want
                seen[:, key0:key0 + 16] += sub
            np.testing.assert_array_equal(seen, rows.astype(np.int64))
    assert slots.shape[2] == max(1, int(scount.max()))
    if case[0] == "empty_q_tile":
        assert (scount[:, 1] == 0).all()


@pytest.mark.parametrize("case", STAGE_CASES, ids=_cases_id)
def test_forward_operands_rowbits_and_qorder(case):
    """``rowbits`` equals the mask table bit for bit (bit c of ``rowbits[m,
    r, h]`` is ``masks[m, r, 64 h + c]``); ``qorder`` is a permutation of
    the q-tiles by falling stage count summed over heads."""
    _, plan, _, _ = _stage_case(*case)
    arrs = plan.device_arrays(torch.device("cpu"))
    masks = (plan.masks != 0).astype(np.uint64)
    words = arrs["rowbits"].numpy().view(np.uint64)
    assert words.shape == (masks.shape[0], 128, 2)
    for h in range(2):
        for c in range(64):
            np.testing.assert_array_equal((words[..., h] >> np.uint64(c))
                                          & np.uint64(1),
                                          masks[:, :, 64 * h + c])
    slots, scount = plan.stage_plan()
    assert torch.equal(arrs["slots"], torch.from_numpy(slots))
    assert torch.equal(arrs["scount"], torch.from_numpy(scount))
    qorder = arrs["qorder"].numpy()
    assert sorted(qorder.tolist()) == list(range(plan.kcount.shape[1]))
    assert (np.diff(scount.sum(axis=0)[qorder]) <= 0).all()


def emulate_packed_forward(q, k, v, plan, causal, scale=None):
    """fp32 emulation of ``sparse_fwd_tma_kernel``'s walk: per (batch row,
    head, q-tile) the packed stages in order, each a 128-key block of 8
    group slots (empty ones and, under causality, groups past every row of
    the tile never loaded: zeros), scores of the stage scaled by scale *
    log2 e, invisible pairs selected to -inf from the slot's flags, the
    query-major mask words and the slot's absolute keys, the online softmax
    in base 2 (a row that has seen no key subtracts 0), p selected to 0
    where invisible, O += P V; o = O / l (0 without a key), lse = (m +
    log2 l) ln 2 (-inf without a key)."""
    B, S, N, D = q.shape
    scale2 = (D ** -0.5 if scale is None else scale) * np.log2(np.e)
    slots, scount = plan.stage_plan()
    words = plan.device_arrays(torch.device("cpu"))["rowbits"].numpy().view(
        np.uint64)
    o = torch.zeros(B, S, N, D)
    lse = torch.full((B, N, S), float("-inf"))
    cc = np.arange(16)
    for n in range(N):
        for i in range(S // 128):
            i0 = 128 * i
            rows = np.arange(i0, i0 + 128)
            m = torch.full((B, 128), float("-inf"))
            l = torch.zeros(B, 128)
            acc = torch.zeros(B, 128, D)
            qf = q[:, i0:i0 + 128, n].float()
            for st in range(scount[n, i]):
                kk, vv = torch.zeros(B, 128, D), torch.zeros(B, 128, D)
                vis = np.zeros((128, 128), bool)
                for j, (key0, mk, coff, fl) in enumerate(slots[n, i, st]):
                    if key0 < 0 or (causal and key0 > i0 + 127):
                        continue
                    kk[:, 16 * j:16 * j + 16] = k[:, key0:key0 + 16, n]
                    vv[:, 16 * j:16 * j + 16] = v[:, key0:key0 + 16, n]
                    for h in range(2):
                        if not (fl >> 2 * h) & 3:
                            continue
                        w = words[mk, 64 * h:64 * h + 64, coff >> 6] >> \
                            np.uint64(coff & 63)
                        bits = (w[:, None] >> cc.astype(np.uint64)) & \
                            np.uint64(1)
                        sub = bits.astype(bool)
                        if causal:
                            sub &= key0 + cc[None] <= rows[64 * h:64 * h + 64,
                                                           None]
                        vis[64 * h:64 * h + 64, 16 * j:16 * j + 16] = sub
                tv = torch.from_numpy(vis)
                s = torch.einsum("brd,bcd->brc", qf, kk) * scale2
                s = torch.where(tv, s, torch.full_like(s, float("-inf")))
                mn = torch.maximum(m, s.max(-1).values)
                mu = torch.where(torch.isneginf(mn), torch.zeros_like(mn), mn)
                corr = torch.exp2(m - mu)
                p = torch.where(tv, torch.exp2(s - mu[..., None]),
                                torch.zeros_like(s))
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + torch.einsum("brc,bcd->brd", p,
                                                           vv)
                m = mn
            inv = torch.where(l > 0, 1.0 / l, torch.zeros_like(l))
            o[:, i0:i0 + 128, n] = acc * inv[..., None]
            lse[:, n, i0:i0 + 128] = torch.where(
                l > 0, (m + torch.log2(l)) * np.log(2.0),
                torch.full_like(l, float("-inf")))
    return o, lse


@pytest.mark.parametrize("case", STAGE_CASES, ids=_cases_id)
def test_packed_stage_emulation_matches_jax(case):
    """The kernel's packed-stage walk (``emulate_packed_forward``: stage
    order, slot order, select-to-zero) against JAX's dense-mask route
    ``J.sparse_self_attention(..., use_kernel=False)`` (fp32, ATOL), and
    its lse against the plain version's; the empty q-tile case against
    JAX's attention over each row's visible keys, its key-less rows 0 and
    lse -inf."""
    jc, plan, causal, layout = _stage_case(*case)
    S, N, D = plan.seq_len, plan.num_heads, 32
    rng = np.random.default_rng(S + case[3])
    q, k, v = _qkv(rng, 2, S, N, D)
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    o, lse = emulate_packed_forward(tq, tk, tv, plan, causal)
    _, ref_lse = reference_block_sparse_attention(tq, tk, tv, plan, causal)
    live = torch.isfinite(ref_lse)
    assert torch.equal(torch.isfinite(lse), live)
    np.testing.assert_allclose(lse[live].numpy(), ref_lse[live].numpy(),
                               atol=ATOL, rtol=ATOL)
    if jc is not None:
        want = J.sparse_self_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                       jc, use_kernel=False)
        np.testing.assert_allclose(o.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=ATOL)
        return
    tok = np.asarray(J.layout_to_token_mask(layout, case[3])) * np.tril(
        np.ones((S, S), np.int32))
    for n in range(N):
        want = jax_attention(*(jnp.asarray(x[:, :, n:n + 1]) for x in
                               (q, k, v)), jnp.asarray(tok[n][None]),
                             causal=False)
        keep = tok[n].any(axis=-1)
        np.testing.assert_allclose(o[:, keep, n].numpy(),
                                   np.asarray(want)[:, keep, 0], atol=ATOL,
                                   rtol=ATOL)
        assert float(o[:, ~keep, n].abs().max()) == 0.0
    assert bool(torch.isneginf(lse[..., 128:256]).all())


def test_kernel_route_refuses_gqa_and_counts_nothing_on_the_cpu():
    pc = P.FixedSparsityConfig(num_heads=4, block=16)
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(x) for x in _qkv(rng, 1, 128, 4, 16, K=2))
    with pytest.raises(ValueError, match="no GQA"):
        P.sparse_self_attention(q, k, v, pc, use_kernel=True)
    # the dense route broadcasts k / v heads as JAX's does
    want = J.sparse_self_attention(*(jnp.asarray(x.numpy())
                                     for x in (q, k, v)),
                                   J.FixedSparsityConfig(num_heads=4,
                                                         block=16),
                                   use_kernel=False)
    got = P.sparse_self_attention(q, k, v, pc, use_kernel=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    before = launch_counts()
    k4, v4 = (torch.tensor(x) for x in _qkv(rng, 1, 128, 4, 16)[1:])
    P.sparse_self_attention(q, k4, v4, pc, use_kernel=True)
    assert launch_counts() == before


# ---------------------------------------------------------------------------
# the attention impl in the model
# ---------------------------------------------------------------------------


def test_impl_checks_match_jax():
    pc = P.FixedSparsityConfig(num_heads=2, block=16)
    impl = P.make_sparse_attention_impl(pc)
    q = torch.zeros(1, 128, 2, 16)
    with pytest.raises(NotImplementedError, match="alibi"):
        impl(q, q, q, None, causal=True, alibi=torch.zeros(2))
    with pytest.raises(ValueError, match="causality"):
        impl(q, q, q, None, causal=False)
    bi = P.make_sparse_attention_impl(
        P.BigBirdSparsityConfig(num_heads=2, block=16))
    with pytest.raises(ValueError, match="causality"):
        bi(q, q, q, None, causal=True)
    model = create_model("tiny", dtype=torch.float32, attention_impl=impl)
    assert active_attention_impl(model.config) == "custom"
    assert active_attention_impl(create_model("tiny").config) == \
        "flash_attention"


SEQ = 128


def _impls(name, kw, heads, use_kernel=None):
    jc, pc = _configs(name, kw, heads=heads)
    return (J.make_sparse_attention_impl(jc),
            P.make_sparse_attention_impl(pc, use_kernel=use_kernel))


@pytest.mark.parametrize("use_kernel", [None, True])
def test_forward_with_sparse_impl_matches_jax(use_kernel):
    jimpl, pimpl = _impls("FixedSparsityConfig", dict(num_local_blocks=2), 4,
                          use_kernel)
    jmodel = jax_create_model("tiny", dtype=jnp.float32, max_seq_len=SEQ,
                              attention_impl=jimpl)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    pmodel = create_model("tiny", dtype=torch.float32, max_seq_len=SEQ,
                          attention_impl=pimpl)
    params = params_from_jax(tree, pmodel.config)
    ids = np.random.default_rng(0).integers(0, 250, (2, SEQ))
    want, _, _ = jax_forward(jax.tree.map(jnp.asarray, tree),
                             jnp.asarray(ids), jmodel.config)
    for plain in (False, True):
        got, _ = forward(params, torch.tensor(ids), pmodel.config,
                         plain=plain)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)


def _lamb_config(lr=1e-3, clip=0.0, **extra):
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": 1, "steps_per_print": 1000,
           "gradient_clipping": clip,
           "optimizer": {"type": "lamb",
                         "params": {"lr": lr, "weight_decay": 0.01}}}
    cfg.update(extra)
    return cfg


def _batches(steps, masked, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        b = {"input_ids": rng.integers(0, 250, (1, 2, SEQ))}
        if masked:
            lens = rng.integers(SEQ // 2, SEQ + 1, (1, 2))
            b["attention_mask"] = (np.arange(SEQ)[None, None]
                                   < lens[..., None]).astype(np.int32)
            b["input_ids"] = b["input_ids"] * b["attention_mask"]
        out.append(b)
    return out


# (preset, sparsity config or None, port use_kernel, key padding, clip):
# LAMB alone, then LAMB with a sparse impl on the kernels' plain versions
# (Fixed) or the dense-mask route with key padding (sliding window)
TRAJECTORIES = [
    ("tiny", None, None, True, 0.5),
    ("tiny-gptneox", None, None, False, 0.0),
    ("tiny", ("FixedSparsityConfig", dict(num_local_blocks=2)), True, False,
     0.5),
    ("tiny-gptneox", ("LocalSlidingWindowSparsityConfig",
                      dict(num_sliding_window_blocks=5)), None, True, 0.0),
]


@pytest.mark.parametrize("preset,sparse,use_kernel,masked,clip",
                         TRAJECTORIES)
def test_train_trajectory_matches_jax(preset, sparse, use_kernel, masked,
                                      clip):
    cfg = _lamb_config(clip=clip)
    jkw, pkw = {}, {}
    if sparse is not None:
        jimpl, pimpl = _impls(*sparse, 4, use_kernel)
        jkw, pkw = dict(attention_impl=jimpl), dict(attention_impl=pimpl)
    jmodel = jax_create_model(preset, dtype=jnp.float32, max_seq_len=SEQ,
                              **jkw)
    jeng, *_ = deepspeed_tpu.initialize(
        model=jmodel, config=cfg, mesh=build_mesh(devices=jax.devices()[:1]))
    start = jax.tree.map(np.asarray, jax.device_get(jeng.params))
    pmodel = create_model(preset, dtype=torch.float32, max_seq_len=SEQ,
                          **pkw)
    params = params_from_jax(start, pmodel.config)
    model = Model(init=lambda generator: params, config=pmodel.config,
                  name=preset, loss_fn=pmodel.loss_fn)
    peng, *_ = initialize(model=model, config=cfg, device="cpu")
    assert peng.optimizer.lamb
    for b in _batches(20, masked):
        want = float(jeng.train_batch(batch=jax.tree.map(jnp.asarray, b)))
        got = float(peng.train_batch(batch=b))
        np.testing.assert_allclose(got, want, rtol=1e-4)
    final = jax.tree.map(np.asarray, jax.device_get(jeng.params))
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, atol=1e-4),
                 params_to_numpy(peng.params), final)


def test_sparse_model_decode_raises_as_jax():
    """A unidirectional sparse impl refuses the dense-cache and paged modes:
    they call it with causal=False over the arena, in both packages."""
    jimpl, pimpl = _impls("FixedSparsityConfig", {}, 4)
    jmodel = jax_create_model("tiny", dtype=jnp.float32, max_seq_len=SEQ,
                              attention_impl=jimpl)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    pcfg = create_model("tiny", dtype=torch.float32, max_seq_len=SEQ,
                        attention_impl=pimpl).config
    params = params_from_jax(tree, pcfg)
    ids = np.arange(8)[None] % 250
    for S, start in ((8, 0), (1, 8)):
        x = ids[:, :S]
        with pytest.raises(ValueError, match="causality") as jerr:
            jax_forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
                        jmodel.config,
                        cache=jax_kv_cache.init_cache(jmodel.config, 1, SEQ,
                                                      jnp.float32),
                        start_pos=start)
        with pytest.raises(ValueError, match="causality") as perr:
            forward(params, torch.tensor(x), pcfg,
                    cache=init_cache(pcfg, 1, SEQ, torch.float32, "cpu"),
                    start_pos=start)
        assert str(perr.value) == str(jerr.value)
    table = np.array([[1, 2]], np.int32)
    pos = np.arange(8)[None]
    with pytest.raises(ValueError, match="causality") as jerr:
        jax_forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(ids),
                    jmodel.config,
                    cache=jax_kv_cache.init_paged_cache(jmodel.config, 3, 8,
                                                        jnp.float32),
                    positions=jnp.asarray(pos),
                    block_table=jnp.asarray(table))
    with pytest.raises(ValueError, match="causality") as perr:
        forward(params, torch.tensor(ids), pcfg,
                cache=init_paged_cache(pcfg, 3, 8, torch.float32, "cpu"),
                positions=torch.tensor(pos), block_table=torch.tensor(table))
    assert str(perr.value) == str(jerr.value)
