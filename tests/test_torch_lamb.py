"""LAMB: the port against the JAX package, on the CPU.

* ``fused_lamb_flat`` (on a CPU tensor: the phase-1 kernel's plain version,
  then phase 2) against JAX ``fused_lamb_flat(interpret=True)`` and JAX
  ``reference_lamb_flat``, and the port's ``reference_lamb_flat`` against
  JAX's, over several steps, n not a multiple of 8192, weight decay, no
  bias correction and an engaged clamp, at 1e-6.
* The segmented step (one phase-1 pass over a block plan whose blocks never
  straddle a segment) against ``reference_lamb_flat`` per segment, its
  extra operands (gradient multiplier, skip flag, 16-bit copy), and the
  block plan itself.
* ``MixedPrecisionOptimizer`` in LAMB mode against JAX's ``build_optimizer``
  for ``lamb`` (``optax.lamb``: per-leaf trust ratios, no clamp, eps 1e-8)
  over 5 steps: fp32 and bf16 params, clipping, a warm-up schedule, an
  fp16-style skipped step, and DeepSpeed's FusedLamb keys, which both
  packages ignore.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.config.config import load_config as jax_load_config
from deepspeed_tpu.runtime.optimizer import build_optimizer as jax_build
from deepspeed_tpu_torch.config import load_config
from deepspeed_tpu_torch.models.core import tree_leaves
from deepspeed_tpu_torch.ops import (LambSegments, fused_lamb_flat,
                                     lamb_phase1, lamb_step,
                                     reference_lamb_flat,
                                     reference_lamb_phase1)
from deepspeed_tpu_torch.ops.fused_lamb import BLOCK
from deepspeed_tpu_torch.runtime import build_optimizer

JL = importlib.import_module("deepspeed_tpu.ops.fused_lamb")

FLAT_CASES = [dict(), dict(weight_decay=0.01),
              dict(weight_decay=0.1, bias_correction=False),
              dict(weight_decay=0.01, max_coeff=0.3, min_coeff=0.1),
              dict(min_coeff=2.0, max_coeff=4.0)]


@pytest.mark.parametrize("kw", FLAT_CASES)
@pytest.mark.parametrize("n", [20000, 8192, 777])
def test_lamb_flat_matches_jax(kw, n):
    rng = np.random.RandomState(n)
    p0 = rng.randn(n).astype(np.float32)
    jp, jm, jv = jnp.asarray(p0), jnp.zeros(n), jnp.zeros(n)
    rp, rm, rv = jp, jm, jv
    tp, tm, tv = torch.tensor(p0), torch.zeros(n), torch.zeros(n)
    sp, sm, sv = torch.tensor(p0), torch.zeros(n), torch.zeros(n)
    for step in range(1, 4):
        g = rng.randn(n).astype(np.float32)
        jp, jm, jv = JL.fused_lamb_flat(jp, jnp.asarray(g), jm, jv, step,
                                        lr=1e-2, interpret=True, **kw)
        rp, rm, rv = JL.reference_lamb_flat(rp, jnp.asarray(g), rm, rv, step,
                                            lr=1e-2, **kw)
        fused_lamb_flat(tp, torch.tensor(g), tm, tv, step, lr=1e-2, **kw)
        reference_lamb_flat(sp, torch.tensor(g), sm, sv, step, lr=1e-2, **kw)
    for got, a, b in zip((tp, tm, tv), (jp, jm, jv), (rp, rm, rv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(a), atol=1e-6)
        np.testing.assert_allclose(got.numpy(), np.asarray(b), atol=1e-6)
    for got, b in zip((sp, sm, sv), (rp, rm, rv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(b), atol=1e-6)


def test_segments_never_straddle():
    sizes = [5, BLOCK, BLOCK + 1, 3 * BLOCK - 7, 1]
    seg = LambSegments.from_sizes(sizes)
    assert seg.n == sum(sizes)
    assert seg.block_len.max() <= BLOCK and seg.block_len.min() >= 1
    # the blocks tile the buffer in order
    np.testing.assert_array_equal(
        seg.block_start[1:], seg.block_start[:-1] + seg.block_len[:-1])
    bounds = np.cumsum(sizes)
    ends = seg.block_start + seg.block_len
    assert set(bounds) <= set(ends)          # every segment ends on a block
    np.testing.assert_array_equal(ends[seg.seg_end - 1], bounds)
    with pytest.raises(ValueError, match="positive"):
        LambSegments.from_sizes([3, 0])


def test_segmented_step_is_lamb_per_segment():
    """One phase-1 pass over three segments equals reference_lamb_flat on
    each segment alone; the clamp is open as the optimizer runs it."""
    rng = np.random.RandomState(2)
    sizes = [BLOCK + 5, 300, 2 * BLOCK]
    n = sum(sizes)
    seg = LambSegments.from_sizes(sizes)
    p0 = rng.randn(n).astype(np.float32)
    p0[BLOCK + 5:BLOCK + 305] = 0.0          # a zero segment: ratio 1
    p, m, v, u = (torch.tensor(p0), torch.zeros(n), torch.zeros(n),
                  torch.zeros(n))
    refs = [[torch.tensor(x) for x in (s, np.zeros_like(s), np.zeros_like(s))]
            for s in np.split(p0, np.cumsum(sizes)[:-1])]
    kw = dict(beta1=0.8, beta2=0.99, eps=1e-8, weight_decay=0.01,
              max_coeff=float("inf"), min_coeff=0.0)
    for step in range(1, 4):
        g = rng.randn(n).astype(np.float32)
        ratios = lamb_step(p, torch.tensor(g), m, v, u, seg, step, 1e-2,
                           **kw)
        assert ratios.shape == (3,)
        assert step > 1 or float(ratios[1]) == 1.0    # ||p|| == 0
        for (rp, rm, rv), gs in zip(refs, np.split(g, np.cumsum(sizes)[:-1])):
            reference_lamb_flat(rp, torch.tensor(gs), rm, rv, step, 1e-2,
                                **kw)
    for got, i in ((p, 0), (m, 1), (v, 2)):
        want = torch.cat([r[i] for r in refs])
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_phase1_extra_operands():
    """``grad_scale`` multiplies the gradient; a set ``skip`` keeps m and v
    and zeroes u and the partials, so the step leaves p as it was;
    ``param_copy`` receives the updated params rounded."""
    rng = np.random.RandomState(1)
    n = 3 * BLOCK + 11
    seg = LambSegments.from_sizes([n - 100, 100])
    p, g = (torch.tensor(rng.randn(n).astype(np.float32)) for _ in range(2))
    m, v = (torch.tensor(rng.rand(n).astype(np.float32)) for _ in range(2))
    bufs = [[x.clone() for x in (p, m, v, torch.zeros(n))] for _ in range(2)]
    part = [reference_lamb_phase1(*bufs[0][:1], g, *bufs[0][1:], seg, 3,
                                  weight_decay=0.01,
                                  grad_scale=torch.tensor([0.25])),
            lamb_phase1(*bufs[1][:1], g * 0.25, *bufs[1][1:], seg, 3,
                        weight_decay=0.01)]
    for a, b in zip(bufs[0] + [part[0]], bufs[1] + [part[1]]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    assert part[0].shape == (seg.nblocks, 2)
    sums = [float(part[0][:, 0].sum()), float(part[0][:, 1].sum())]
    np.testing.assert_allclose(sums, [float((p * p).sum()),
                                      float((bufs[0][3] ** 2).sum())],
                               rtol=1e-5)
    pp, mm, vv, uu = bufs[0]
    snap = [x.clone() for x in (pp, mm, vv)]
    copy = torch.empty(n, dtype=torch.bfloat16)
    lamb_step(pp, g, mm, vv, uu, seg, 4, 1e-2, param_copy=copy,
              skip=torch.tensor([True]))
    for a, b in zip((pp, mm, vv), snap):
        assert torch.equal(a, b)
    assert float(uu.abs().max()) == 0.0
    torch.testing.assert_close(copy, snap[0].bfloat16(), atol=0, rtol=0)
    lamb_step(pp, g, mm, vv, uu, seg, 4, 1e-2, param_copy=copy)
    assert not torch.equal(pp, snap[0])
    torch.testing.assert_close(copy, pp.bfloat16(), atol=0, rtol=0)


# ---------------------------------------------------------------------------
# MixedPrecisionOptimizer in LAMB mode
# ---------------------------------------------------------------------------

SHAPES = {"w": (8, 16), "b": (16,), "layers": {"k": (2, 4, 4),
                                               "z": (3,)}}


def _tree(rng, zero_leaf=False):
    def walk(path, node):
        if isinstance(node, dict):
            return {k: walk(path + k, v) for k, v in node.items()}
        a = rng.normal(0, 1.0, node).astype(np.float32)
        return a * 0 if zero_leaf and path.endswith("z") else a

    return walk("", SHAPES)


def _torch_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _torch_tree(v, dtype) for k, v in tree.items()}
    return torch.tensor(tree).to(dtype)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().float().numpy()


def _order(tree):
    """A JAX tree (sorted keys) in SHAPES' key order, as the port flattens."""
    def walk(shape, node):
        if isinstance(shape, dict):
            return {k: walk(shape[k], node[k]) for k in shape}
        return node

    return walk(SHAPES, tree)


OPT_CASES = [
    # (params, clip, scheduler, dtype, skip step)
    ({"lr": 1e-2}, 0.0, None, torch.float32, None),
    ({"lr": 1e-2, "weight_decay": 0.05, "betas": [0.8, 0.99], "eps": 1e-6},
     0.0, None, torch.float32, None),
    ({"lr": 1e-2, "weight_decay": 0.01}, 0.5, None, torch.float32, 2),
    ({"lr": 1e-2, "weight_decay": 0.01, "max_coeff": 0.5, "min_coeff": 0.3,
      "bias_correction": False}, 0.0,
     {"type": "WarmupLR", "params": {"warmup_num_steps": 3,
                                     "warmup_max_lr": 1e-2}},
     torch.float32, None),
    ({"lr": 1e-2, "weight_decay": 0.01}, 0.3, None, torch.bfloat16, 1),
]


@pytest.mark.parametrize("params,clip,sched,dtype,skip_at", OPT_CASES)
def test_lamb_optimizer_matches_jax(params, clip, sched, dtype, skip_at):
    cfg = {"train_micro_batch_size_per_gpu": 1, "gradient_clipping": clip,
           "optimizer": {"type": "lamb", "params": params}}
    if sched is not None:
        cfg["scheduler"] = sched
    rng = np.random.default_rng(3)
    tree = _tree(rng, zero_leaf=True)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jopt = jax_build(jax_load_config(cfg))
    jparams = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), tree)
    jstate = jopt.init(jparams)
    opt = build_optimizer(load_config(cfg))
    assert opt.lamb and opt.eps == params.get("eps", 1e-8)
    state = opt.init(_torch_tree(tree, dtype))
    for step in range(5):
        tgrads = _torch_tree(_tree(rng), dtype)
        grads = jax.tree.map(lambda a: a, _np(tgrads))
        for view, g in zip(tree_leaves(state.grads), tree_leaves(tgrads)):
            view.copy_(g)
        skip = step == skip_at
        jparams, jstate, jstats = jopt.apply(
            jparams, jax.tree.map(jnp.asarray, grads), jstate,
            skip_update=jnp.asarray(skip))
        stats = opt.apply(state, skip=torch.tensor(skip) if skip_at is not None
                          else None)
        np.testing.assert_allclose(float(stats.grad_norm),
                                   float(jstats.grad_norm), rtol=1e-6)
        np.testing.assert_allclose(stats.lr, float(jstats.lr), rtol=1e-6)
        assert bool(stats.skipped) == skip
    want = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jparams)
    got = _np(state.params)
    for a, b in zip(tree_leaves(got), tree_leaves(_order(want))):
        np.testing.assert_allclose(a, b, atol=1e-6,
                                   rtol=2 ** -7 if dtype != torch.float32
                                   else 0)
    if dtype != torch.float32:
        master = jax.tree.map(np.asarray, jstate.master)
        np.testing.assert_allclose(
            state.master.numpy(),
            np.concatenate([np.ravel(a) for a in tree_leaves(_order(master))]),
            atol=1e-6)
    assert opt.skipped_steps(state) == (1 if skip_at is not None else 0)


def test_lamb_plain_optimizer_equals_the_default_on_the_cpu():
    cfg = load_config({"train_micro_batch_size_per_gpu": 1,
                       "optimizer": {"type": "lamb",
                                     "params": {"weight_decay": 0.01}}})
    opts = [build_optimizer(cfg), build_optimizer(cfg)]
    opts[1].plain = True
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    states = [o.init(_torch_tree(tree, torch.float32)) for o in opts]
    for _ in range(3):
        g = torch.tensor(rng.normal(size=states[0].n).astype(np.float32))
        for o, s in zip(opts, states):
            o.apply(s, g)
    assert torch.equal(states[0].param_flat, states[1].param_flat)
    assert states[0].segments.sizes == (128, 16, 32, 3)
