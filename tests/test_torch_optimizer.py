"""The port's optimizer stack against the JAX package's, on the CPU.

* ``reference_adam_flat`` (the fused Adam kernel's plain version) against
  JAX ``fused_adam_flat(interpret=True)`` and JAX ``reference_adam_flat``
  over the weight-decay / AdamW grid of ``tests/kernels/test_pallas_ops.py``,
  at 1e-6; its extra operands (gradient multiplier, skip flag, 16-bit copy)
  against their definitions.
* ``MixedPrecisionOptimizer`` against JAX's over 5 steps on a small tree:
  adam, adamw, fusedadam, weight decay, clipping, a warm-up schedule, an
  fp16-style skipped step, and bf16 params with fp32 master weights.
* The five lr schedules over 200 steps, the loss scalers over an overflow
  pattern with hysteresis, the training config sections, and the data
  loader, each against its JAX counterpart.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.config.config import load_config as jax_load_config
from deepspeed_tpu.ops.fused_adam import fused_adam_flat as jax_fused_adam
from deepspeed_tpu.ops.fused_adam import reference_adam_flat as jax_ref_adam
from deepspeed_tpu.runtime import dataloader as jax_dataloader
from deepspeed_tpu.runtime import loss_scaler as jax_scaler
from deepspeed_tpu.runtime import lr_schedules as jax_lr
from deepspeed_tpu.runtime.optimizer import build_optimizer as jax_build
from deepspeed_tpu_torch.config import ConfigError, load_config
from deepspeed_tpu_torch.models.core import tree_leaves
from deepspeed_tpu_torch.ops import reference_adam_flat
from deepspeed_tpu_torch.runtime import (DeepSpeedDataLoader, RepeatingLoader,
                                         build_optimizer, has_overflow)
from deepspeed_tpu_torch.runtime import loss_scaler, lr_schedules


# ---------------------------------------------------------------------------
# the Adam kernel's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wd,adam_w", [(0.0, True), (0.01, True),
                                       (0.01, False)])
def test_adam_flat_matches_jax(wd, adam_w):
    rng = np.random.RandomState(0)
    n = 10000
    p0, g = rng.randn(n).astype(np.float32), rng.randn(n).astype(np.float32)
    jp, jm, jv = jnp.asarray(p0), jnp.zeros(n), jnp.zeros(n)
    rp, rm, rv = jp, jm, jv
    tp, tm, tv = torch.tensor(p0), torch.zeros(n), torch.zeros(n)
    for step in range(1, 4):
        kw = dict(lr=1e-2, weight_decay=wd, adam_w_mode=adam_w)
        jp, jm, jv = jax_fused_adam(jp, jnp.asarray(g), jm, jv, step,
                                    interpret=True, **kw)
        rp, rm, rv = jax_ref_adam(rp, jnp.asarray(g), rm, rv, step, **kw)
        reference_adam_flat(tp, torch.tensor(g), tm, tv, step, **kw)
    for got, a, b in zip((tp, tm, tv), (jp, jm, jv), (rp, rm, rv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(a), atol=1e-6)
        np.testing.assert_allclose(got.numpy(), np.asarray(b), atol=1e-6)


def test_adam_flat_extra_operands():
    """``grad_scale`` multiplies the gradient, a set ``skip`` writes
    nothing, ``param_copy`` receives the updated params rounded."""
    rng = np.random.RandomState(1)
    n = 777
    p, g = (torch.tensor(rng.randn(n).astype(np.float32)) for _ in range(2))
    m, v = torch.zeros(n), torch.zeros(n)
    bufs = [[x.clone() for x in (p, m, v)] for _ in range(2)]
    copy = torch.empty(n, dtype=torch.bfloat16)
    reference_adam_flat(*bufs[0][:1], g, *bufs[0][1:], 2, lr=1e-2,
                        grad_scale=torch.tensor([0.25]), param_copy=copy)
    reference_adam_flat(*bufs[1][:1], g * 0.25, *bufs[1][1:], 2, lr=1e-2)
    for a, b in zip(*bufs):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=0)
    torch.testing.assert_close(copy, bufs[0][0].bfloat16(), atol=0, rtol=0)
    snap = [x.clone() for x in bufs[0]]
    reference_adam_flat(*bufs[0][:1], g, *bufs[0][1:], 3,
                        skip=torch.tensor([True]), param_copy=copy)
    for a, b in zip(bufs[0], snap):
        assert torch.equal(a, b)
    torch.testing.assert_close(copy, snap[0].bfloat16(), atol=0, rtol=0)


# ---------------------------------------------------------------------------
# MixedPrecisionOptimizer
# ---------------------------------------------------------------------------

SHAPES = {"w": (8, 16), "b": (16,), "layers": {"k": (2, 4, 4)}}


def _tree(rng):
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return rng.normal(0, 1.0, node).astype(np.float32)

    return walk(SHAPES)


def _torch_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _torch_tree(v, dtype) for k, v in tree.items()}
    return torch.tensor(tree).to(dtype)


OPT_CASES = [
    # (type, params, clip, scheduler, dtype, skip step)
    ("adam", {"lr": 1e-2}, 0.0, None, torch.float32, None),
    ("adam", {"lr": 1e-2, "weight_decay": 0.05}, 0.0, None, torch.float32,
     None),
    ("adamw", {"lr": 1e-2, "weight_decay": 0.05, "betas": [0.8, 0.99],
               "eps": 1e-6}, 0.0, None, torch.float32, None),
    ("fusedadam", {"lr": 1e-2, "weight_decay": 0.05}, 0.5, None,
     torch.float32, None),
    ("fusedadam", {"lr": 1e-2, "weight_decay": 0.05, "adam_w_mode": False},
     1e9, None, torch.float32, None),
    ("adamw", {"lr": 1e-2}, 0.0,
     {"type": "WarmupLR", "params": {"warmup_num_steps": 4,
                                     "warmup_max_lr": 1e-2,
                                     "warmup_type": "linear"}},
     torch.float32, 2),
    ("adamw", {"lr": 1e-2, "weight_decay": 0.01}, 0.3, None, torch.bfloat16,
     None),
]


@pytest.mark.parametrize("name,params,clip,sched,dtype,skip_at", OPT_CASES)
def test_mixed_precision_optimizer_matches_jax(name, params, clip, sched,
                                               dtype, skip_at):
    cfg = {"train_micro_batch_size_per_gpu": 1, "gradient_clipping": clip,
           "optimizer": {"type": name, "params": params}}
    if sched is not None:
        cfg["scheduler"] = sched
    rng = np.random.default_rng(3)
    tree = _tree(rng)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jopt = jax_build(jax_load_config(cfg))
    jparams = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), tree)
    jstate = jopt.init(jparams)
    opt = build_optimizer(load_config(cfg))
    state = opt.init(_torch_tree(tree, dtype))
    for step in range(5):
        grads = _tree(rng)
        # the same (dtype-rounded) gradient values for both
        tgrads = _torch_tree(grads, dtype)
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
        # bf16 params: one rounding of the fp32 master, which may land one
        # bf16 ulp apart where the two masters differ in the last fp32 bits
        np.testing.assert_allclose(a, b, atol=1e-6,
                                   rtol=2 ** -7 if dtype != torch.float32
                                   else 0)
    if dtype != torch.float32:
        assert state.master is not None
        master = jax.tree.map(np.asarray, jstate.master)
        np.testing.assert_allclose(
            state.master.numpy(),
            np.concatenate([np.ravel(a) for a in tree_leaves(_order(master))]),
            atol=1e-6)
    assert opt.skipped_steps(state) == (1 if skip_at is not None else 0)


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


def test_optimizer_params_share_one_flat_buffer():
    opt = build_optimizer(load_config({"train_micro_batch_size_per_gpu": 1}))
    state = opt.init(_torch_tree(_tree(np.random.default_rng(0)),
                                 torch.bfloat16))
    base = state.param_flat.data_ptr()
    size = state.param_flat.element_size()
    offset = 0
    for p in tree_leaves(state.params):
        assert p.requires_grad and p.is_leaf
        assert p.data_ptr() == base + offset * size
        assert p.grad.data_ptr() == (state.grad_flat.data_ptr()
                                     + offset * size)
        offset += p.numel()
    assert offset == state.n and state.master.dtype == torch.float32


def test_clip_norm_sums_in_float64_on_the_cpu():
    """The clip norm of 1e6 fp32 grads on the CPU is their float64 norm
    rounded to fp32 (torch's fp32 CPU norm sums in fp32 and was 1e-5
    relative off here, enough to move the clip coefficient and so every
    moment), and clipping scales by it."""
    from deepspeed_tpu_torch.runtime.optimizer import grad_norm

    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        10 ** 6).astype(np.float32) * 1e-3)
    exact = torch.linalg.vector_norm(g.double()).float()
    assert torch.equal(grad_norm(g), exact)
    opt = build_optimizer(load_config({"train_micro_batch_size_per_gpu": 1,
                                       "gradient_clipping": 1e-3}))
    state = opt.init_shard(torch.zeros(g.numel()))
    stats = opt.apply(state, g)
    assert torch.equal(stats.grad_norm, exact)


@pytest.mark.parametrize("name", ["onebitlamb", "adagrad", "sgd", "lion",
                                  "onebitadam", "zerooneadam"])
def test_unported_optimizers_raise(name):
    """adagrad, sgd and lion are not ported; the 1-bit optimizers are, at
    ZeRO stages 0-1, and above it the config still raises naming them."""
    cfg = load_config({"train_micro_batch_size_per_gpu": 1,
                       "optimizer": {"type": name, "params": {}}})
    if name in ("onebitlamb", "onebitadam", "zerooneadam"):
        opt = build_optimizer(cfg)
        assert opt.lamb == (name == "onebitlamb")
        assert (opt.zero_one is not None) == (name == "zerooneadam")
        cfg = load_config({"train_micro_batch_size_per_gpu": 1,
                           "optimizer": {"type": name, "params": {}},
                           "zero_optimization": {"stage": 2}})
        with pytest.raises(NotImplementedError, match=name):
            cfg.check_ported()
        return
    with pytest.raises(NotImplementedError, match=name):
        build_optimizer(cfg)


def test_cpuadam_needs_offload():
    cfg = load_config({"train_micro_batch_size_per_gpu": 1,
                       "optimizer": {"type": "cpuadam"}})
    with pytest.raises(ValueError, match="offload"):
        build_optimizer(cfg)


# ---------------------------------------------------------------------------
# lr schedules and loss scaling
# ---------------------------------------------------------------------------

SCHEDULES = [
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4,
                     "lr_range_test_step_size": 30,
                     "lr_range_test_step_rate": 2.0}),
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4,
                     "lr_range_test_step_size": 30,
                     "lr_range_test_staircase": True}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-2,
                  "cycle_first_step_size": 50, "cycle_second_step_size": 70,
                  "decay_lr_rate": 0.5, "decay_step_size": 10}),
    ("WarmupLR", {"warmup_min_lr": 1e-5, "warmup_max_lr": 1e-3,
                  "warmup_num_steps": 60}),
    ("WarmupLR", {"warmup_max_lr": 1e-3, "warmup_num_steps": 60,
                  "warmup_type": "linear"}),
    ("WarmupDecayLR", {"total_num_steps": 180, "warmup_max_lr": 1e-3,
                       "warmup_num_steps": 40}),
    ("WarmupCosineLR", {"total_num_steps": 150, "warmup_max_lr": 1e-3,
                        "warmup_num_steps": 25, "cos_min_ratio": 0.1}),
]


@pytest.mark.parametrize("name,params", SCHEDULES)
def test_lr_schedule_matches_jax(name, params):
    # JAX evaluates the schedule in float32, the port in Python floats: a
    # few float32 roundings apart (observed up to 1.2e-6 relative)
    ours = lr_schedules.build_lr_schedule(name, params)
    theirs = jax_lr.build_lr_schedule(name, params)
    for step in range(200):
        np.testing.assert_allclose(ours.lr_at(step),
                                   float(theirs.lr_at(step)), rtol=1e-5,
                                   atol=1e-12)
        ours.step()
        theirs.step()
        np.testing.assert_allclose(ours.get_lr(), theirs.get_lr(),
                                   rtol=1e-5, atol=1e-12)
    if name == "OneCycle":
        for step in (0, 60, 130, 190):
            np.testing.assert_allclose(ours.mom_at(step),
                                       float(theirs.mom_at(step)), rtol=1e-5)
    assert ours.state_dict() == theirs.state_dict()


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown scheduler"):
        lr_schedules.build_lr_schedule("Cyclic", {})
    assert lr_schedules.as_schedule_fn(3e-4)(17) == 3e-4


OVERFLOWS = [False, True, True, False, False, False, False, False, True,
             False, True, True, True, False, False, False, False, False,
             False, False, True, False, False, False, False, False]


@pytest.mark.parametrize("consecutive", [False, True])
@pytest.mark.parametrize("hysteresis", [1, 2, 3])
def test_dynamic_loss_scaler_matches_jax(consecutive, hysteresis):
    kw = dict(init_scale=2.0 ** 8, scale_window=4, min_scale=4.0,
              delayed_shift=hysteresis, consecutive_hysteresis=consecutive)
    ours = loss_scaler.DynamicLossScaler(**kw)
    theirs = jax_scaler.DynamicLossScaler(**kw)
    s, js = ours.init("cpu"), theirs.init()
    for over in OVERFLOWS:
        s = ours.update(s, torch.tensor(over))
        js = theirs.update(js, jnp.asarray(over))
        assert float(s.scale) == float(js.scale)
        assert int(s.good_steps) == int(js.good_steps)
        assert int(s.hysteresis) == int(js.hysteresis)


def test_static_scaler_and_overflow_check():
    for fp16, dynamic in ((False, True), (True, False), (True, True)):
        kw = dict(fp16_enabled=fp16, dynamic=dynamic, static_scale=128.0,
                  initial_scale_power=12)
        ours = loss_scaler.create_loss_scaler(**kw)
        theirs = jax_scaler.create_loss_scaler(**kw)
        assert type(ours).__name__ == type(theirs).__name__
        assert float(ours.init().scale) == float(theirs.init().scale)
    assert not bool(has_overflow([torch.ones(3), torch.zeros(2)]))
    assert bool(has_overflow([torch.ones(3),
                              torch.tensor([1.0, float("inf")])]))
    assert bool(has_overflow([torch.tensor([float("nan")])]))


# ---------------------------------------------------------------------------
# config and data loading
# ---------------------------------------------------------------------------

BENCH = {"train_micro_batch_size_per_gpu": 4,
         "gradient_accumulation_steps": 1, "steps_per_print": 1000,
         "optimizer": {"type": "adamw", "params": {"lr": 1e-4}},
         "bf16": {"enabled": True}, "zero_optimization": {"stage": 2}}


def test_config_matches_jax(tmp_path):
    path = tmp_path / "ds.json"
    path.write_text(json.dumps(BENCH))
    for src in (BENCH, str(path)):
        ours, theirs = load_config(src), jax_load_config(src)
        assert ours.precision_dtype == theirs.precision_dtype == "bfloat16"
        assert ours.zero_stage == theirs.zero_stage == 2
        ours.check_ported()
    for triad in ((32, 4, 0), (32, 0, 2), (0, 4, 8), (16, 0, 0), (0, 2, 0),
                  (32, 4, 8)):
        cfg = dict(zip(("train_batch_size", "train_micro_batch_size_per_gpu",
                        "gradient_accumulation_steps"), triad))
        cfg = {k: v for k, v in cfg.items() if v}
        for dp in (1, 2):
            assert _triad(load_config(cfg), dp) == _triad(
                jax_load_config(cfg), dp)
    with pytest.raises(ConfigError):
        load_config({"train_batch_size": 30, "train_micro_batch_size_per_gpu":
                     4}).resolve_batch_sizes(1)


def _triad(cfg, dp):
    try:
        c = cfg.resolve_batch_sizes(dp)
    except ValueError as e:                  # ConfigError in both packages
        return type(e).__name__
    return (c.train_batch_size, c.train_micro_batch_size_per_gpu,
            c.gradient_accumulation_steps)


@pytest.mark.parametrize("cfg,key", [
    ({"trian_batch_size": 4}, "trian_batch_size"),
    ({"zero_optimization": {"stag": 1}}, "stag"),
    ({"bf16": {"enabled": True, "foo": 1}}, "foo"),
])
def test_unknown_keys_raise_naming_the_key(cfg, key):
    with pytest.raises(ConfigError, match=key):
        load_config(cfg)
    with pytest.raises(Exception, match=key):
        jax_load_config(cfg)


@pytest.mark.parametrize("extra,what", [
    ({"monitor": {"tensorboard": {"enabled": True}}}, "monitor"),
    ({"activation_checkpointing": {"partition_activations": True}},
     "activation_checkpointing"),
    ({"zero_optimization": {"stage": 2,
                            "offload_optimizer": {"device": "cpu"}},
      "optimizer": {"type": "lamb"}}, "offload_optimizer"),
    ({"zero_optimization": {"stage": 3, "offload_param": {"device": "nvme"}},
      "parallel": {"pipeline_parallel_size": 2}}, "offload_param"),
    ({"parallel": {"tensor_parallel_size": 2}}, "tensor_parallel_size"),
    ({"parallel": {"data_parallel_size": 2},
      "optimizer": {"type": "onebitlamb"},
      "zero_optimization": {"stage": 2}}, "onebitlamb' at ZeRO stage 2"),
])
def test_unported_config_raises(extra, what):
    cfg = load_config(dict(BENCH, **extra))
    jax_load_config(dict(BENCH, **extra))          # valid JAX config
    with pytest.raises(NotImplementedError, match=what):
        cfg.check_ported()


def test_fp16_and_bf16_together_raise():
    with pytest.raises(ConfigError):
        load_config({"fp16": {"enabled": True}, "bf16": {"enabled": True}})


def test_dataloader_matches_jax():
    data = [{"x": np.full(3, i, np.int32), "y": np.int64(i)}
            for i in range(23)]
    for shuffle, drop_last in ((True, True), (False, False), (True, False)):
        ours = DeepSpeedDataLoader(data, 4, shuffle=shuffle,
                                   drop_last=drop_last, seed=7)
        theirs = jax_dataloader.DeepSpeedDataLoader(
            data, 4, shuffle=shuffle, drop_last=drop_last, seed=7)
        assert len(ours) == len(theirs)
        for _ in range(2):                   # two epochs reshuffle alike
            for a, b in zip(ours, theirs, strict=True):
                np.testing.assert_array_equal(a["x"], b["x"])
                np.testing.assert_array_equal(a["y"], b["y"])
    rep = RepeatingLoader(DeepSpeedDataLoader(data, 10, shuffle=False))
    firsts = [int(next(rep)["y"][0]) for _ in range(5)]
    assert firsts == [0, 10, 0, 10, 0]
