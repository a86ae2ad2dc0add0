"""Optimizer-state offload on the CPU: host memory (tier 1) and NVMe swap
files (tier 2), at ZeRO stages 0-3 and worlds 1 and 2 over gloo.

* Tier 1 keeps the rank's master and moments as CPU tensors and updates
  them with ``host_adam_flat`` sub-group by sub-group: ``reference_adam_flat``'s
  operations into scratch allocated once, bit for bit the same over every
  option (``test_host_adam_equals_plain_adam``); on the CPU the resident path
  runs ``reference_adam_flat``, so masters, moments, params and
  losses equal the port's resident run bit for bit: ``tiny`` with AdamW at
  every stage and world, with gas 2 and clipping, in bf16 (a 16-bit master),
  and in fp16 with overflow skips at world 1. The resident AdamW losses are
  within rtol 1e-4 of the JAX engine's (its 8-way data axis).
* Tier 2 equals tier 1 bit for bit in the same cases (not fp16, which it
  refuses as JAX does); its host residency stays within three sub-groups,
  counted from the swapper's live buffers; its manifest and files are
  JAX's (format 2).
* Checkpoints: a tier-1 checkpoint loads into a resident engine and a
  resident one into tier 1, bit for bit; a tier-2 checkpoint (params in
  format 2 plus the ``nvme_state_p<rank>`` snapshot) restores bit for bit
  and the next step is equal; a JAX engine's NVMe checkpoint (``tiny``, a
  1-device mesh, 2 steps) loads into the port, and the next step agrees.
* ``cpuadam`` is accepted only with tier 1; LAMB and the 1-bit optimizers
  with offload raise.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models.presets import create_model as jax_create_model
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.models import create_model, params_to_numpy
from deepspeed_tpu_torch.models.core import tree_map
from deepspeed_tpu_torch.ops.fused_adam import reference_adam_flat
from deepspeed_tpu_torch.runtime.offload import (HostOptimizerState,
                                                 host_adam_flat)
from deepspeed_tpu_torch.runtime.swap import keystr
from torch_dist_workers import (GLOBAL_ROWS, SEQ, SUB_GROUP, offload_case,
                                offload_config, offload_runs, offload_state,
                                port_model, spawn, token_batches)

ADAMW = {"optimizer": {"type": "adamw",
                       "params": {"lr": 1e-3, "weight_decay": 0.01}},
         "steps_per_print": 1000}
TIERS = ("none", "cpu", "nvme")
CASES = {
    "adamw": dict(model="tiny", dtype="float32", gas=1, steps=3,
                  stages=(0, 1, 2, 3), worlds=(1, 2), tiers=TIERS,
                  config=dict(ADAMW, zero_optimization={
                      "stage3_param_persistence_threshold": 200})),
    "gas2_clip": dict(model="tiny", dtype="float32", gas=2, steps=3,
                      stages=(0, 2), worlds=(1, 2), tiers=TIERS,
                      config=dict(ADAMW, gradient_accumulation_steps=2,
                                  gradient_clipping=0.05)),
    "bf16": dict(model="tiny", dtype="bfloat16", gas=1, steps=3,
                 stages=(1, 3), worlds=(1, 2), tiers=TIERS,
                 config=dict(ADAMW, bf16={"enabled": True})),
    "fp16": dict(model="tiny", dtype="float16", gas=1, steps=8,
                 stages=(0, 1), worlds=(1,), tiers=("none", "cpu"),
                 config=dict(ADAMW, fp16={"enabled": True,
                                          "initial_scale_power": 32,
                                          "hysteresis": 1,
                                          "loss_scale_window": 4})),
}


def _jax_adamw():
    cfg = dict(CASES["adamw"]["config"], train_micro_batch_size_per_gpu=1)
    eng, *_ = deepspeed_tpu.initialize(
        model=jax_create_model("tiny", dtype=jnp.float32, max_seq_len=SEQ),
        config=cfg)
    init = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jax.device_get(eng.params))
    losses = [float(eng.train_batch(batch=jax.tree.map(jnp.asarray, b)))
              for b in token_batches(3, 1)]
    return init, losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    init, jax_losses = _jax_adamw()
    # the 16-bit cases start from the fp32 init cast to their dtype
    inits = {name: init for name in CASES}
    root = str(tmp_path_factory.mktemp("swap"))
    port = {}
    for name, case in CASES.items():
        for stage in case["stages"]:
            for tier in case["tiers"]:
                port[(1, name, stage, tier)] = offload_case(
                    case, inits[name], 1, stage, tier,
                    os.path.join(root, f"{name}-{stage}-1"))
    for rank, out in enumerate(spawn(offload_runs, 2, CASES, inits, root)):
        for key, val in out.items():
            port[(2, rank) + key] = val
    return {"port": port, "jax_losses": jax_losses, "init": init}


def _same(a, b):
    assert a["losses"] == b["losses"]
    assert a["scales"] == b["scales"] and a["skipped"] == b["skipped"]
    jax.tree.map(np.testing.assert_array_equal, a["params"], b["params"])
    for k in ("master", "exp_avg", "exp_avg_sq"):
        np.testing.assert_array_equal(a["state"][k], b["state"][k], err_msg=k)


def _cases(runs, tier):
    for name, case in CASES.items():
        if tier not in case["tiers"]:
            continue
        for world in case["worlds"]:
            for rank in range(world):
                for stage in case["stages"]:
                    key = ((1,) if world == 1 else (2, rank)) + (name, stage)
                    yield name, world, stage, runs["port"], key


@pytest.mark.parametrize("name", list(CASES))
def test_tier1_equals_resident_bit_for_bit(runs, name):
    for n, world, stage, port, key in _cases(runs, "cpu"):
        if n != name:
            continue
        got, ref = port[key + ("cpu",)], port[key + ("none",)]
        _same(got, ref)
        assert got["state_device"] == "cpu"
    if name == "fp16":
        assert runs["port"][(1, "fp16", 0, "cpu")]["skipped"] > 0


def test_resident_adamw_matches_jax(runs):
    for world, key in ((1, (1,)), (2, (2, 0))):
        for stage in CASES["adamw"]["stages"]:
            got = runs["port"][key + ("adamw", stage, "cpu")]
            np.testing.assert_allclose(got["losses"], runs["jax_losses"],
                                       rtol=1e-4, err_msg=f"world {world}")


@pytest.mark.parametrize("name", ["adamw", "gas2_clip", "bf16"])
def test_tier2_equals_tier1_bit_for_bit(runs, name):
    for n, world, stage, port, key in _cases(runs, "nvme"):
        if n != name:
            continue
        got = port[key + ("nvme",)]
        _same(got, port[key + ("cpu",)])
        assert got["state_device"] is None
        # three buffer sets: the group being read, updated and written
        assert got["groups"] > 3 and got["sets"] == 3
        assert got["peak_live_groups"] == 3


# ---------------------------------------------------------------------------
# the refusals
# ---------------------------------------------------------------------------

def test_cpuadam_only_with_tier1(tmp_path):
    model = create_model("tiny", dtype=torch.float32)
    base = {"train_micro_batch_size_per_gpu": 2,
            "optimizer": {"type": "cpuadam", "params": {"lr": 1e-3}}}
    for zero in ({}, {"offload_optimizer": {"device": "nvme",
                                            "nvme_path": str(tmp_path)}}):
        with pytest.raises(ValueError, match="cpuadam"):
            initialize(model=model, config=dict(base, zero_optimization=zero),
                       device="cpu")
    eng = initialize(model=model, config=dict(base, zero_optimization={
        "offload_optimizer": {"device": "cpu"}}), device="cpu")[0]
    assert eng.opt_state.master.device.type == "cpu"
    assert eng.optimizer.adam_w_mode


@pytest.mark.parametrize("opt", ["lamb", "onebitadam", "zerooneadam"])
def test_offload_beside_lamb_or_onebit_raises(opt):
    model = create_model("tiny", dtype=torch.float32)
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "optimizer": {"type": opt, "params": {"lr": 1e-3}},
           "zero_optimization": {"offload_optimizer": {"device": "cpu"}}}
    with pytest.raises(NotImplementedError,
                       match=f"offload_optimizer with optimizer '{opt}'"):
        initialize(model=model, config=cfg, device="cpu")


def test_nvme_fp16_refused(tmp_path):
    model = create_model("tiny", dtype=torch.float16)
    cfg = {"train_micro_batch_size_per_gpu": 2, "fp16": {"enabled": True},
           "zero_optimization": {"offload_optimizer": {
               "device": "nvme", "nvme_path": str(tmp_path)}}}
    with pytest.raises(NotImplementedError, match="'nvme' with fp16"):
        initialize(model=model, config=cfg, device="cpu")


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _engine(tier, swap, stage=1):
    case = CASES["bf16"]
    g = torch.Generator()
    g.manual_seed(0)
    init = tree_map(lambda t: t.numpy(), create_model(
        "tiny", dtype=torch.float32, max_seq_len=SEQ).init(g))
    return initialize(model=port_model(case, init),
                      config=offload_config(case, 1, stage, tier, swap),
                      device="cpu")[0]


def _state_and_counts(eng):
    return (offload_state(eng), eng.opt_state.count,
            eng.opt_state.inner_count, eng.global_steps,
            tree_map(np.copy, params_to_numpy(eng.params)))


def _equal_states(a, b):
    for k in a[0]:
        np.testing.assert_array_equal(a[0][k], b[0][k], err_msg=k)
    assert a[1:4] == b[1:4]
    jax.tree.map(np.testing.assert_array_equal, a[4], b[4])


@pytest.mark.parametrize("src,dst", [("cpu", "none"), ("none", "cpu")])
def test_tier1_and_resident_checkpoints_cross_load(tmp_path, src, dst):
    batches = token_batches(3, 1, seed=4)
    a = _engine(src, str(tmp_path / "a"))
    for b in batches[:2]:
        a.train_batch(batch=b)
    a.save_checkpoint(str(tmp_path / "ckpt"), tag="step2")
    b = _engine(dst, str(tmp_path / "b"), stage=3)
    b.load_checkpoint(str(tmp_path / "ckpt"))
    _equal_states(_state_and_counts(a), _state_and_counts(b))
    assert float(a.train_batch(batch=batches[2])) == float(
        b.train_batch(batch=batches[2]))


def test_nvme_checkpoint_restores_bit_for_bit(tmp_path):
    batches = token_batches(3, 1, seed=4)
    a = _engine("nvme", str(tmp_path / "a"))
    for b in batches[:2]:
        a.train_batch(batch=b)
    path = a.save_checkpoint(str(tmp_path / "ckpt"), tag="step2")
    snap = os.path.join(path, "nvme_state_p0")
    with open(os.path.join(snap, "manifest.json")) as fh:
        manifest = json.load(fh)
    assert manifest["format"] == 2 and manifest["step"] == 2
    with open(os.path.join(path, "metadata.json")) as fh:
        keys = json.load(fh)["arrays"]
    assert keys and all(k.startswith("params##") for k in keys)
    b = _engine("nvme", str(tmp_path / "b"))
    b.load_checkpoint(str(tmp_path / "ckpt"))
    _equal_states(_state_and_counts(a), _state_and_counts(b))
    la, lb = (float(e.train_batch(batch=batches[2])) for e in (a, b))
    assert la == lb
    _equal_states(_state_and_counts(a), _state_and_counts(b))
    c = _engine("nvme", str(tmp_path / "c"))
    os.rename(snap, snap + ".gone")
    with pytest.raises(RuntimeError, match="nvme_state_p0"):
        c.load_checkpoint(str(tmp_path / "ckpt"))


def test_jax_nvme_snapshot_loads_into_the_port(tmp_path):
    """JAX ``tiny`` (fp32, AdamW, a 1-device mesh) under its NVMe tier, two
    steps, saved; the port's tier 2 at world 1 loads it: the manifests'
    layouts agree, params and state arrive bit for bit, and the next step's
    loss and params agree with JAX's next step."""
    cfg = offload_config(CASES["adamw"], 1, 1, "nvme", str(tmp_path / "j"))
    cfg["train_micro_batch_size_per_gpu"] = GLOBAL_ROWS
    jeng, *_ = deepspeed_tpu.initialize(
        model=jax_create_model("tiny", dtype=jnp.float32, max_seq_len=SEQ),
        config=cfg, mesh=build_mesh(devices=jax.devices()[:1]))
    init = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jax.device_get(jeng.params))
    batches = token_batches(3, 1, seed=6)
    for b in batches[:2]:
        jeng.train_batch(batch=jax.tree.map(jnp.asarray, b))
    jeng.save_checkpoint(str(tmp_path / "ckpt"), tag="step2")
    peng = initialize(model=port_model(CASES["adamw"], init),
                      config=offload_config(CASES["adamw"], 1, 1, "nvme",
                                            str(tmp_path / "p")),
                      device="cpu")[0]
    peng.load_checkpoint(str(tmp_path / "ckpt"))
    assert peng.global_steps == peng.opt_state.count == 2
    jax.tree.map(np.testing.assert_array_equal,
                 params_to_numpy(peng.params), jax.device_get(jeng.params))
    sw = peng.opt_state.offload
    state = sw.read_state(peng.opt_state.n)
    arrays = jeng._nvme_swapper.state_arrays()
    for (kind, flat) in state.items():
        for path, plist in peng.partition.leaf_pieces().items():
            pc = plist[0][1]
            np.testing.assert_array_equal(
                flat[pc.offset:pc.offset + pc.numel].numpy(),
                arrays[kind][keystr(path)].reshape(-1), err_msg=kind)
    lj = float(jeng.train_batch(batch=jax.tree.map(jnp.asarray,
                                                   batches[2])))
    lp = float(peng.train_batch(batch=batches[2]))
    np.testing.assert_allclose(lp, lj, rtol=1e-5)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, atol=1e-5),
                 params_to_numpy(peng.params), jax.device_get(jeng.params))
    sw.close(remove=True)


@pytest.mark.parametrize("tier", ["cpu", "nvme"])
def test_full_state_accessors_read_the_tiers(tmp_path, tier):
    """``safe_get_full_fp32_param`` / ``safe_get_full_optimizer_state``
    read the host tier's CPU tensors and the NVMe tier's files, and give
    the resident engine's leaves."""
    from deepspeed_tpu_torch.utils import tensor_fragment as tf

    batches = token_batches(2, 1, seed=4)
    engines = {t: _engine(t, str(tmp_path / t)) for t in ("none", tier)}
    for eng in engines.values():
        for b in batches:
            eng.train_batch(batch=b)
    for path in ("layers/attn/wq", "embed/tokens"):
        for fn, args in ((tf.safe_get_full_fp32_param, ()),
                         (tf.safe_get_full_optimizer_state, ("exp_avg",)),
                         (tf.safe_get_full_optimizer_state, ("nu",))):
            np.testing.assert_array_equal(fn(engines[tier], path, *args),
                                          fn(engines["none"], path, *args))


@pytest.mark.parametrize("gdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("opts", [
    dict(), dict(weight_decay=0.01), dict(weight_decay=0.01,
                                          adam_w_mode=False),
    dict(bias_correction=False, weight_decay=0.01),
    dict(scaled=True, copy=True), dict(scaled=True, weight_decay=0.01,
                                       adam_w_mode=False, copy=True)],
    ids=["plain", "adamw", "l2", "no_bias_correction", "scaled_copy",
         "l2_scaled_copy"])
def test_host_adam_equals_plain_adam(gdt, opts):
    """The host tiers' in-place Adam gives ``reference_adam_flat``'s bits
    on every buffer, over a piece shorter than its scratch rows, for
    three steps from moments spanning many magnitudes."""
    opts = dict(opts)
    scaled, copy = opts.pop("scaled", False), opts.pop("copy", False)
    rng = np.random.default_rng(7)
    n = 1003
    p = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    m = torch.from_numpy(1e-3 * rng.standard_normal(n).astype(np.float32))
    v = torch.from_numpy((10.0 ** rng.uniform(-12, 0, n)).astype(np.float32))
    host = [x.clone() for x in (p, m, v)]
    plain = [x.clone() for x in (p, m, v)]
    copies = [torch.empty(n, dtype=torch.bfloat16) if copy else None
              for _ in range(2)]
    scratch = torch.full((3, n + 29), float("nan"))
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, **opts)
    for step in (1, 2, 3):
        g = torch.from_numpy(
            rng.standard_normal(n).astype(np.float32)).to(gdt)
        scale = torch.tensor([0.37]) if scaled else None
        host_adam_flat(host[0], g, host[1], host[2], step, scratch,
                       param_copy=copies[0], grad_scale=scale, **kw)
        reference_adam_flat(plain[0], g, plain[1], plain[2], step,
                            param_copy=copies[1], grad_scale=scale, **kw)
        for a, b in zip(host + copies[:1], plain + copies[1:]):
            if a is not None:
                assert torch.equal(a, b)


def test_host_tier_scratch_allocated_once():
    """The pipeline's update scratch is three rows of the largest piece,
    allocated at the first step and reused by every later one."""
    shard = torch.randn(1000)
    tier = HostOptimizerState(shard, 300)
    seen = []

    def update(master, g, m, v, copy, scratch):
        seen.append((scratch.shape, scratch.data_ptr()))
        host_adam_flat(master, g, m, v, 1, scratch, param_copy=copy)

    for _ in range(2):
        tier.step(shard, torch.randn(1000), update)
    assert len(seen) == 8 and len(set(seen)) == 1
    assert seen[0][0] == (3, 300)
