"""MoE training under parameter and optimizer offload, with LAMB and with
the 1-bit optimizers, on the CPU (``moe-tiny``, fp32).

* Parameter offload (``runtime/param_offload.py``, world 1), 3 layers:
  against JAX's ``offload_param`` engine on a 1-device mesh (one layer a
  block), cpu and nvme tiers, blocks of one layer and of two (a remainder
  block of one): losses and final params within rtol 2e-4 / atol 2e-5
  (JAX's own bar, ``tests/unit/test_param_offload.py``); bit for bit
  against the port's resident stage-3 engine on the fused path (gas 1, no
  clip), the deferred path (gas 2, a clip that clips) and in eval; with
  Random Token Selection on (top-1, capacity factor 0.5, no generator),
  where each block's recompute routes every layer exactly as its forward
  did and the plan log counts each layer once a step; an aux-off run
  differs from the aux-on one (JAX pins it so); PR-MoE's streamed init
  (router, residual MLP and coefficient, banks) equals the resident draws
  with the nvme block files in JAX's leaf order; a checkpoint has JAX's
  offload keys and shapes, and JAX's checkpoint loads and resumes.
* Optimizer-state offload (host memory, NVMe), ZeRO stages 0-3: masters,
  moments, params and losses equal the resident MoE engine's bit for bit
  at world 1 and at world 2 over gloo with ep 1 and ep 2 (where a rank's
  shard has a dense and a bank unit: no host sub-group straddles the two,
  and the NVMe manifest's bank regions sit at the rank's banks).
* LAMB at world 2 ep 2, stages 0 and 2, against JAX's LAMB engine with
  experts over an expert axis of 2: losses rtol 1e-4, params atol 1e-4 (the
  trust ratio of a bank leaf is the whole leaf's: at stage 0 its sums are
  added over the expert-parallel group, at stage 2 over the world, where
  each element counts once).
* The 1-bit optimizers at world 2 ep 1 against JAX's engines on 2 devices
  (``tests/test_torch_onebit.py``'s bar).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.config.config import ParallelConfig
from deepspeed_tpu.models.presets import create_model as jax_create_model
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.models import Model, create_model, params_from_jax
from deepspeed_tpu_torch.models.core import tree_items
from deepspeed_tpu_torch.parallel import moe as pmoe
from deepspeed_tpu_torch.utils import tensor_fragment as tf
from torch_dist_workers import (GLOBAL_ROWS, SEQ, offload_case, offload_runs,
                                spawn, token_batches)

LAYERS = 3
STEPS = 3
ADAMW = {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.01}}
JAX_TOL = dict(rtol=2e-4, atol=2e-5)
RTS = dict(moe_top_k=1, moe_use_rts=True, moe_capacity_factor=0.5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tiny models take thousands of small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# parameter offload
# ---------------------------------------------------------------------------

def config(tier=None, swap="", layers_per_block=1, gas=1, **extra):
    zero = {"stage": 3}
    if tier is not None:
        zero["offload_param"] = {"device": tier, "nvme_path": swap,
                                 "buffer_size": block_bytes(
                                     layers_per_block)}
    cfg = {"train_micro_batch_size_per_gpu": GLOBAL_ROWS,
           "gradient_accumulation_steps": gas, "steps_per_print": 1000,
           "optimizer": ADAMW, "zero_optimization": zero}
    cfg.update(extra)
    return cfg


def block_bytes(layers, **over):
    tree = create_model("moe-tiny", num_layers=1, **over).init(
        torch.Generator(), device="meta")
    return layers * sum(t.numel() * 4 for _, t in tree_items(tree["layers"]))


def port_engine(init, cfg, **over):
    model = create_model("moe-tiny", dtype=torch.float32, max_seq_len=SEQ,
                         num_layers=LAYERS, **over)
    mdl = Model(init=lambda g: params_from_jax(init, model.config,
                                               device=g.device),
                config=model.config, name="moe-tiny", loss_fn=model.loss_fn,
                eval_loss_fn=model.eval_loss_fn)
    return initialize(model=mdl, config=cfg, device="cpu")[0]


def train(eng, batches):
    return [float(eng.train_batch(batch=b)) for b in batches]


def state(eng):
    """Every leaf's param, fp32 master and moments, and the counters."""
    out = {}
    for p in ["/".join(p) for p, _ in tree_items(eng.params)]:
        out[p] = (tf.safe_get_full_param(eng, p),
                  tf.safe_get_full_fp32_param(eng, p),
                  tf.safe_get_full_optimizer_state(eng, p, "exp_avg"),
                  tf.safe_get_full_optimizer_state(eng, p, "exp_avg_sq"))
    return out, (eng.global_steps, eng.skipped_steps, eng.cur_scale)


def assert_same(a, b):
    assert a[1] == b[1]
    assert a[0].keys() == b[0].keys()
    for p in a[0]:
        for x, y in zip(a[0][p], b[0][p]):
            np.testing.assert_array_equal(x, y, err_msg=p)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's offload engine (one layer a block, a 1-device mesh): the init,
    the losses and final params of STEPS steps, and a checkpoint after
    2."""
    ckpt = str(tmp_path_factory.mktemp("jax_moe_ckpt"))
    cfg = dict(config(), zero_optimization={
        "stage": 3, "offload_param": {"device": "cpu", "buffer_size": 1}})
    eng = deepspeed_tpu.initialize(
        model=jax_create_model("moe-tiny", dtype=jnp.float32,
                               max_seq_len=SEQ, num_layers=LAYERS),
        config=cfg, mesh=build_mesh(devices=jax.devices()[:1]))[0]

    def params():
        return jax.tree.map(lambda a: np.array(a, np.float32),
                            jax.device_get(
                                eng._param_offload.params_for_checkpoint()))

    init = params()
    losses = []
    for i, b in enumerate(token_batches(STEPS, 1, seed=1)):
        losses.append(float(eng.train_batch(batch=jax.tree.map(jnp.asarray,
                                                               b))))
        if i == 1:
            eng.save_checkpoint(ckpt, tag="step2")
    return dict(init=init, losses=losses, params=params(), ckpt=ckpt)


@pytest.mark.parametrize("layers_per_block", [1, 2])
@pytest.mark.parametrize("tier", ["cpu", "nvme"])
def test_param_offload_matches_jax_and_equals_resident(
        jax_run, tmp_path, tier, layers_per_block):
    batches = token_batches(STEPS, 1, seed=1)
    eng = port_engine(jax_run["init"], config(
        tier, str(tmp_path), layers_per_block))
    ex = eng._param_offload
    assert ex.num_blocks == -(-LAYERS // layers_per_block)
    assert ex.aux_coef > 0
    losses = train(eng, batches)
    np.testing.assert_allclose(losses, jax_run["losses"], **JAX_TOL)
    got = dict(tree_items(eng.params))
    for path, want in tree_items(jax_run["params"]):
        np.testing.assert_allclose(got[path].numpy(), want, **JAX_TOL,
                                   err_msg="/".join(path))
    res = port_engine(jax_run["init"], config())
    assert train(res, batches) == losses
    assert_same(state(eng), state(res))


def test_param_offload_deferred_path_and_eval_equal_resident(jax_run):
    init = jax_run["init"]
    extra = dict(gas=2, gradient_clipping=0.05)
    off = port_engine(init, config("cpu", **extra))
    res = port_engine(init, config(**extra))
    assert off._param_offload.fused is False
    batches = token_batches(STEPS, 2, seed=3)
    assert train(off, batches) == train(res, batches)
    assert_same(state(off), state(res))
    assert off._param_offload.last_step_stats["grad_norm"] > 0.05
    mb = {"input_ids": token_batches(1, 1, seed=9)[0]["input_ids"][0]}
    assert float(off.eval_loss(mb)) == float(res.eval_loss(mb))


class PlanSpy:
    """Records each top-1 plan's logits and kept assignments, in order."""

    def __init__(self, monkeypatch):
        self.seen = []
        real = pmoe.top1_plan

        def spy(logits, *a, **kw):
            plan = real(logits, *a, **kw)
            self.seen.append((logits.detach().clone(), plan.valid.clone()))
            return plan

        monkeypatch.setattr(pmoe, "top1_plan", spy)


def test_rts_recompute_routes_as_the_forward(jax_run, monkeypatch):
    """RTS with no generator: the resident stage-3 engine and parameter
    offload (one layer a block) train bit for bit alike; in each offload
    step the recompute of layer i has the forward's logits and keep-set,
    which drops tokens; the plan log holds one entry a layer a step."""
    init = jax_run["init"]
    batches = token_batches(2, 1, seed=4)
    res = port_engine(init, config(), **RTS)
    want = train(res, batches)
    off = port_engine(init, config("cpu"), **RTS)
    spy = PlanSpy(monkeypatch)
    pmoe.PLAN_LOG = []
    try:
        got = train(off, batches)
        log = pmoe.PLAN_LOG
    finally:
        pmoe.PLAN_LOG = None
    assert got == want
    assert_same(state(off), state(res))
    assert len(log) == LAYERS * len(batches)
    assert len(spy.seen) == 2 * LAYERS * len(batches)
    for s in range(len(batches)):
        step = spy.seen[2 * LAYERS * s:2 * LAYERS * (s + 1)]
        fwd, rec = step[:LAYERS], step[LAYERS:][::-1]
        for (lf, vf), (lr, vr) in zip(fwd, rec):
            assert torch.equal(lf, lr) and torch.equal(vf, vr)
            assert not bool(vf.all())
    # another input draws another keep-set in the same layer
    assert not torch.equal(spy.seen[0][1], spy.seen[2 * LAYERS][1])


def test_aux_off_run_differs(jax_run):
    """The aux term is in the loss: a run with ``moe_aux_loss_coef`` 0
    differs from the first step on (JAX's test pins it this way)."""
    batches = token_batches(1, 1, seed=1)
    on = train(port_engine(jax_run["init"], config("cpu")), batches)
    off = train(port_engine(jax_run["init"], config("cpu"),
                            moe_aux_loss_coef=0.0), batches)
    assert abs(on[0] - off[0]) > 1e-6


@pytest.mark.parametrize("tier", ["cpu", "nvme"])
def test_pr_moe_streamed_init_in_jax_leaf_order(tmp_path, tier):
    """PR-MoE (the residual MLP and its coefficient beside the banks): the
    streamed init equals the resident engine's draws bit for bit, and on
    the nvme tier each block file holds the block's leaves back to back in
    JAX's leaf order (sorted paths: attn, ln1, ln2, mlp, res_coef, res_mlp,
    router)."""
    over = dict(moe_use_residual=True)
    model = create_model("moe-tiny", dtype=torch.float32, max_seq_len=SEQ,
                         num_layers=LAYERS, **over)
    cfg = dict(config(), zero_optimization={
        "stage": 3, "offload_param": {
            "device": tier, "nvme_path": str(tmp_path),
            "buffer_size": block_bytes(2, **over)}})
    off = initialize(model=model, config=cfg, device="cpu")[0]
    res = initialize(model=model, config=config(), device="cpu")[0]
    assert_same(state(off), state(res))
    ex = off._param_offload
    names = ["/".join(p) for p in ex.layer_paths]
    assert names == sorted(names)
    assert {"router", "res_coef/w", "res_mlp/w_up", "mlp/w_up"} <= set(names)
    whole = dict(tree_items(res.params))
    for g, (lo, hi) in enumerate(ex.bounds):
        want = torch.cat([whole[("layers",) + p][lo:hi].reshape(-1)
                          for p in ex.layer_paths])
        got = ex.block_params(g)
        if tier == "nvme":
            raw = np.fromfile(ex.store.file(g), np.float32)
            got = torch.from_numpy(raw)
        assert torch.equal(got, want)
    batches = token_batches(1, 1, seed=12)
    assert train(off, batches) == train(res, batches)


def test_checkpoints_in_jax_offload_layout(jax_run, tmp_path):
    """The port's offload checkpoint has JAX's keys and shapes (each stack
    leaf's ``opt##layer_master##<i>`` in JAX's order); JAX's loads into the
    port and its third step agrees with JAX's; the port's resumes bit for
    bit."""
    init = jax_run["init"]
    batches = token_batches(STEPS, 1, seed=1)
    a = port_engine(init, config("cpu"))
    train(a, batches[:2])
    a.save_checkpoint(str(tmp_path / "port"), tag="step2")
    meta = json.loads((tmp_path / "port" / "step2" / "metadata.json"
                       ).read_text())
    jmeta = json.loads(open(os.path.join(jax_run["ckpt"], "step2",
                                         "metadata.json")).read())
    shapes = lambda m: {k: v["shape"] for k, v in m["arrays"].items()}  # noqa
    assert shapes(meta) == shapes(jmeta)
    # JAX pairs opt##layer_master##<i> with the i-th stack leaf in this
    # order (``consolidate_checkpoint`` too)
    stack = lambda m: [k for k in m["arrays"]  # noqa: E731
                       if k.startswith("params##layers##")]
    assert stack(meta) == stack(jmeta)
    assert any(k.endswith("router") for k in meta["arrays"])
    b = port_engine(init, config("cpu"))
    b.load_checkpoint(str(tmp_path / "port"))
    assert_same(state(a), state(b))
    assert train(a, batches[2:]) == train(b, batches[2:])
    c = port_engine(init, config("cpu"))
    c.load_checkpoint(jax_run["ckpt"])
    assert c.global_steps == 2 and c._param_offload.step_count == 2
    np.testing.assert_allclose(train(c, batches[2:]), jax_run["losses"][2:],
                               **JAX_TOL)


# ---------------------------------------------------------------------------
# optimizer offload, LAMB and the 1-bit optimizers (one spawn at world 2)
# ---------------------------------------------------------------------------

BASE = {"steps_per_print": 1000}
OFFLOAD_STAGES = (0, 1, 2, 3)
TIERS = ("none", "cpu", "nvme")
LAMB = {"type": "lamb", "params": {"lr": 2e-3, "weight_decay": 0.01}}
ONEBIT = ("onebitadam", "onebitlamb", "zerooneadam")
ONEBIT_STEPS = 5


def _onebit_opt(name):
    params = {"lr": 2e-3, "weight_decay": 0.01, "freeze_step": 2}
    if name == "zerooneadam":
        params["var_update_scaler"] = 2
    return {"type": name, "params": params}


def _moe(worlds, stages, tiers, steps=STEPS, ep=1, **cfg):
    return dict(model="moe-tiny", dtype="float32", gas=1, steps=steps,
                worlds=worlds, stages=stages, tiers=tiers,
                config=dict(BASE, parallel={"expert_parallel_size": ep},
                            zero_optimization={
                                "stage3_param_persistence_threshold": 200},
                            **cfg))


CASES = {
    "ep1": _moe((1, 2), OFFLOAD_STAGES, TIERS, optimizer=ADAMW),
    "ep2": _moe((2,), OFFLOAD_STAGES, TIERS, ep=2, optimizer=ADAMW),
    "lamb": _moe((2,), (0, 2), ("none",), ep=2, optimizer=LAMB),
    **{name: _moe((2,), (0,), ("none",), steps=ONEBIT_STEPS,
                  optimizer=_onebit_opt(name)) for name in ONEBIT},
}


def _jax_engine(name, world, ep):
    case = CASES[name]
    cfg = dict(case["config"], train_micro_batch_size_per_gpu=(
        GLOBAL_ROWS // world), zero_optimization={"stage": 0},
        parallel={"expert_parallel_size": ep})
    mesh = build_mesh(ParallelConfig(data_parallel_size=world,
                                     expert_parallel_size=ep),
                      devices=jax.devices()[:world])
    eng, *_ = deepspeed_tpu.initialize(
        model=jax_create_model("moe-tiny", dtype=jnp.float32,
                               max_seq_len=SEQ), config=cfg, mesh=mesh)
    init = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jax.device_get(eng.params))
    losses = [float(eng.train_batch(batch=jax.tree.map(jnp.asarray, b)))
              for b in token_batches(case["steps"], 1)]
    return init, {"losses": losses, "params": jax.tree.map(
        lambda a: np.asarray(a, np.float32), jax.device_get(eng.params))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax_out = {}
    init, jax_out["lamb"] = _jax_engine("lamb", 8, 2)
    for name in ONEBIT:
        _, jax_out[name] = _jax_engine(name, 2, 1)
    root = str(tmp_path_factory.mktemp("moe_swap"))
    inits = {name: init for name in CASES}
    port = {}
    for stage in OFFLOAD_STAGES:
        for tier in TIERS:
            port[(1, 0, "ep1", stage, tier)] = offload_case(
                CASES["ep1"], init, 1, stage, tier,
                os.path.join(root, f"ep1-{stage}-1"))
    for rank, out in enumerate(spawn(offload_runs, 2, CASES, inits, root,
                                     timeout=400)):
        for key, val in out.items():
            port[(2, rank) + key] = val
    return {"jax": jax_out, "port": port, "init": init}


def _same(a, b):
    assert a["losses"] == b["losses"]
    jax.tree.map(np.testing.assert_array_equal, a["params"], b["params"])
    for k in ("master", "exp_avg", "exp_avg_sq"):
        np.testing.assert_array_equal(a["state"][k], b["state"][k], err_msg=k)


OFFLOAD_RUNS = [(1, "ep1"), (2, "ep1"), (2, "ep2")]


@pytest.mark.parametrize("tier", ["cpu", "nvme"])
@pytest.mark.parametrize("stage", OFFLOAD_STAGES)
@pytest.mark.parametrize("world,name", OFFLOAD_RUNS,
                         ids=[f"w{w}-{n}" for w, n in OFFLOAD_RUNS])
def test_optimizer_offload_equals_resident(runs, world, name, stage, tier):
    port = runs["port"]
    for rank in range(world):
        got = port[(world, rank, name, stage, tier)]
        _same(got, port[(world, rank, name, stage, "none")])
        assert got["losses"][-1] < got["losses"][0]
        if tier == "cpu":
            assert got["state_device"] == "cpu"


@pytest.mark.parametrize("stage", OFFLOAD_STAGES)
def test_offload_follows_the_two_units_at_ep2(runs, stage):
    """At ep 2 a rank's shard holds a dense unit, then its banks (stage 3:
    a layer's dense and bank units in turn): no host sub-group straddles
    two units, and the NVMe manifest's bank regions are boxes of the whole
    (L, E, ...) leaf at the rank's banks (experts [4 r, 4 r + 4) of 8),
    each rank's once."""
    covered = {}
    for rank in range(2):
        cpu = runs["port"][(2, rank, "ep2", stage, "cpu")]
        bounds = cpu["shard_offsets"][1:]
        assert bounds
        for (pos, n), in cpu["group_spans"]:
            assert not any(pos < b < pos + n for b in bounds), (pos, n)
        man = runs["port"][(2, rank, "ep2", stage, "nvme")]["manifest"]
        assert man["format"] == 2
        for group in man["groups"]:
            for key, region, shape, n in group:
                if "['mlp']" not in key:
                    continue
                lo, hi = region[1]
                assert 4 * rank <= lo < hi <= 4 * rank + 4, (key, region)
                covered[key] = covered.get(key, 0) + n
    for path, leaf in tree_items(runs["init"]):
        if path[:2] == ("layers", "mlp"):
            assert covered["".join(f"[{k!r}]" for k in path)] == leaf.size


@pytest.mark.parametrize("stage", [0, 2])
def test_lamb_at_ep2_matches_jax(runs, stage):
    want = runs["jax"]["lamb"]
    for rank in range(2):
        got = runs["port"][(2, rank, "lamb", stage, "none")]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
        for path, leaf in tree_items(want["params"]):
            node = got["params"]
            for k in path:
                node = node[k]
            np.testing.assert_allclose(node, leaf, atol=1e-4,
                                       err_msg=str(path))
    a, b = (runs["port"][(2, 0, "lamb", st, "none")] for st in (0, 2))
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-5)


@pytest.mark.parametrize("name", ONEBIT)
def test_onebit_at_ep1_matches_jax(runs, name):
    """As ``tests/test_torch_onebit.py``: losses rtol 1e-4; params within
    1e-4 but where a code took its neighbour (rare; at most lr a
    compressed step for the Adam-normalised updates). 0/1 Adam's variance
    is frozen between its schedule's steps, so where a bank's grads grew
    after them its step m / sqrt(v) exceeds 1 and such an element moves by
    more than lr: for it only the share of far elements is held."""
    want = runs["jax"][name]
    lr = CASES[name]["config"]["optimizer"]["params"]["lr"]
    for rank in range(2):
        got = runs["port"][(2, rank, name, 0, "none")]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
        far = total = 0
        for a, b in zip(jax.tree.leaves(got["params"]),
                        jax.tree.leaves(want["params"])):
            diff = np.abs(a - b)
            if name != "zerooneadam":
                assert diff.max() <= lr * (ONEBIT_STEPS - 2), name
            far += int((diff > 1e-4).sum())
            total += diff.size
        assert far <= 1e-3 * total, (name, far, total)
