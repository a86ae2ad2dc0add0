"""MoE beyond one rank: global gating and expert parallelism, on the CPU at
worlds 2 and 4 over gloo, against the JAX engine on its 8-device mesh.

* The rank layout (``parallel/topology.py``) against the device order of
  JAX's ``build_mesh``: a rank's (expert, data) place, its banks and both
  groups, at (world, ep) in (2, 2), (4, 2), (4, 4), (8, 2), (8, 8); the
  ``ValueError``s for a degree that does not divide.
* The global plan: each rank given its rows of (world * T, E) logits gets
  JAX's ``top1_plan`` / ``top2_plan`` over all of them for its rows (the
  experts, queue slots, kept assignments, capacity and counts bit for bit,
  the weights and the aux loss within ``GATE_ULPS``; bit for bit against the
  port's plan in one process), and the aux loss's grad summed back to its
  rows (every rank's copy: world times the one-process grad). ``local_slots`` packs a rank's kept assignments below min(C, T).
* Training ``moe-tiny`` (fp32, AdamW with weight decay, 3 steps) at world 2
  ep 1, world 2 ep 2, world 4 ep 2 and world 4 ep 4 at ZeRO stages 0-2,
  world 2 ep 1 at stage 3, top-1, the einsum dispatch, gradient clipping
  and gas 2, each against JAX's engine fed the same global batches from the
  same init (JAX at ep 2: experts over ``expert``, four ``data`` ranks
  each): losses rtol 1e-4 (JAX's own tolerance,
  ``tests/unit/test_moe_tp_sp.py``), final params atol 1e-4. A rank at ep >
  1 holds only its E / ep banks and their optimizer state.
* The eval loss at ep 2 (each rank its rows) equals the whole batch's at
  world 1.
* Checkpoints: saved at world 2 ep 2, loaded at world 1 and at world 4 ep
  4; saved at world 1 and at world 4 ep 4, loaded at world 2 ep 2. The
  loaded params equal the saved ones bit for bit and the next step agrees.

Each world is one spawn (``torch_dist_workers.moe_ep_runs``) that runs every
case, plus a short second world-2 spawn that loads the world-4 checkpoint.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.config.config import ParallelConfig
from deepspeed_tpu.models.presets import create_model as jax_create_model
from deepspeed_tpu.parallel import moe as jmoe
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu_torch import comm, initialize
from deepspeed_tpu_torch.models import create_model
from deepspeed_tpu_torch.models.core import tree_items
from deepspeed_tpu_torch.parallel import moe as pmoe
from deepspeed_tpu_torch.parallel.topology import Topology
from torch_dist_workers import (GLOBAL_ROWS, SEQ, case_config,
                                checkpoint_case, moe_ep_runs, moe_eval,
                                spawn, token_batches, train_case)

GATE_ULPS = 4
STEPS = 3
CONFIG = {"optimizer": {"type": "adamw",
                        "params": {"lr": 1e-3, "weight_decay": 0.01}},
          "steps_per_print": 1000}
# the model's overrides, the config's additions and gas of each variant
VARIANTS = {
    "top2": ({}, {}, 1),
    "top1": ({"moe_top_k": 1}, {}, 1),
    "einsum": ({"moe_dispatch": "einsum"}, {}, 1),
    "clip": ({}, {"gradient_clipping": 0.05}, 1),
    "gas2": ({}, {"gradient_accumulation_steps": 2}, 2),
}
# (world, ep, variant, stages)
RUNS = [(2, 1, "top2", (0, 1, 2, 3)), (2, 2, "top2", (0, 1, 2)),
        (4, 2, "top2", (0, 1, 2)), (4, 4, "top2", (0, 1, 2)),
        (2, 2, "top1", (1,)), (4, 4, "top1", (2,)),
        (4, 2, "einsum", (1,)),
        (2, 2, "clip", (2,)), (4, 2, "clip", (0,)),
        (2, 2, "gas2", (2,)), (4, 4, "gas2", (0,))]
TRAJECTORIES = [(w, ep, v, st) for w, ep, v, stages in RUNS for st in stages]
# (top_k, T a rank, E, capacity factor) of the plan cases, at each world
PLANS = [(2, 48, 8, 1.0), (1, 48, 8, 1.0), (2, 64, 4, 0.5)]
# checkpoints: (world, ep, stage) that saves -> (world, ep, stage) loads
SAVE_A, SAVE_B1, SAVE_B4 = (2, 2, 2), (1, 1, 0), (4, 4, 1)
LOADS = {"A": [(1, 1, 0), (4, 4, 1)], "B1": [(2, 2, 1)],
         "B4": [(2, 2, 0)]}


def _case(variant, ep):
    model_kw, extra, gas = VARIANTS[variant]
    return dict(model="moe-tiny", dtype="float32", gas=gas, steps=STEPS,
                model_kw=model_kw,
                config=dict(CONFIG, parallel={"expert_parallel_size": ep},
                            **extra))


def _batches(variant):
    return token_batches(STEPS, VARIANTS[variant][2])


def _jax_run(variant):
    """JAX's engine on the 8-device mesh, experts over an expert axis of
    2: the init and the trajectory."""
    model_kw, extra, gas = VARIANTS[variant]
    cfg = dict(CONFIG, train_micro_batch_size_per_gpu=GLOBAL_ROWS // 8,
               parallel={"expert_parallel_size": 2}, **extra)
    eng, *_ = deepspeed_tpu.initialize(
        model=jax_create_model("moe-tiny", dtype=jnp.float32,
                               max_seq_len=SEQ, **model_kw), config=cfg)
    assert int(eng.mesh.shape["expert"]) == 2
    init = jax.tree.map(np.asarray, jax.device_get(eng.params))
    losses = [float(eng.train_batch(batch=jax.tree.map(jnp.asarray, b)))
              for b in _batches(variant)]
    return init, {"losses": losses, "params": jax.tree.map(
        lambda a: np.asarray(a, np.float32), jax.device_get(eng.params))}


def _plan_logits(world):
    return [np.random.default_rng(world * 10 + i).normal(
        size=(world * T, E)).astype(np.float32)
        for i, (_, T, E, _) in enumerate(PLANS)]


def _ckpt_steps(world, dirs, phase):
    """The checkpoint steps a spawn of ``world`` runs in ``phase``."""
    steps = []
    for name, save in (("A", SAVE_A), ("B1", SAVE_B1), ("B4", SAVE_B4)):
        if phase == 0 and save[0] == world:
            steps.append(((name, "save"), _case("top2", save[1]), "top2",
                          save[2], dirs[name], name, True))
        for load in LOADS[name]:
            if load[0] == world and _load_phase(name, world) == phase:
                steps.append(((name, "load", load), _case("top2", load[1]),
                              "top2", load[2], dirs[name], name, False))
    return steps


def _load_phase(name, world):
    # the world-4 checkpoint is saved after the first world-2 spawn
    return 1 if (name, world) == ("B4", 2) else 0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inits, jax_out = {}, {}
    for variant in VARIANTS:
        inits[variant], jax_out[variant] = _jax_run(variant)
    dirs = {n: str(tmp_path_factory.mktemp(f"moe_ep_{n}"))
            for n in ("A", "B1", "B4")}
    port = {}
    top2 = _case("top2", 1)
    port[("B1", "save")] = checkpoint_case(top2, inits["top2"], 1,
                                           SAVE_B1[2], dirs["B1"], "B1",
                                           True)
    port["eval", 1] = moe_eval(top2, inits["top2"], 1)
    for variant in ("top2", "clip"):
        port[(1, 0, variant, 1, 0)] = train_case(
            _case(variant, 1), inits[variant], 1, 0, _batches(variant))
    for world in (2, 4):
        cases = {(v, ep, st): _case(v, ep)
                 for w, ep, v, stages in RUNS if w == world for st in stages}
        plans = [(lg, k, cf) for lg, (k, _, _, cf) in
                 zip(_plan_logits(world), PLANS)]
        res = spawn(moe_ep_runs, world, cases, inits, plans,
                    {"ep2": _case("top2", 2)},
                    _ckpt_steps(world, dirs, 0), timeout=400)
        for rank, out in enumerate(res):
            for key, val in out.items():
                port[(world, rank) + (key if isinstance(key, tuple)
                                      else (key,))] = val
    for load in LOADS["A"]:
        if load[0] == 1:
            port[(1, 0, "A", "load", load)] = checkpoint_case(
                _case("top2", load[1]), inits["top2"], 1, load[2],
                dirs["A"], "A", False)
    for rank, out in enumerate(spawn(moe_ep_runs, 2, {}, inits, [], {},
                                     _ckpt_steps(2, dirs, 1))):
        for key, val in out.items():
            port[(2, rank) + key] = val
    return {"inits": inits, "jax": jax_out, "port": port}


# ---------------------------------------------------------------------------
# the rank layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,ep", [(2, 2), (4, 2), (4, 4), (8, 2),
                                      (8, 8)])
def test_topology_matches_jax_mesh(world, ep):
    mesh = build_mesh(ParallelConfig(expert_parallel_size=ep),
                      devices=jax.devices()[:world])
    grid = np.vectorize(lambda d: d.id)(mesh.devices)[0, :, :, 0, 0]
    ids = [d.id for d in jax.devices()[:world]]
    rank_of = {i: r for r, i in enumerate(ids)}
    assert grid.shape == (ep, world // ep)
    for r in range(world):
        t = Topology(world, ep, r)
        e, d = t.expert_index(), t.data_index()
        assert rank_of[int(grid[e, d])] == r
        # JAX's expert-data group: the data axis at this expert index
        assert t.expert_data_ranks() == [rank_of[int(i)] for i in grid[e]]
        # JAX's expert-parallel group: the expert axis at this data index
        assert t.expert_parallel_ranks() == [rank_of[int(i)]
                                             for i in grid[:, d]]
        per = 8 // ep
        assert t.banks(8) == (e * per, (e + 1) * per)


def test_topology_refuses_degrees_that_do_not_divide(monkeypatch):
    with pytest.raises(ValueError, match="must divide"):
        Topology(4, 3, 0)
    with pytest.raises(ValueError, match="divisible"):
        Topology(4, 4, 0).banks(6)
    # the engine: ep 4 over a world of 2
    monkeypatch.setattr(comm, "get_world_size", lambda group=None: 2)
    with pytest.raises(ValueError, match="must divide"):
        initialize(model=create_model("moe-tiny", dtype=torch.float32,
                                      max_seq_len=SEQ),
                   config=case_config(_case("top2", 4), 2, 0), device="cpu")


# ---------------------------------------------------------------------------
# the global plan
# ---------------------------------------------------------------------------

def _ulp_close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=GATE_ULPS * float(np.spacing(
                                   np.maximum(np.abs(want).max(), 1e-30))))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("i", range(len(PLANS)))
def test_global_plan_matches_jax(runs, world, i):
    k, T, E, cf = PLANS[i]
    logits = _plan_logits(world)[i]
    want = (jmoe.top2_plan if k == 2 else jmoe.top1_plan)(
        jnp.asarray(logits), cf, 4)
    whole = torch.tensor(logits, requires_grad=True)
    pplan = (pmoe.top2_plan if k == 2 else pmoe.top1_plan)(whole, cf, 4)
    pplan.aux_loss.backward()
    aux_grad = whole.grad.numpy()
    dropped = 0
    for r in range(world):
        got = runs["port"][(world, r, "plan", i)]
        rows = slice(r * T, (r + 1) * T)
        assert got["capacity"] == want.capacity == pplan.capacity
        for name in ("expert_idx", "slot_pos", "valid"):
            np.testing.assert_array_equal(got[name],
                                          np.asarray(getattr(want, name))[
                                              rows], err_msg=name)
            np.testing.assert_array_equal(
                got[name], getattr(pplan, name)[rows].numpy())
        np.testing.assert_array_equal(got["expert_counts"],
                                      np.asarray(want.expert_counts))
        np.testing.assert_array_equal(got["weight"],
                                      pplan.weight[rows].detach().numpy())
        np.testing.assert_array_equal(got["aux_loss"],
                                      pplan.aux_loss.detach().numpy())
        _ulp_close(got["weight"], np.asarray(want.weight)[rows])
        _ulp_close(got["aux_loss"], want.aux_loss)
        # every rank's copy of the aux loss sends its grad back to the rows
        np.testing.assert_allclose(got["aux_grad"] / world,
                                   aux_grad[rows], rtol=1e-6, atol=1e-12)
        dropped += int((~got["valid"]).sum())
    assert dropped > 0            # the cases drop: the capacity is global


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("k", [1, 2])
def test_local_slots_pack_a_ranks_assignments(world, k):
    """Over all tokens ``local_slots`` is the plan's queue slot; over one
    rank's rows each expert's kept assignments take distinct slots below
    min(C, T): the rank's slab, whose size does not grow with the world."""
    T, E = 96, 8
    lg = torch.tensor(np.random.default_rng(k + world).normal(
        size=(world * T, E)).astype(np.float32))
    plan = (pmoe.top2_plan if k == 2 else pmoe.top1_plan)(lg, 1.0, 4)
    whole = pmoe.local_slots(plan, E)
    assert torch.equal(whole[plan.valid], plan.slot_pos[plan.valid])
    for r in range(world):
        part = pmoe._rows(plan, r * T, T)
        pos = pmoe.local_slots(part, E)
        # the rank's kept assignments counted per expert, k-major
        seen = [0] * E
        for kk in range(k):
            for t in range(T):
                if part.valid[t, kk]:
                    e = int(part.expert_idx[t, kk])
                    assert int(pos[t, kk]) == seen[e]
                    seen[e] += 1
        assert max(seen) <= min(plan.capacity, T)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("world,ep,variant,stage", TRAJECTORIES,
                         ids=[f"w{w}-ep{ep}-{v}-z{st}"
                              for w, ep, v, st in TRAJECTORIES])
def test_trajectory_matches_jax(runs, world, ep, variant, stage):
    want = runs["jax"][variant]
    for r in range(world):
        got = runs["port"][(world, r, variant, ep, stage)]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
        if r == 0:
            for path, leaf in tree_items(want["params"]):
                np.testing.assert_allclose(_leaf(got["params"], path), leaf,
                                           atol=1e-4, err_msg=str(path))
    assert got["losses"][-1] < got["losses"][0]


@pytest.mark.parametrize("world,ep,variant,stage",
                         [t for t in TRAJECTORIES if t[2] in ("top2", "clip")],
                         ids=[f"w{w}-ep{ep}-{v}-z{st}"
                              for w, ep, v, st in TRAJECTORIES
                              if v in ("top2", "clip")])
def test_grad_norm_counts_each_bank_once(runs, world, ep, variant, stage):
    """The norm every rank clips by equals the one rank's norm of the same
    step, at every stage and degree; the clip runs' norms are above the
    threshold, so the clip is in force."""
    want = runs["port"][(1, 0, variant, 1, 0)]["grad_norms"]
    for r in range(world):
        got = runs["port"][(world, r, variant, ep, stage)]["grad_norms"]
        np.testing.assert_allclose(got, want, rtol=1e-5)
    if variant == "clip":
        assert min(want) > VARIANTS["clip"][1]["gradient_clipping"]


def _n_experts(params):
    return sum(int(np.prod(v.shape)) for p, v in tree_items(params)
               if p[:2] == ("layers", "mlp"))


@pytest.mark.parametrize("world,ep", [(2, 2), (4, 2), (4, 4)])
@pytest.mark.parametrize("stage", [0, 1, 2])
def test_a_rank_holds_only_its_banks(runs, world, ep, stage):
    init = runs["inits"]["top2"]
    n_exp = _n_experts(init)
    n = sum(int(np.prod(v.shape)) for _, v in tree_items(init))
    data = world // ep
    for r in range(world):
        mem = runs["port"][(world, r, "top2", ep, stage)]["memory"]
        (name0, dense, chunk0, _), (name1, banks, chunk1, _) = mem["units"]
        assert (name0, name1) == ("flat", "experts")
        assert (dense, banks) == (n - n_exp, n_exp // ep)
        parts0 = world if stage else 1
        parts1 = data if stage else 1
        assert chunk0 <= -(-dense // parts0) + 16
        assert chunk1 <= -(-banks // parts1) + 16
        assert mem["shard"] == chunk0 + chunk1
        for buf in ("exp_avg", "exp_avg_sq"):
            assert mem["buffers"][buf] == chunk0 + chunk1
        assert mem["whole"] == {"flat": dense if stage == 0 else
                                chunk0 * world,
                                "experts": banks if stage == 0 else
                                chunk1 * data}


def test_stage3_at_ep1_gathers_a_layer_at_a_time(runs):
    for r in range(2):
        mem = runs["port"][(2, r, "top2", 1, 3)]["memory"]
        assert mem["peak_live"] <= 2 and mem["live"] == 0
        assert all(g for name, _, _, g in mem["units"]
                   if name != "persistent")


def test_eval_loss_at_ep2_is_the_whole_batchs(runs):
    one = runs["port"][("eval", 1)]
    for world in (2, 4):
        for r in range(world):
            np.testing.assert_allclose(
                runs["port"][(world, r, "eval", "ep2")], one, rtol=1e-5)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _saved(runs, name):
    world = {"A": SAVE_A, "B1": SAVE_B1, "B4": SAVE_B4}[name][0]
    return runs["port"][(world, 0, name, "save") if world > 1
                        else (name, "save")]


@pytest.mark.parametrize("name,load", [(n, ld) for n, lds in LOADS.items()
                                       for ld in lds],
                         ids=[f"{n}-to-w{ld[0]}-ep{ld[1]}"
                              for n, lds in LOADS.items() for ld in lds])
def test_checkpoint_loads_at_another_world_and_degree(runs, name, load):
    saved = _saved(runs, name)
    assert saved["problems"] == []
    for r in range(load[0]):
        got = runs["port"][(load[0], r, name, "load", load)]
        assert got["global_steps"] == got["count"] == 2
        jax.tree.map(np.testing.assert_array_equal, got["params"],
                     saved["params"])
        np.testing.assert_allclose(got["loss3"], saved["loss3"], rtol=1e-5)
        jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b,
                                                             atol=1e-5),
                     got["params3"], saved["params3"])


def test_params_from_jax_takes_a_ranks_banks():
    """``params_from_jax(..., banks=)``: the expert leaves keep experts [lo,
    hi) of their expert axis, every other leaf whole: the tree a rank at ep
    4 holds."""
    from deepspeed_tpu_torch.models import params_from_jax, params_to_numpy

    model = create_model("moe-tiny", dtype=torch.float32, max_seq_len=SEQ)
    gen = torch.Generator()
    gen.manual_seed(0)
    init = params_to_numpy(model.init(gen))
    cfg = model.config
    lo, hi = Topology(4, 4, 1).banks(cfg.moe_num_experts)
    got = params_from_jax(init, cfg, banks=(lo, hi))
    for path, leaf in tree_items(init):
        want = leaf[:, lo:hi] if path[:2] == ("layers", "mlp") else leaf
        np.testing.assert_array_equal(_leaf(got, path).numpy(), want,
                                      err_msg=str(path))
