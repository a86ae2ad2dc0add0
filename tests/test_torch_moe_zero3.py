"""MoE at ZeRO stage 3 under expert parallelism, and Random Token Selection
beyond one rank, on the CPU at worlds 2 and 4 over gloo, against the JAX
engine on its 8-device mesh.

* Training ``moe-tiny`` (fp32, AdamW with weight decay, 3 steps) at ZeRO
  stage 3 with world 2 ep 2, world 4 ep 2 and world 4 ep 4, plus gas 2
  with a clip that clips, each against JAX's engine at stage 3 with its
  experts over an ``expert`` axis of 2 (fsdp over ``data``), fed the same
  global batches from the same init: losses rtol 1e-4, final params atol
  1e-4 (``tests/test_torch_moe_ep.py``'s bar). The grad norm every rank
  clips by equals the one rank's.
* A rank at stage 3 holds 1 / world of each layer's dense slice and 1 /
  (world / ep) of its E / ep banks (``layer<i>_experts``); at most a
  layer's two units and the embedding / head unit are gathered at once.
* Checkpoints at stage 3: saved at world 2 ep 2, loaded at world 1 and at
  world 4 ep 4; saved at world 1 (stage 0) and at world 4 ep 4, loaded at
  world 2 ep 2. The loaded params equal the saved ones bit for bit and the
  next step agrees.
* Random Token Selection with no generator passed: at worlds 2 and 4 each
  rank's rows of the global plan equal the plan of one process over the
  concatenated logits bit for bit, and a second plan of the same input
  keeps the same tokens; logits that route every token alike but differ
  in one bit keep other tokens. ``moe-tiny`` with RTS (top-1, capacity
  factor 0.5) trains at world 2 (stages 0 and 3) and world 4 ep 2.

Each world is one spawn (``torch_dist_workers.moe_ep_runs``), plus a short
second world-2 spawn that loads the world-4 checkpoint.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models.presets import create_model as jax_create_model
from deepspeed_tpu_torch.models.core import tree_items
from deepspeed_tpu_torch.parallel import moe as pmoe
from torch_dist_workers import (GLOBAL_ROWS, SEQ, checkpoint_case,
                                moe_ep_runs, spawn, token_batches,
                                train_case)

STEPS = 3
CONFIG = {"optimizer": {"type": "adamw",
                        "params": {"lr": 1e-3, "weight_decay": 0.01}},
          "steps_per_print": 1000}
RTS = {"moe_top_k": 1, "moe_use_rts": True, "moe_capacity_factor": 0.5}
# the model's overrides, the config's additions and gas of each variant
VARIANTS = {
    "top2": ({}, {}, 1),
    "gas2_clip": ({}, {"gradient_accumulation_steps": 2,
                       "gradient_clipping": 0.05}, 2),
    "rts": (RTS, {}, 1),
}
# (world, ep, variant, stages)
RUNS = [(2, 2, "top2", (3,)), (4, 2, "top2", (3,)), (4, 4, "top2", (3,)),
        (2, 2, "gas2_clip", (3,)), (4, 4, "gas2_clip", (3,)),
        (2, 1, "rts", (0, 3)), (4, 2, "rts", (3,))]
TRAJECTORIES = [(w, ep, v, st) for w, ep, v, stages in RUNS for st in stages
                if v != "rts"]
# (T a rank, E, capacity factor) of the RTS plan cases: every token's
# favourite is expert 0 in the first, the logits random in the second
RTS_PLANS = [(48, 4, 1.0, 3.0), (64, 8, 0.5, 0.0)]
# checkpoints: (world, ep, stage) that saves -> (world, ep, stage) loads
SAVE_A, SAVE_B1, SAVE_B4 = (2, 2, 3), (1, 1, 0), (4, 4, 3)
LOADS = {"A": [(1, 1, 3), (4, 4, 3)], "B1": [(2, 2, 3)],
         "B4": [(2, 2, 3)]}


def _case(variant, ep):
    model_kw, extra, gas = VARIANTS[variant]
    return dict(model="moe-tiny", dtype="float32", gas=gas, steps=STEPS,
                model_kw=model_kw,
                config=dict(CONFIG, parallel={"expert_parallel_size": ep},
                            zero_optimization={
                                "stage3_param_persistence_threshold": 200},
                            **extra))


def _batches(variant):
    return token_batches(STEPS, VARIANTS[variant][2])


def _jax_run(variant):
    """JAX's engine at ZeRO stage 3 on the 8-device mesh, experts over an
    expert axis of 2: the init and the trajectory."""
    model_kw, extra, gas = VARIANTS[variant]
    cfg = dict(CONFIG, train_micro_batch_size_per_gpu=GLOBAL_ROWS // 8,
               parallel={"expert_parallel_size": 2},
               zero_optimization={"stage": 3}, **extra)
    eng, *_ = deepspeed_tpu.initialize(
        model=jax_create_model("moe-tiny", dtype=jnp.float32,
                               max_seq_len=SEQ, **model_kw), config=cfg)
    assert int(eng.mesh.shape["expert"]) == 2
    init = jax.tree.map(np.asarray, jax.device_get(eng.params))
    losses = [float(eng.train_batch(batch=jax.tree.map(jnp.asarray, b)))
              for b in _batches(variant)]
    return init, {"losses": losses, "params": jax.tree.map(
        lambda a: np.asarray(a, np.float32), jax.device_get(eng.params))}


def _rts_logits(world):
    """Per case two (world * T, E) fp32 logits: the second is the first
    with the first token's lowest logit one ulp up, which moves no token's
    top expert."""
    out = []
    for i, (T, E, _, skew) in enumerate(RTS_PLANS):
        lg = np.random.default_rng(world * 7 + i).normal(
            size=(world * T, E)).astype(np.float32)
        lg[:, 0] += skew
        other = lg.copy()
        low = int(np.argmin(lg[0]))          # never a token's top expert
        other[0, low] = np.nextafter(other[0, low], np.float32(np.inf))
        out.append((lg, other))
    return out


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
    for variant in ("top2", "gas2_clip"):
        inits[variant], jax_out[variant] = _jax_run(variant)
    inits["rts"] = inits["top2"]
    dirs = {n: str(tmp_path_factory.mktemp(f"moe_z3_{n}"))
            for n in ("A", "B1", "B4")}
    port = {}
    port[("B1", "save")] = checkpoint_case(_case("top2", 1), inits["top2"],
                                           1, SAVE_B1[2], dirs["B1"], "B1",
                                           True)
    for variant in VARIANTS:
        port[(1, 0, variant, 1, 0)] = train_case(
            _case(variant, 1), inits[variant], 1, 0, _batches(variant))
    for world in (2, 4):
        cases = {(v, ep, st): _case(v, ep)
                 for w, ep, v, stages in RUNS if w == world for st in stages}
        plans = [(lg, 1, RTS_PLANS[i][2], True)
                 for i, pair in enumerate(_rts_logits(world)) for lg in pair]
        res = spawn(moe_ep_runs, world, cases, inits, plans, {},
                    _ckpt_steps(world, dirs, 0), timeout=400)
        for rank, out in enumerate(res):
            for key, val in out.items():
                port[(world, rank) + key] = val
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


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# expert parallelism at stage 3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,ep,variant,stage", TRAJECTORIES,
                         ids=[f"w{w}-ep{ep}-{v}-z{st}"
                              for w, ep, v, st in TRAJECTORIES])
def test_stage3_trajectory_matches_jax(runs, world, ep, variant, stage):
    want = runs["jax"][variant]
    one = runs["port"][(1, 0, variant, 1, 0)]
    for r in range(world):
        got = runs["port"][(world, r, variant, ep, stage)]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
        # the norm every rank clips by counts each bank once
        np.testing.assert_allclose(got["grad_norms"], one["grad_norms"],
                                   rtol=1e-5)
        if r == 0:
            for path, leaf in tree_items(want["params"]):
                np.testing.assert_allclose(_leaf(got["params"], path), leaf,
                                           atol=1e-4, err_msg=str(path))
    assert got["losses"][-1] < got["losses"][0]
    if variant == "gas2_clip":
        clip = VARIANTS[variant][1]["gradient_clipping"]
        assert min(one["grad_norms"]) > clip


def _n_experts(params):
    return sum(int(np.prod(v.shape)) for p, v in tree_items(params)
               if p[:2] == ("layers", "mlp"))


@pytest.mark.parametrize("world,ep", [(2, 2), (4, 2), (4, 4)])
def test_stage3_rank_holds_its_share_of_its_banks(runs, world, ep):
    init = runs["inits"]["top2"]
    L = init["layers"]["router"].shape[0]
    per_layer = _n_experts(init) // L
    data = world // ep
    for r in range(world):
        mem = runs["port"][(world, r, "top2", ep, 3)]["memory"]
        units = {name: (n, chunk, g) for name, n, chunk, g in mem["units"]}
        for li in range(L):
            n, chunk, gathered = units[f"layer{li}_experts"]
            assert gathered and n == per_layer // ep
            assert chunk <= -(-n // data) + 16
            dense, dchunk, _ = units[f"layer{li}"]
            assert dchunk <= -(-dense // world) + 16
        assert mem["shard"] == sum(c for _, c, _ in units.values())
        for buf in ("exp_avg", "exp_avg_sq", "acc"):
            assert mem["buffers"][buf] == mem["shard"]
        # a layer's dense and bank units and the embedding / head unit
        assert mem["peak_live"] <= 3 and mem["live"] == 0


@pytest.mark.parametrize("name,load", [(n, ld) for n, lds in LOADS.items()
                                       for ld in lds],
                         ids=[f"{n}-to-w{ld[0]}-ep{ld[1]}-z{ld[2]}"
                              for n, lds in LOADS.items() for ld in lds])
def test_stage3_checkpoint_loads_at_another_world_and_degree(runs, name,
                                                             load):
    world = {"A": SAVE_A, "B1": SAVE_B1, "B4": SAVE_B4}[name][0]
    saved = runs["port"][(world, 0, name, "save") if world > 1
                         else (name, "save")]
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


# ---------------------------------------------------------------------------
# Random Token Selection beyond one rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("i", range(len(RTS_PLANS)))
def test_rts_plan_is_the_one_process_plan(runs, world, i):
    T, E, cf, _ = RTS_PLANS[i]
    pair = _rts_logits(world)[i]
    wants = [pmoe.top1_plan(torch.tensor(lg), cf, 4, use_rts=True)
             for lg in pair]
    plain = pmoe.top1_plan(torch.tensor(pair[0]), cf, 4)
    dropped = 0
    for r in range(world):
        rows = slice(r * T, (r + 1) * T)
        for j, want in enumerate(wants):
            got = runs["port"][(world, r, "plan", 2 * i + j)]
            assert got["capacity"] == want.capacity < world * T
            assert got["same_again"]
            for name in ("expert_idx", "slot_pos", "valid", "weight",
                         "expert_counts", "aux_loss"):
                want_v = getattr(want, name)
                want_v = want_v[rows] if want_v.dim() == 2 else want_v
                np.testing.assert_array_equal(
                    got[name], want_v.detach().numpy(), err_msg=name)
        dropped += int((~got["valid"]).sum())
    assert dropped > 0
    # the one-ulp change routes every token alike and keeps other tokens;
    # without RTS the first C of each queue are kept
    assert torch.equal(wants[0].expert_idx, wants[1].expert_idx)
    assert not torch.equal(wants[0].valid, wants[1].valid)
    assert not torch.equal(wants[0].valid, plain.valid)


@pytest.mark.parametrize("world,ep,stage", [(2, 1, 0), (2, 1, 3),
                                            (4, 2, 3)])
def test_rts_trains_beyond_one_rank(runs, world, ep, stage):
    """Every rank returns the same losses, finite and falling. The keep-set
    is a function of the gathered logits' bits, which a rank computes for
    its own rows: another world may draw other tokens than one process, so
    the trajectories are not held to each other; the first loss, from the
    same weights, stays near the one-process run's."""
    one = runs["port"][(1, 0, "rts", 1, 0)]["losses"]
    got = [runs["port"][(world, r, "rts", ep, stage)]["losses"]
           for r in range(world)]
    assert all(g == got[0] for g in got)
    assert np.isfinite(got[0]).all() and got[0][-1] < got[0][0]
    np.testing.assert_allclose(got[0][0], one[0], rtol=1e-3)
