"""ZeRO stages 0-3 of the port on the CPU, at worlds 1, 2 and 4 over gloo.

* The partition (``parallel/zero.py``): the stage table, units, 16-element
  alignment of every rank's range, the persistence threshold, and the
  rank's pieces tiling each unit.
* Trajectories against the JAX engine on its default 8-way data axis, fed
  the same global batches (numpy from a seed) from the JAX init: ``tiny``
  (AdamW with weight decay) at every stage and world, ``tiny`` with gas 2
  and clipping and ``tiny`` in fp16 with overflow skips at world 2, and
  JAX's ``simple_model`` fixture at every stage and world. Losses rtol
  1e-4 and final params atol 1e-4 against JAX (fp16: the loss tolerance and
  the exact scales and skips of ``test_torch_training``); the port's stages
  against its own stage 0 at the same world within 1e-5.
* Stage 3's memory: between steps a rank holds its shard of each buffer
  (at most ceil(n / world) plus 16 elements of each unit), the persistent
  leaves whole, no gathered params and no grad buffer; during a step at most
  two gather units at once.
* Checkpoints across worlds and stages: saved at world 2 stage 3, loaded at
  world 1 stage 0 and at world 4 stage 1; the next step agrees.

Each world size is one spawn that runs every case; the tests read its
results.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models import simple_model as jax_simple_model
from deepspeed_tpu.models.presets import create_model as jax_create_model
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.parallel import ALIGN, ZeroPartition, sharded
from deepspeed_tpu_torch.models import params_to_numpy
from torch_dist_workers import (GLOBAL_ROWS, SEQ, case_config, port_model,
                                regression_batches, spawn, token_batches,
                                train_case, zero_runs)

ADAMW = {"optimizer": {"type": "adamw",
                       "params": {"lr": 1e-3, "weight_decay": 0.01}},
         "steps_per_print": 1000}
CASES = {
    "adamw": dict(model="tiny", dtype="float32", gas=1, steps=4,
                  stages=(0, 1, 2, 3), worlds=(1, 2, 4), jax_stages=(0, 3),
                  config=dict(ADAMW, zero_optimization={
                      "stage3_param_persistence_threshold": 200})),
    "gas2_clip": dict(model="tiny", dtype="float32", gas=2, steps=3,
                      stages=(0, 2, 3), worlds=(1, 2), jax_stages=(0,),
                      config=dict(ADAMW, gradient_accumulation_steps=2,
                                  gradient_clipping=0.05)),
    "fp16": dict(model="tiny", dtype="float16", gas=1, steps=8,
                 stages=(0, 1, 3), worlds=(2,), jax_stages=(0,),
                 config=dict(ADAMW, fp16={"enabled": True,
                                          "initial_scale_power": 32,
                                          "hysteresis": 1,
                                          "loss_scale_window": 4})),
    # JAX cannot shard the fixture's 10-wide leaves over 8 devices: its
    # stage 0 is the reference (JAX holds its stages to one trajectory)
    "simple": dict(model="simple", dtype="float32", gas=1, steps=5,
                   stages=(0, 1, 2, 3), worlds=(1, 2, 4), jax_stages=(0,),
                   config={"optimizer": {"type": "adamw",
                                         "params": {"lr": 1e-2}},
                           "steps_per_print": 1000,
                           "zero_optimization": {
                               "stage3_param_persistence_threshold": 0}}),
}
CKPT = dict(case="adamw", save_world=2, save_stage=3, load_stage=1)


def _jax_model(case):
    if case["model"] == "simple":
        return jax_simple_model(hidden_dim=10)
    return jax_create_model(case["model"], dtype=getattr(jnp, case["dtype"]),
                            max_seq_len=SEQ)


def _batches(case):
    return (regression_batches(case["steps"]) if case["model"] == "simple"
            else token_batches(case["steps"], case["gas"]))


def _jax_run(case, stage):
    cfg = dict(case["config"])
    cfg["train_micro_batch_size_per_gpu"] = 1         # x 8 devices
    cfg["zero_optimization"] = dict(cfg.get("zero_optimization", {}),
                                    stage=stage)
    eng, *_ = deepspeed_tpu.initialize(model=_jax_model(case), config=cfg)
    assert eng.train_batch_size() == GLOBAL_ROWS * case["gas"]
    init = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jax.device_get(eng.params))
    losses, scales = [], []
    for b in _batches(case):
        losses.append(float(eng.train_batch(
            batch=jax.tree.map(jnp.asarray, b))))
        scales.append(eng.cur_scale)
    return init, {"losses": losses, "scales": scales,
                  "skipped": eng.skipped_steps,
                  "params": jax.tree.map(
                      lambda a: np.asarray(a, np.float32),
                      jax.device_get(eng.params))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX references, the port at world 1 in this process, and the port at
    worlds 2 and 4 (one spawn each; world 2 saves the checkpoint that world
    1 and world 4 load)."""
    inits, jax_out, port = {}, {}, {}
    for name, case in CASES.items():
        for stage in case["jax_stages"]:
            inits[name], jax_out[(name, stage)] = _jax_run(case, stage)
        if 1 in case["worlds"]:
            for stage in case["stages"]:
                port[(1, name, stage)] = train_case(case, inits[name], 1,
                                                    stage, _batches(case))
    ckpt = dict(CKPT, dir=str(tmp_path_factory.mktemp("zero_ckpt")))
    for world in (2, 4):
        res = spawn(zero_runs, world, CASES, inits, ckpt)
        for rank, out in enumerate(res):
            for key, val in out.items():
                if key == "checkpoint":
                    port[(world, "checkpoint", rank)] = val
                    continue
                if rank == 0:
                    port[(world,) + key] = val
                port[(world, "memory", rank) + key] = val["memory"]
    return {"inits": inits, "jax": jax_out, "port": port, "ckpt": ckpt}


def _chunk(n, world):
    return -(-(-(-n // world)) // ALIGN) * ALIGN


def _tree_close(a, b, atol):
    jax.tree.map(lambda x, y: np.testing.assert_allclose(x, y, atol=atol),
                 a, b)


def _runs_of(runs, name):
    case = CASES[name]
    for world in case["worlds"]:
        for stage in case["stages"]:
            yield world, stage, runs["port"][(world, name, stage)]


# ---------------------------------------------------------------------------
# the partition
# ---------------------------------------------------------------------------

def test_stage_table():
    want = {0: (), 1: ("optimizer",), 2: ("optimizer", "grads"),
            3: ("optimizer", "grads", "params")}
    for stage, states in want.items():
        assert [s for s in ("optimizer", "grads", "params")
                if sharded(stage, s)] == list(states)
    with pytest.raises(ValueError):
        sharded(4, "params")


def _tiny_shapes():
    from deepspeed_tpu_torch.models import create_model

    g = torch.Generator()
    g.manual_seed(0)
    return create_model("tiny", dtype=torch.float32).init(g)


@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_partition_ranges_tile_each_unit(stage, world):
    params = _tiny_shapes()
    n = sum(t.numel() for t in jax.tree.leaves(params))
    parts = [ZeroPartition.build(stage, params, world, r, 300)
             for r in range(world)]
    p = parts[0]
    assert sum(u.numel for u in p.units) == n
    if stage < 3:
        assert [u.name for u in p.units] == ["flat"]
    else:
        names = [u.name for u in p.units]
        assert names == ["persistent"] + [f"layer{i}" for i in range(2)] \
            + ["rest"]
        for u in p.units:
            small = [math.prod(pc.shape) < 300 for pc in u.pieces]
            assert all(small) if u.name == "persistent" else not any(small)
    for u_i, u in enumerate(p.units):
        if u.parts > 1 or stage == 3:
            assert u.chunk % ALIGN == 0
            assert u.chunk <= -(-u.numel // world) + ALIGN
        else:
            assert u.chunk == u.numel
        covered = []
        # a unit of one part is held whole by every rank
        for r, pr in enumerate(parts[:u.parts]):
            lo, hi = pr.units[u_i].rank_range(r)
            assert lo % ALIGN == 0 or u.parts == 1
            for pc, start, count, pos in pr.rank_pieces(u_i, r):
                assert 0 <= pos < u.chunk and pos + count <= u.chunk
                covered.append((pc.path, start, count))
        # the ranks' pieces cover each piece of the unit exactly once
        for pc in u.pieces:
            runs = sorted((s, c) for path, s, c in covered
                          if path == pc.path and pc.start <= s
                          < pc.start + pc.numel)
            at = pc.start
            for s, c in runs:
                assert s == at
                at += c
            assert at == pc.start + pc.numel
    assert p.shard_numel == sum(u.chunk for u in p.units)


# ---------------------------------------------------------------------------
# trajectories
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["adamw", "gas2_clip", "simple"])
def test_stages_match_jax(runs, name):
    """Every stage at every world against the JAX engine at its 8-way data
    axis: losses rtol 1e-4, final params atol 1e-4."""
    case = CASES[name]
    for world, stage, got in _runs_of(runs, name):
        ref_stage = stage if stage in case["jax_stages"] else 0
        want = runs["jax"][(name, ref_stage)]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4,
                                   err_msg=f"world {world} stage {stage}")
        _tree_close(got["params"], want["params"], 1e-4)


@pytest.mark.parametrize("name", ["adamw", "gas2_clip", "fp16", "simple"])
def test_stages_match_stage0(runs, name):
    """At each world every stage follows stage 0 within 1e-5 (bit for bit
    without clipping: the clip norm is summed in another order)."""
    case = CASES[name]
    for world in case["worlds"]:
        base = runs["port"][(world, name, 0)]
        for stage in case["stages"][1:]:
            got = runs["port"][(world, name, stage)]
            np.testing.assert_allclose(got["losses"], base["losses"],
                                       rtol=1e-5, atol=1e-5)
            _tree_close(got["params"], base["params"], 1e-5)
            assert got["scales"] == base["scales"]
            assert got["skipped"] == base["skipped"]
            if world == 1 and not case["config"].get("gradient_clipping"):
                assert got["losses"] == base["losses"]


def test_fp16_overflow_skips_match_jax_at_world_2(runs):
    want = runs["jax"][("fp16", 0)]
    assert want["skipped"] > 0
    for stage in CASES["fp16"]["stages"]:
        got = runs["port"][(2, "fp16", stage)]
        assert got["scales"] == want["scales"]
        assert got["skipped"] == want["skipped"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-3)


# ---------------------------------------------------------------------------
# stage 3's memory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_stage3_rank_holds_its_shard(runs, world):
    for rank in range(world):
        mem = runs["port"][(world, "memory", rank, "adamw", 3)]
        units = mem["units"]
        bound = sum(-(-n // world) + ALIGN for _, n, _, _ in units)
        assert mem["shard"] <= bound
        for name, n in mem["buffers"].items():
            assert n == mem["shard"], name
        # whole on each rank: the leaves under the persistence threshold
        persistent = [u for u in units if not u[3]]
        assert [u[0] for u in persistent] == ["persistent"]
        assert mem["whole"] == {"persistent": persistent[0][2] * world}
        assert persistent[0][1] < 0.05 * sum(n for _, n, _, _ in units)
        assert mem["grad_bytes"] == 0 and mem["live"] == 0
        assert mem["peak_live"] == 2
        simple = runs["port"][(world, "memory", rank, "simple", 3)]
        assert simple["peak_live"] == 1 and simple["live"] == 0
        assert simple["shard"] == _chunk(simple["units"][0][1], world)


@pytest.mark.parametrize("stage,grads_sharded", [(1, False), (2, True)])
def test_stages_1_2_shard_the_optimizer(runs, stage, grads_sharded):
    mem = runs["port"][(4, "memory", 1, "adamw", stage)]
    n = mem["units"][0][1]
    assert mem["shard"] == _chunk(n, 4)
    assert mem["whole"] == {"flat": mem["shard"] * 4}
    assert ("acc" in mem["buffers"]) == grads_sharded
    assert mem["grad_bytes"] == (0 if grads_sharded else 4 * mem["shard"] * 4)


# ---------------------------------------------------------------------------
# checkpoints across worlds and stages
# ---------------------------------------------------------------------------

def test_checkpoint_saved_at_world2_stage3_loads_at_worlds_1_and_4(runs):
    saved = runs["port"][(2, "checkpoint", 0)]
    assert saved["problems"] == []
    case = CASES[CKPT["case"]]
    loaded = [runs["port"][(4, "checkpoint", r)] for r in range(4)]
    eng = initialize(model=port_model(case, runs["inits"]["adamw"]),
                     config=case_config(case, 1, 0), device="cpu")[0]
    eng.load_checkpoint(runs["ckpt"]["dir"])
    one = {"params": jax.tree.map(np.copy, params_to_numpy(eng.params)),
           "global_steps": eng.global_steps, "count": eng.opt_state.count,
           "loss3": float(eng.train_batch(batch=token_batches(3, 1, 5)[2])),
           "params3": params_to_numpy(eng.params)}
    for got in loaded + [one]:
        assert got["global_steps"] == got["count"] == 2
        jax.tree.map(np.testing.assert_array_equal, got["params"],
                     saved["params"])
        np.testing.assert_allclose(got["loss3"], saved["loss3"], rtol=1e-5)
        _tree_close(got["params3"], saved["params3"], 1e-5)

