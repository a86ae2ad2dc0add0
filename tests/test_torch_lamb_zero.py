"""LAMB over a partitioned shard: worlds 2 and 4 over gloo, ZeRO stages 0-3.

A rank's shard holds parts of leaves; LAMB's segments are those parts,
each with its leaf's id, and phase 2 all-reduces the per-leaf sums of
||p||^2 and ||u||^2 before each trust ratio (``ops/fused_lamb.py``). The
trajectory does not depend on the world, so the JAX engine on its 8-way data
axis (``optax.lamb`` per stacked leaf) is the reference: ``tiny`` with
weight decay, and with gas 2 and clipping, from the JAX init on the same
global batches. Losses rtol 1e-4 and final params atol 1e-4 against JAX;
every stage and world against the port's stage 0 at world 1 within 1e-5.
``rank_segments`` tiles each rank's shard. Each world is one spawn.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models.presets import create_model as jax_create_model
from deepspeed_tpu_torch.models import create_model
from deepspeed_tpu_torch.parallel import ZeroPartition
from torch_dist_workers import (GLOBAL_ROWS, SEQ, spawn, stage_runs,
                                token_batches, train_case)

LAMB = {"optimizer": {"type": "lamb",
                      "params": {"lr": 1e-3, "weight_decay": 0.01}},
        "steps_per_print": 1000}
CASES = {
    "lamb": dict(model="tiny", dtype="float32", gas=1, steps=4,
                 stages=(0, 1, 2, 3), jax_stages=(0, 3),
                 config=dict(LAMB, zero_optimization={
                     "stage3_param_persistence_threshold": 200})),
    "gas2_clip": dict(model="tiny", dtype="float32", gas=2, steps=3,
                      stages=(0, 1, 2, 3), jax_stages=(0,),
                      config=dict(LAMB, gradient_accumulation_steps=2,
                                  gradient_clipping=0.05)),
}
WORLDS = (1, 2, 4)


def _jax_run(case, stage):
    cfg = dict(case["config"], train_micro_batch_size_per_gpu=1)
    cfg["zero_optimization"] = dict(cfg.get("zero_optimization", {}),
                                    stage=stage)
    eng, *_ = deepspeed_tpu.initialize(
        model=jax_create_model("tiny", dtype=jnp.float32, max_seq_len=SEQ),
        config=cfg)
    assert eng.train_batch_size() == GLOBAL_ROWS * case["gas"]
    init = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jax.device_get(eng.params))
    losses = [float(eng.train_batch(batch=jax.tree.map(jnp.asarray, b)))
              for b in token_batches(case["steps"], case["gas"])]
    return init, {"losses": losses, "params": jax.tree.map(
        lambda a: np.asarray(a, np.float32), jax.device_get(eng.params))}


@pytest.fixture(scope="module")
def runs():
    inits, jax_out, port = {}, {}, {}
    for name, case in CASES.items():
        for stage in case["jax_stages"]:
            inits[name], jax_out[(name, stage)] = _jax_run(case, stage)
        for stage in case["stages"]:
            port[(1, name, stage)] = train_case(
                case, inits[name], 1, stage,
                token_batches(case["steps"], case["gas"]))
    for world in (2, 4):
        res = spawn(stage_runs, world, CASES, inits)
        for key, val in res[0].items():
            port[(world,) + key] = val
        for rank, out in enumerate(res[1:], 1):
            for key, val in out.items():
                assert val["losses"] == res[0][key]["losses"], (rank, key)
    return {"jax": jax_out, "port": port}


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_lamb_stages_match_jax(runs, name, world):
    case = CASES[name]
    for stage in case["stages"]:
        got = runs["port"][(world, name, stage)]
        want = runs["jax"][(name, stage if stage in case["jax_stages"]
                            else 0)]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4,
                                   err_msg=f"world {world} stage {stage}")
        jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b,
                                                             atol=1e-4),
                     got["params"], want["params"])


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_lamb_stages_match_stage0(runs, name, world):
    """Each stage and world against stage 0 at world 1 within 1e-5 (the
    per-leaf sums and the clip norm add up in another order)."""
    base = runs["port"][(1, name, 0)]
    for stage in CASES[name]["stages"]:
        got = runs["port"][(world, name, stage)]
        np.testing.assert_allclose(got["losses"], base["losses"], rtol=1e-5,
                                   atol=1e-5)
        jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b,
                                                             atol=1e-5),
                     got["params"], base["params"])


@pytest.mark.parametrize("world", [1, 2, 3, 4])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_rank_segments_tile_the_shard(stage, world):
    g = torch.Generator()
    g.manual_seed(0)
    params = create_model("tiny", dtype=torch.float32).init(g)
    n_leaves = len(list(jax.tree.leaves(params)))
    per_leaf = {}
    for rank in range(world):
        part = ZeroPartition.build(stage, params, world, rank, 300)
        sizes, ids = part.rank_segments(rank)
        assert sum(sizes) == part.shard_numel
        assert all(s > 0 for s in sizes) and max(ids) < n_leaves
        # at stage 0 every rank's shard is the whole model
        for size, leaf in zip(sizes, ids):
            if leaf >= 0 and (stage >= 1 or rank == 0):
                per_leaf[leaf] = per_leaf.get(leaf, 0) + size
    sizes = {i: int(np.prod(pcs[0][1].shape))
             for i, pcs in enumerate(ZeroPartition.build(
                 stage, params, world, 0, 300).leaf_pieces().values())}
    assert per_leaf == sizes
