"""The port's comm layer on the CPU: gloo process groups of 2 and 4.

* each collective (all_reduce with SUM / AVG / MAX / MIN / PRODUCT,
  all_gather, reduce_scatter, all_to_all, broadcast, the in-place
  all_gather, the host helpers) in fp32 and bf16 against numpy on every
  rank's inputs;
* the comms logger's count and per-rank bytes of each op, and its bandwidth
  formulas against the JAX package's;
* without a process group every collective is the one-participant identity
  and the rank / world are 0 / 1.

One spawn a world size runs every collective; the tests read its results.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu.comm.comms_logging import calc_bw_log as jax_calc_bw_log
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.comm import calc_bw_log
from torch_dist_workers import collectives, rank_data, spawn

WORLDS = (2, 4)
DTYPES = ("float32", "bfloat16")
TOL = {"float32": 1e-6, "bfloat16": 2e-2}


@pytest.fixture(scope="module", params=WORLDS)
def world_results(request):
    world = request.param
    return world, spawn(collectives, world)


def _inputs(world, dtype):
    dt = getattr(torch, dtype)
    return np.stack([rank_data(r, world, dt).float().numpy()
                     for r in range(world)])


def test_group_is_gloo_with_rank_and_world(world_results):
    world, res = world_results
    assert [r["backend"] for r in res] == ["gloo"] * world
    assert [r["rank"] for r in res] == list(range(world))
    assert {r["world"] for r in res} == {world}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", ["SUM", "AVG", "MAX", "MIN", "PRODUCT"])
def test_all_reduce(world_results, op, dtype):
    world, res = world_results
    x = _inputs(world, dtype)
    want = {"SUM": x.sum(0), "AVG": x.mean(0), "MAX": x.max(0),
            "MIN": x.min(0), "PRODUCT": x.prod(0)}[op]
    for r in res:
        np.testing.assert_allclose(r[f"all_reduce_{op}_{dtype}"], want,
                                   rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_all_gather(world_results, dtype):
    world, res = world_results
    want = _inputs(world, dtype).reshape(-1, 2)
    for r in res:
        np.testing.assert_array_equal(r[f"all_gather_{dtype}"], want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", ["SUM", "AVG"])
def test_reduce_scatter(world_results, op, dtype):
    world, res = world_results
    x = _inputs(world, dtype)
    total = x.sum(0) if op == "SUM" else x.mean(0)
    for rank, r in enumerate(res):
        np.testing.assert_allclose(r[f"reduce_scatter_{op}_{dtype}"],
                                   total[rank * 3:(rank + 1) * 3],
                                   rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_all_to_all_and_broadcast(world_results, dtype):
    world, res = world_results
    x = _inputs(world, dtype)
    for rank, r in enumerate(res):
        want = np.concatenate([x[src, rank * 3:(rank + 1) * 3]
                               for src in range(world)])
        np.testing.assert_array_equal(r[f"all_to_all_{dtype}"], want)
        np.testing.assert_array_equal(r[f"broadcast_{dtype}"], x[world - 1])


def test_in_place_gather_and_host_helpers(world_results):
    world, res = world_results
    want = np.repeat(np.arange(1, world + 1, dtype=np.float32), 4)
    for r in res:
        np.testing.assert_array_equal(r["all_gather_in_place"], want)
        assert r["host_scalar"] == sum(k + 0.5 for k in range(world))
        np.testing.assert_array_equal(
            r["host_array"],
            np.stack([np.arange(3) * (k + 1) for k in range(world)]))


def test_comms_logger_counts_and_bytes(world_results):
    """Each op's calls and per-rank message bytes (a reduce-scatter's is
    its output chunk); the host helpers bypass the logger."""
    world, res = world_results
    n = world * 3 * 2                      # elements of one input
    per = {"float32": 4, "bfloat16": 2}
    calls = {"all_reduce": (5, n), "all_gather": (1, n),
             "reduce_scatter": (2, n // world), "all_to_all": (1, n),
             "broadcast": (1, n)}
    for r in res:
        log = r["log"]
        for op, (k, elems) in calls.items():
            extra = (1, 4) if op == "all_gather" else (0, 0)
            assert log[op]["count"] == 2 * k + extra[0], op
            assert log[op]["bytes"] == (k * elems * sum(per.values())
                                        + extra[1] * 4), op
            assert log[op]["ms"] >= 0
        assert set(log) == set(calls)


@pytest.mark.parametrize("op", ["all_reduce", "all_gather", "reduce_scatter",
                                "all_to_all", "broadcast"])
def test_bandwidth_formulas_match_jax(op):
    for n, size, dur in ((2, 4096, 1e-3), (4, 1 << 20, 2.5e-4)):
        assert calc_bw_log(op, size, dur, n) == pytest.approx(
            jax_calc_bw_log(op, size, dur, n))


def test_without_a_group_collectives_are_the_identity():
    assert not comm.is_initialized()
    assert (comm.get_rank(), comm.get_world_size()) == (0, 1)
    x = torch.arange(6.0).view(3, 2)
    for fn in (comm.all_reduce, comm.all_gather, comm.reduce_scatter,
               comm.all_to_all, comm.broadcast):
        assert torch.equal(fn(x.clone()), x)
    assert comm.host_all_reduce_scalar(2.5) == 2.5
    np.testing.assert_array_equal(comm.host_all_gather_array([1, 2]),
                                  [[1, 2]])
    with pytest.raises(ValueError, match="unsupported device"):
        comm.init_distributed("meta", init_method="file:///nonexistent")
