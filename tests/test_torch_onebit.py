"""The 1-bit optimizers and their compressed exchange on the CPU, against
the JAX package, at worlds 2 and 4 over gloo.

* ``comm/compressed.py``: the same per-rank vectors (numpy, from a seed)
  through JAX's ``compressed_allreduce_flat`` under ``shard_map`` on a
  W-device mesh and through the port at W 2 and 4, six steps of error
  feedback: the first step's codes equal JAX's bit for bit, and the codes,
  the mean and both residuals stay within the bound stated at ``ULPS``
  (XLA fuses the residual's multiply-subtract). Error feedback drives the long-run
  mean to the true one; padding and unpadding.
* ``onebitadam``, ``onebitlamb`` and ``zerooneadam`` (``tiny``, fp32,
  freeze_step 2, stages 0 and 1) against the JAX engine built on a mesh of
  the first W CPU devices (the trajectories depend on the world, since each
  rank quantizes its own grads): losses rtol 1e-4; final params atol 1e-4
  but for the rare elements whose code took its neighbour (at most 0.1% of
  them, each within lr a compressed step).
  Within the port the warm-up steps equal dense AdamW / LAMB bit for bit,
  and stage 1 equals stage 0.
* ``zero_one_var_step`` equals JAX's over steps 0-5000; the refusals (stage
  2 and 3, with offload, zerooneadam in fp16) raise naming themselves.
* ``comm/benchmark.py`` at world 2: one row an (op, size), its bandwidths
  those of ``calc_bw_log``.

Each world is one spawn (``torch_dist_workers.onebit_runs``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import deepspeed_tpu
from deepspeed_tpu.comm.compressed import (
    compressed_allreduce_flat as jax_exchange, _quantize as jax_quantize)
from deepspeed_tpu.config.config import ParallelConfig
from deepspeed_tpu.models.presets import create_model as jax_create_model
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu.runtime.optimizer import (
    zero_one_var_step as jax_zero_one_var_step)
from deepspeed_tpu.utils.compat import shard_map
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.comm import calc_bw_log
from deepspeed_tpu_torch.comm.benchmark import OPS
from deepspeed_tpu_torch.comm.compressed import (compressed_allreduce_flat,
                                                 pad_to, padded_length)
from deepspeed_tpu_torch.models import create_model
from deepspeed_tpu_torch.runtime.optimizer import zero_one_var_step
from torch_dist_workers import (GLOBAL_ROWS, SEQ, exchange_vectors,
                                onebit_runs, spawn, token_batches)

STEPS = 6
BASE = {"steps_per_print": 1000}


def _opt(kind, **params):
    return dict(BASE, optimizer={"type": kind, "params": dict(
        {"lr": 2e-3, "weight_decay": 0.01}, **params)})


CASES = {
    "onebitadam": dict(model="tiny", dtype="float32", stages=(0, 1),
                       config=_opt("onebitadam", freeze_step=2)),
    "onebitlamb": dict(model="tiny", dtype="float32", stages=(0, 1),
                       config=_opt("onebitlamb", freeze_step=2)),
    "zerooneadam": dict(model="tiny", dtype="float32", stages=(0, 1),
                        config=_opt("zerooneadam", freeze_step=2,
                                    var_update_scaler=2)),
    # the dense runs the warm-up steps must equal
    "adamw": dict(model="tiny", dtype="float32", stages=(0,),
                  config=_opt("adamw")),
    "lamb": dict(model="tiny", dtype="float32", stages=(0,),
                 config=_opt("lamb")),
}
ONEBIT = ("onebitadam", "onebitlamb", "zerooneadam")


def _jax_exchange(world, steps):
    """JAX's exchange over the first ``world`` CPU devices, with error
    feedback: per step the codes of each rank's first quantization, the
    mean (rank 0's) and both residuals."""
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))

    def body(v, w, s):
        q = jax_quantize(v[0] + w[0])[0]
        out, w2, s2 = jax_exchange(v[0], w[0], s, "data")
        return q[None], out[None], w2[None], s2

    fn = jax.jit(shard_map(body, mesh=mesh,
                           in_specs=(P("data"), P("data"), P("data")),
                           out_specs=(P("data"), P("data"), P("data"),
                                      P("data")), check_vma=False))
    vecs = exchange_vectors(world, 96, steps)
    worker = jnp.zeros((world, 96), jnp.float32)
    server = jnp.zeros((96,), jnp.float32)
    out = {"codes": [], "mean": [], "worker": [], "server": []}
    for v in vecs:
        q, mean, worker, server = fn(jnp.asarray(v), worker, server)
        for k, a in (("codes", q), ("mean", mean), ("worker", worker),
                     ("server", server)):
            out[k].append(np.asarray(a))
    return out


def _jax_run(name, world):
    case = CASES[name]
    cfg = dict(case["config"], train_micro_batch_size_per_gpu=(
        GLOBAL_ROWS // world), zero_optimization={"stage": 0})
    model = jax_create_model("tiny", dtype=jnp.float32, max_seq_len=SEQ)
    mesh = build_mesh(ParallelConfig(data_parallel_size=world),
                      devices=jax.devices()[:world])
    eng, *_ = deepspeed_tpu.initialize(model=model, config=cfg, mesh=mesh)
    init = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jax.device_get(eng.params))
    losses = [float(eng.train_batch(batch=jax.tree.map(jnp.asarray, b)))
              for b in token_batches(STEPS, 1, seed=3)]
    return init, {"losses": losses, "params": jax.tree.map(
        lambda a: np.asarray(a, np.float32), jax.device_get(eng.params))}


@pytest.fixture(scope="module")
def runs():
    jax_out, init = {}, None
    for world in (2, 4):
        jax_out[(world, "exchange")] = _jax_exchange(world, 6)
        for name in ONEBIT:
            init, jax_out[(world, name)] = _jax_run(name, world)
    port = {}
    for world in (2, 4):
        res = spawn(onebit_runs, world, CASES, init, STEPS, world == 2)
        port[world] = res
    return {"jax": jax_out, "port": port, "init": init}


# ---------------------------------------------------------------------------
# the exchange
# ---------------------------------------------------------------------------

# XLA contracts the residual ``v - q * scale`` and the decode's products
# into fused multiply-adds, so there each product is not rounded on its own;
# the port rounds it (also on CUDA, where the compiler may contract instead:
# see the card test). So the first step's codes are equal and its floats
# differ by a rounding of a product: ULPS units in the last place of the
# largest input of that quantization (a residual is the small difference
# of two such numbers). Later steps start from those residuals, and an element
# within that rounding of the boundary between two codes may take the
# neighbouring code: codes then differ by at most one, and the floats by at
# most one code step of their quantization (its scale, max|input| / 127)
ULPS = 4


def _hold_exchange(got, want, rank, world, vecs):
    chunk = 96 // world
    worker_in = np.zeros(96, np.float32)
    server_in = np.zeros(chunk, np.float32)
    for step in range(6):
        gw, ww = got["worker"][step], want["worker"][step][rank]
        gs = got["server"][step]
        ws = want["server"][step][rank * chunk:(rank + 1) * chunk]
        gm, wm = got["mean"][step], want["mean"][step][rank]
        dq = np.abs(got["codes"][step].astype(int)
                    - want["codes"][step][rank].astype(int))
        if step == 0:
            assert dq.max() == 0
            big_in = np.abs(vecs[step][rank]).max()
            big_sum = world * np.abs(wm).max()
            for a, b, big in ((gw, ww, big_in), (gs, ws, big_sum),
                              (gm, wm, np.abs(wm).max())):
                np.testing.assert_allclose(
                    a, b, rtol=0, atol=ULPS * np.spacing(np.float32(big)))
        else:
            assert dq.max() <= 1
            # one code step of each quantization the value went through
            worker_step = np.abs(vecs[step][rank] + worker_in).max() / 127
            mean_step = 2 * np.abs(wm).max() / 127
            assert np.abs(gw - ww).max() <= 1.01 * worker_step
            assert np.abs(gm - wm).max() <= 1.01 * mean_step
            assert np.abs(gs - ws).max() <= 1.01 * world * mean_step
        worker_in, server_in = ww, ws


@pytest.mark.parametrize("world", [2, 4])
def test_exchange_matches_jax(runs, world):
    """Six steps of the exchange with error feedback, the same inputs at
    both packages: codes, means and residuals within the bound above (the
    codes of the first step bit for bit); the port divides by the scale as
    a tensor, so that CUDA keeps it a division."""
    want = runs["jax"][(world, "exchange")]
    vecs = exchange_vectors(world, 96, 6)
    for rank, got in enumerate(r["exchange"] for r in runs["port"][world]):
        _hold_exchange(got, want, rank, world, vecs)


def test_exchange_approximates_the_mean(runs):
    vecs = exchange_vectors(4, 96, 1)[0]
    got = runs["port"][4][0]["exchange"]["mean"][0]
    for r in runs["port"][4]:
        np.testing.assert_array_equal(r["exchange"]["mean"][0], got)
    err = np.abs(got - vecs.mean(0)).max()
    assert err < 2.5 * np.abs(vecs).max() / 127, err


def test_error_feedback_accumulates():
    """One rank, a constant input: the residuals drive the long-run average
    of the outputs toward the input (JAX ``test_error_feedback_
    accumulates``)."""
    v = torch.from_numpy(np.random.RandomState(1).randn(64).astype(
        np.float32))
    worker, server = torch.zeros(64), torch.zeros(64)
    outs = []
    for _ in range(30):
        out, worker, server = compressed_allreduce_flat(v, worker, server)
        outs.append(out)
    avg = torch.stack(outs).mean(0)
    direct = float((outs[0] - v).abs().max())
    assert direct > 0
    assert float((avg - v).abs().max()) < 0.5 * direct


def test_padding_and_unpadding():
    flat = torch.arange(11, dtype=torch.float32)
    padded = pad_to(flat, 8)
    assert padded.numel() == padded_length(11, 8) == 16
    torch.testing.assert_close(padded[:11], flat, rtol=0, atol=0)
    assert float(padded[11:].abs().sum()) == 0
    assert pad_to(padded, 8) is padded
    back = padded[:11]
    torch.testing.assert_close(back, flat, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ONEBIT)
@pytest.mark.parametrize("world", [2, 4])
def test_onebit_matches_jax(runs, name, world):
    want = runs["jax"][(world, name)]
    for stage in CASES[name]["stages"]:
        got = runs["port"][world][0][(name, stage)]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4,
                                   err_msg=f"stage {stage}")
        # params: within 1e-4 but where a code took its neighbour (see
        # ULPS): such an element took another step at each compressed
        # step, at most lr a step in these updates, and they are rare
        lr = CASES[name]["config"]["optimizer"]["params"]["lr"]
        far = total = 0
        for a, b in zip(jax.tree.leaves(got["params"]),
                        jax.tree.leaves(want["params"])):
            diff = np.abs(a - b)
            assert diff.max() <= lr * (STEPS - 2), name
            far += int((diff > 1e-4).sum())
            total += diff.size
        assert far <= 1e-3 * total, (name, far, total)


@pytest.mark.parametrize("world", [2, 4])
def test_warmup_equals_dense_and_stage1_equals_stage0(runs, world):
    port = runs["port"][world][0]
    for name, dense in (("onebitadam", "adamw"), ("onebitlamb", "lamb")):
        got, ref = port[(name, 0)]["losses"], port[(dense, 0)]["losses"]
        # losses 0-2 come from the initial params and the 2 dense steps
        assert got[:3] == ref[:3], name
        assert got[3:] != ref[3:], name
    for name in ONEBIT:
        a, b = port[(name, 1)], port[(name, 0)]
        if name == "onebitlamb":
            # stage 1 sums each leaf's norms over the ranks' parts
            np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-5)
            jax.tree.map(lambda x, y: np.testing.assert_allclose(
                x, y, atol=1e-5), a["params"], b["params"])
            continue
        assert a["losses"] == b["losses"], name
        jax.tree.map(np.testing.assert_array_equal, a["params"], b["params"])


def test_zero_one_var_step_matches_jax():
    counts = np.arange(5001)
    for scaler, freeze in ((16, 100000), (3, 2000), (2, 40)):
        want = np.asarray(jax.jit(jax.vmap(
            lambda c: jax_zero_one_var_step(c, scaler, freeze)))(
                jnp.asarray(counts)))
        got = np.asarray([zero_one_var_step(int(c), scaler, freeze)
                          for c in counts])
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("extra,what", [
    ({"zero_optimization": {"stage": 2}}, "stage 2"),
    ({"zero_optimization": {"stage": 3}}, "stage 3"),
    ({"zero_optimization": {"offload_optimizer": {"device": "cpu"}}},
     "offload_optimizer with optimizer 'onebitadam'"),
])
def test_onebit_refusals_raise(extra, what):
    model = create_model("tiny", dtype=torch.float32)
    cfg = dict(_opt("onebitadam"), train_micro_batch_size_per_gpu=2, **extra)
    with pytest.raises(NotImplementedError, match=what):
        initialize(model=model, config=cfg, device="cpu")


def test_zerooneadam_fp16_refused():
    model = create_model("tiny", dtype=torch.float16)
    cfg = dict(_opt("zerooneadam"), train_micro_batch_size_per_gpu=2,
               fp16={"enabled": True})
    with pytest.raises(NotImplementedError, match="zerooneadam' with fp16"):
        initialize(model=model, config=cfg, device="cpu")


def test_onebit_at_world_1_runs_the_exchange():
    """World 1: the exchange is a copy, but after freeze_step the codes and
    the error feedback change the trajectory; before it they do not."""
    model = create_model("tiny", dtype=torch.float32, max_seq_len=SEQ)
    losses = {}
    for name in ("onebitadam", "adamw"):
        eng = initialize(model=model, config=dict(
            CASES[name]["config"], train_micro_batch_size_per_gpu=2),
            device="cpu")[0]
        losses[name] = [float(eng.train_batch(batch={
            "input_ids": b["input_ids"][:, :2]}))
            for b in token_batches(5, 1, seed=3)]
        if name == "onebitadam":
            worker = eng._onebit["worker"]
    assert losses["onebitadam"][:3] == losses["adamw"][:3]
    assert losses["onebitadam"][3:] != losses["adamw"][3:]
    assert float(worker.abs().max()) > 0


# ---------------------------------------------------------------------------
# the collective sweep
# ---------------------------------------------------------------------------

def test_comm_benchmark_rows_at_world_2(runs):
    rows = runs["port"][2][0]["bench"]
    assert [(r["op"], r["msg_bytes"]) for r in rows] == [
        (op, size) for op in OPS for size in (1024, 2048)]
    for r in rows:
        assert r["world"] == 2 and r["latency_ms"] > 0
        _, algbw, busbw = calc_bw_log(r["op"] if r["op"] != "pt2pt"
                                      else "p2p", r["msg_bytes"],
                                      r["latency_ms"] / 1e3, 2)
        np.testing.assert_allclose([r["algbw_gbps"], r["busbw_gbps"]],
                                   [algbw, busbw], rtol=1e-12)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_zerooneadam_checkpoint_has_jax_keys_and_loads_into_jax(tmp_path):
    """The port writes 0/1 Adam's state under the JAX chain's keys (count,
    mu and nu of element 0, the schedule's count of element 1); the JAX
    engine loads the checkpoint and holds the same params and moments."""
    from deepspeed_tpu_torch.models import params_to_numpy

    cfg = dict(CASES["zerooneadam"]["config"],
               train_micro_batch_size_per_gpu=GLOBAL_ROWS)
    peng = initialize(model=create_model("tiny", dtype=torch.float32,
                                         max_seq_len=SEQ),
                      config=cfg, device="cpu")[0]
    for b in token_batches(2, 1, seed=3):
        peng.train_batch(batch=b)
    path = peng.save_checkpoint(str(tmp_path), tag="step2")
    with open(f"{path}/metadata.json") as fh:
        keys = set(__import__("json").load(fh)["arrays"])
    for key in ("opt##inner##0##count", "opt##inner##1##count",
                "opt##count", "opt##inner##0##mu##layers##attn##wq",
                "opt##inner##0##nu##layers##attn##wq"):
        assert key in keys, key
    jcfg = dict(cfg, train_micro_batch_size_per_gpu=1)
    jeng, *_ = deepspeed_tpu.initialize(
        model=jax_create_model("tiny", dtype=jnp.float32, max_seq_len=SEQ),
        config=jcfg)
    jeng.load_checkpoint(str(tmp_path), tag="step2")
    jax.tree.map(np.testing.assert_array_equal,
                 params_to_numpy(peng.params), jax.device_get(jeng.params))
    inner = jax.device_get(jeng.opt_state.inner[0])
    assert int(inner["count"]) == 2
    for name, buf in (("mu", peng.opt_state.exp_avg),
                      ("nu", peng.opt_state.exp_avg_sq)):
        jax.tree.map(np.testing.assert_array_equal,
                     params_to_numpy(peng.zero.full_tree(buf)), inner[name])
