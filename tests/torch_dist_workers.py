"""Process-group workers for the port's multi-process tests on the CPU.

``spawn(fn, world, *args)`` starts ``world`` processes, each of which joins a
gloo group through a ``file://`` store in a temporary directory (no TCP port,
so tests can run side by side) with a collective timeout, runs ``fn(rank,
world, *args)`` and sends back its result; a process that does not finish
within ``timeout`` seconds is killed and the call raises. This module
imports torch and the port only: the spawned children import it, and never
JAX.
"""

from __future__ import annotations

import os
import queue
import shutil
import tempfile
import traceback
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.multiprocessing as mp

SEQ = 32
GLOBAL_ROWS = 8
COLLECTIVE_TIMEOUT_S = 60


def spawn(fn, world: int, *args, timeout: float = 240) -> List[Any]:
    """Rank order results of ``fn(rank, world, *args)`` over a gloo group of
    ``world`` processes."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store_dir = tempfile.mkdtemp(prefix="gloo-")
    store = os.path.join(store_dir, "store")
    procs = [ctx.Process(target=_run, args=(fn, r, world, store, q, args),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    results: Dict[int, Any] = {}
    errors = []
    try:
        for _ in range(world):
            rank, ok, out = q.get(timeout=timeout)
            (results.__setitem__(rank, out) if ok
             else errors.append(f"rank {rank}:\n{out}"))
    except queue.Empty:
        errors.append(f"no result within {timeout}s from ranks "
                      f"{sorted(set(range(world)) - set(results))}")
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(store_dir, ignore_errors=True)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [results[r] for r in range(world)]


def _run(fn, rank, world, store, q, args):
    from deepspeed_tpu_torch import comm

    torch.set_num_threads(1)
    try:
        comm.init_distributed("cpu", init_method=f"file://{store}",
                              rank=rank, world_size=world,
                              timeout=COLLECTIVE_TIMEOUT_S, verbose=False)
        q.put((rank, True, fn(rank, world, *args)))
    except BaseException:
        q.put((rank, False, traceback.format_exc()))
    finally:
        comm.destroy_process_group()


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def rank_data(rank: int, world: int, dtype=torch.float32) -> torch.Tensor:
    """Rank ``rank``'s input to every collective test: (world * 3, 2)."""
    rng = np.random.default_rng(100 + rank)
    return torch.tensor(rng.normal(size=(world * 3, 2)), dtype=dtype)


def collectives(rank: int, world: int) -> Dict[str, Any]:
    import torch.distributed as dist

    from deepspeed_tpu_torch import comm

    out: Dict[str, Any] = {"backend": dist.get_backend(),
                           "rank": comm.get_rank(),
                           "world": comm.get_world_size()}
    clog = comm.configure_comms_logger(world_size=world)
    clog.enabled, clog.prof_all = True, True
    clog.reset()
    for dt in (torch.float32, torch.bfloat16):
        key = str(dt).split(".")[1]
        x = rank_data(rank, world, dt)
        for op in ("SUM", "AVG", "MAX", "MIN", "PRODUCT"):
            out[f"all_reduce_{op}_{key}"] = comm.all_reduce(
                x.clone(), op=comm.ReduceOp[op]).float().numpy()
        out[f"all_gather_{key}"] = comm.all_gather(x).float().numpy()
        for op in ("SUM", "AVG"):
            out[f"reduce_scatter_{op}_{key}"] = comm.reduce_scatter(
                x, op=comm.ReduceOp[op]).float().numpy()
        out[f"all_to_all_{key}"] = comm.all_to_all(x).float().numpy()
        out[f"broadcast_{key}"] = comm.broadcast(x.clone(), src=world - 1
                                                 ).float().numpy()
    buf = torch.zeros(world * 4)
    buf[rank * 4:(rank + 1) * 4] = rank + 1
    out["all_gather_in_place"] = comm.all_gather(
        buf[rank * 4:(rank + 1) * 4], out=buf).numpy()
    out["host_scalar"] = comm.host_all_reduce_scalar(rank + 0.5)
    out["host_array"] = comm.host_all_gather_array(np.arange(3) * (rank + 1))
    out["log"] = clog.summary()
    clog.enabled = False
    return out


# ---------------------------------------------------------------------------
# training under ZeRO
# ---------------------------------------------------------------------------

def token_batches(steps: int, gas: int, seed: int = 0) -> List[Dict]:
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 250, (gas, GLOBAL_ROWS, SEQ))}
            for _ in range(steps)]


def regression_batches(steps: int, seed: int = 0) -> List[Dict]:
    from deepspeed_tpu_torch.models.simple import random_batches

    return [{k: v[None] for k, v in b.items()}
            for b in random_batches(seed, steps, GLOBAL_ROWS)]


def port_model(case: Dict[str, Any], init: Any):
    """The case's model, whose init is ``init`` (the JAX init, numpy)."""
    from deepspeed_tpu_torch.models import (Model, create_model,
                                            params_from_jax)
    from deepspeed_tpu_torch.models.simple import simple_model

    dtype = {"float32": torch.float32, "float16": torch.float16,
             "bfloat16": torch.bfloat16}[case["dtype"]]
    if case["model"] == "simple":
        return simple_model(params=init, dtype=dtype)
    model = create_model(case["model"], dtype=dtype, max_seq_len=SEQ,
                         **case.get("model_kw", {}))
    return Model(init=lambda g: params_from_jax(init, model.config,
                                                device=g.device),
                 config=model.config, name=model.name,
                 loss_fn=model.loss_fn, eval_loss_fn=model.eval_loss_fn)


def case_config(case: Dict[str, Any], world: int, stage: int) -> Dict:
    cfg = dict(case["config"])
    cfg["train_micro_batch_size_per_gpu"] = GLOBAL_ROWS // world
    cfg["zero_optimization"] = dict(cfg.get("zero_optimization", {}),
                                    stage=stage)
    return cfg


def memory_stats(engine) -> Dict[str, Any]:
    """What the rank holds between steps."""
    part, zero, st = engine.partition, engine.zero, engine.opt_state
    return {
        "units": [(u.name, u.numel, u.chunk, u.gathered) for u in part.units],
        "shard": part.shard_numel,
        "buffers": {name: int(t.numel()) for name, t in (
            ("shard_param", zero.shard), ("exp_avg", st.exp_avg),
            ("exp_avg_sq", st.exp_avg_sq), ("acc", zero.acc),
            ("master", st.master)) if t is not None},
        "whole": {part.units[i].name: int(t.numel())
                  for i, t in zero.full.items()},
        "grad_bytes": sum(g.untyped_storage().nbytes()
                          for g in zero.grad_full.values()),
        "live": zero.live, "peak_live": zero.peak_live}


def train_case(case: Dict[str, Any], init: Any, world: int, stage: int,
               batches: List[Dict]) -> Dict[str, Any]:
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models import params_to_numpy

    eng = initialize(model=port_model(case, init),
                     config=case_config(case, world, stage), device="cpu")[0]
    norms = []
    apply = eng.optimizer.apply

    def recording(*args, **kw):
        # the global grad norm each step clips by (the optimizer's stats)
        stats = apply(*args, **kw)
        norms.append(float(stats.grad_norm))
        return stats

    eng.optimizer.apply = recording
    losses, scales = [], []
    for b in batches:
        losses.append(float(eng.train_batch(batch=b)))
        scales.append(eng.cur_scale)
    return {"losses": losses, "scales": scales,
            "skipped": eng.skipped_steps, "grad_norms": norms,
            "params": params_to_numpy(eng.params),
            "memory": memory_stats(eng)}


def train_worker(rank: int, world: int, case: Dict[str, Any], init: Any,
                 stage: int, batches: List[Dict]) -> Dict[str, Any]:
    """``train_case`` on every rank of a spawned group."""
    return train_case(case, init, world, stage, batches)


def zero_runs(rank: int, world: int, cases: Dict[str, Dict],
              inits: Dict[str, Any], ckpt: Dict[str, Any]) -> Dict:
    """Every case of ``cases`` whose ``worlds`` include ``world``, at each
    of its stages; then the checkpoint step: save (``ckpt["save_world"]``)
    or load (``ckpt["load_world"]``)."""
    out: Dict[str, Any] = {}
    for name, case in cases.items():
        if world not in case["worlds"]:
            continue
        batches = (regression_batches(case["steps"])
                   if case["model"] == "simple"
                   else token_batches(case["steps"], case["gas"]))
        for stage in case["stages"]:
            out[(name, stage)] = train_case(case, inits[name], world, stage,
                                            batches)
    out["checkpoint"] = checkpoint_step(rank, world, cases[ckpt["case"]],
                                        inits[ckpt["case"]], ckpt)
    return out


def checkpoint_step(rank, world, case, init, ckpt) -> Dict[str, Any]:
    """At ``save_world``: train 2 steps at ``save_stage``, save, take a
    third step. At ``load_world``: load at ``load_stage`` and take the third
    step. Returns the loaded / saved params, the counters and the third
    loss."""
    saving = world == ckpt["save_world"]
    stage = ckpt["save_stage"] if saving else ckpt["load_stage"]
    return checkpoint_case(case, init, world, stage, ckpt["dir"], "step2",
                           saving)


def checkpoint_case(case, init, world, stage, directory, tag, save
                    ) -> Dict[str, Any]:
    """``save``: train 2 steps, save as ``tag``, take a third step; else
    load ``tag`` and take the third step. Returns the params saved or
    loaded (whole), the counters, the shards' problems and the third
    step's loss and params."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models import params_to_numpy
    from deepspeed_tpu_torch.models.core import tree_map
    from deepspeed_tpu_torch.runtime.checkpoint import verify_checkpoint

    batches = token_batches(3, case["gas"], seed=5)
    eng = initialize(model=port_model(case, init),
                     config=case_config(case, world, stage), device="cpu")[0]
    if save:
        for b in batches[:2]:
            eng.train_batch(batch=b)
        eng.save_checkpoint(directory, tag=tag)
    else:
        eng.load_checkpoint(directory, tag=tag)
    # a copy: on the CPU the arrays would alias the params the next step
    # updates in place
    state = {"params": tree_map(np.copy, params_to_numpy(eng.params)),
             "global_steps": eng.global_steps, "count": eng.opt_state.count,
             "problems": verify_checkpoint(directory, tag)}
    state["loss3"] = float(eng.train_batch(batch=batches[2]))
    state["params3"] = params_to_numpy(eng.params)
    return state


# ---------------------------------------------------------------------------
# the 1-bit exchange, the 1-bit optimizers and the collective sweep
# ---------------------------------------------------------------------------

def exchange_vectors(world: int, n: int, steps: int, seed: int = 11
                     ) -> List[np.ndarray]:
    """Each step's (world, n) fp32 inputs of the compressed exchange."""
    return [np.random.default_rng(seed + s).normal(
        size=(world, n)).astype(np.float32) * (1 + s)
        for s in range(steps)]


def compressed_exchange(rank: int, world: int, n: int, steps: int
                        ) -> Dict[str, Any]:
    """``steps`` exchanges with error feedback of ``exchange_vectors``:
    each step's codes of this rank's first quantization, the mean and both
    residuals."""
    from deepspeed_tpu_torch.comm.compressed import (
        _quantize, compressed_allreduce_flat)

    worker = torch.zeros(n)
    server = torch.zeros(n // world)
    out: Dict[str, Any] = {"codes": [], "mean": [], "worker": [],
                           "server": []}
    for vecs in exchange_vectors(world, n, steps):
        v = torch.from_numpy(vecs[rank])
        out["codes"].append(_quantize(v + worker)[0].numpy())
        mean, worker, server = compressed_allreduce_flat(v, worker, server)
        for k, t in (("mean", mean), ("worker", worker),
                     ("server", server)):
            out[k].append(t.numpy().copy())
    return out


def onebit_runs(rank: int, world: int, cases: Dict[str, Dict],
                init: Any, steps: int, bench: bool) -> Dict[str, Any]:
    """The exchange, every 1-bit case of ``cases`` at each of its stages
    (``train_case``), and with ``bench`` the collective sweep."""
    from deepspeed_tpu_torch.comm.benchmark import run_comm_benchmark

    out: Dict[str, Any] = {"exchange": compressed_exchange(rank, world, 96,
                                                           6)}
    batches = token_batches(steps, 1, seed=3)
    for name, case in cases.items():
        for stage in case["stages"]:
            out[(name, stage)] = train_case(case, init, world, stage,
                                            batches)
    if bench:
        out["bench"] = run_comm_benchmark(minsize_log2=10, maxsize_log2=11,
                                          trials=2, warmups=1,
                                          dtype=torch.float32, quiet=True)
    return out


def stage_runs(rank: int, world: int, cases: Dict[str, Dict],
               inits: Dict[str, Any]) -> Dict[str, Any]:
    """Every case of ``cases`` at each of its stages (``train_case``)."""
    out: Dict[str, Any] = {}
    for name, case in cases.items():
        batches = token_batches(case["steps"], case["gas"])
        for stage in case["stages"]:
            out[(name, stage)] = train_case(case, inits[name], world, stage,
                                            batches)
    return out


# ---------------------------------------------------------------------------
# optimizer-state offload
# ---------------------------------------------------------------------------

SUB_GROUP = 5000     # elements: ``tiny`` in a few dozen sub-groups


def offload_config(case: Dict[str, Any], world: int, stage: int,
                   tier: str, swap_dir: str) -> Dict:
    cfg = case_config(case, world, stage)
    zero = dict(cfg["zero_optimization"], sub_group_size=SUB_GROUP)
    if tier != "none":
        zero["offload_optimizer"] = {"device": tier, "nvme_path": swap_dir}
    cfg["zero_optimization"] = zero
    return cfg


def offload_state(eng) -> Dict[str, np.ndarray]:
    """The rank's master and moments over its shard, wherever they live
    (the params widened for the master of resident fp32 params)."""
    st = eng.opt_state
    if st.exp_avg is None:
        return {k: v.numpy() for k, v in st.offload.read_state(
            st.n).items()}
    master = st.master if st.master is not None else st.shard_param
    return {"master": master.detach().float().cpu().numpy().copy(),
            "exp_avg": st.exp_avg.cpu().numpy().copy(),
            "exp_avg_sq": st.exp_avg_sq.cpu().numpy().copy()}


def offload_case(case: Dict[str, Any], init: Any, world: int, stage: int,
                 tier: str, swap_dir: str) -> Dict[str, Any]:
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models import params_to_numpy
    from deepspeed_tpu_torch.models.core import tree_map

    eng = initialize(model=port_model(case, init),
                     config=offload_config(case, world, stage, tier,
                                           swap_dir), device="cpu")[0]
    losses, scales = [], []
    for b in token_batches(case["steps"], case["gas"]):
        losses.append(float(eng.train_batch(batch=b)))
        scales.append(eng.cur_scale)
    st = eng.opt_state
    out = {"losses": losses, "scales": scales, "skipped": eng.skipped_steps,
           "params": tree_map(np.copy, params_to_numpy(eng.params)),
           "state": offload_state(eng),
           "state_device": (None if st.exp_avg is None
                            else str(st.exp_avg.device)),
           "shard_offsets": list(eng.partition.shard_offsets)}
    if tier == "nvme":
        import json

        sw = st.offload
        with open(os.path.join(sw.swap_dir, "manifest.json")) as fh:
            manifest = json.load(fh)
        out.update(peak_live_groups=sw.peak_live_groups,
                   groups=len(sw.groups),
                   sets=sum(s is not None for s in sw._sets),
                   group_sizes=list(sw.group_sizes), manifest=manifest)
        sw.close(remove=True)
    elif tier == "cpu":
        out["group_spans"] = [list(g) for g in st.offload.groups]
    return out


def offload_runs(rank: int, world: int, cases: Dict[str, Dict],
                 inits: Dict[str, Any], swap_root: str) -> Dict[str, Any]:
    """Every case of ``cases`` whose ``worlds`` include ``world``, at each
    of its stages and tiers."""
    out: Dict[str, Any] = {}
    for name, case in cases.items():
        if world not in case["worlds"]:
            continue
        for stage in case["stages"]:
            for tier in case["tiers"]:
                out[(name, stage, tier)] = offload_case(
                    case, inits[name], world, stage, tier,
                    os.path.join(swap_root, f"{name}-{stage}-{world}"))
    return out


def param_offload_refusal(rank: int, world: int) -> str:
    """What ``initialize`` raises for parameter offload at this world."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models import create_model

    cfg = {"train_micro_batch_size_per_gpu": GLOBAL_ROWS // world,
           "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
           "zero_optimization": {"stage": 3,
                                 "offload_param": {"device": "cpu"}}}
    try:
        initialize(model=create_model("tiny", max_seq_len=SEQ), config=cfg,
                   device="cpu")
    except NotImplementedError as e:
        return f"NotImplementedError: {e}"
    return "accepted"


# ---------------------------------------------------------------------------
# MoE beyond one rank
# ---------------------------------------------------------------------------

def moe_plan_rows(rank: int, world: int, logits: np.ndarray, top_k: int,
                  capacity_factor: float, use_rts: bool = False
                  ) -> Dict[str, Any]:
    """This rank's rows of the global plan over ``logits`` ((world * T, E)
    fp32; the rank is given rows ``[rank * T, (rank + 1) * T)``), and the
    grad its rows get from the aux loss (every rank's copy of it summed).
    With ``use_rts`` (Random Token Selection, no generator passed) also
    whether a second plan of the same rows keeps the same tokens."""
    from deepspeed_tpu_torch.parallel.moe import global_plan
    from deepspeed_tpu_torch.parallel.topology import Topology, build_groups

    T = logits.shape[0] // world
    groups = build_groups(Topology(world, 1, rank))
    x = torch.tensor(logits[rank * T:(rank + 1) * T], requires_grad=True)
    plan = global_plan(x, top_k, capacity_factor, use_rts=use_rts,
                       groups=groups)
    plan.aux_loss.backward()
    out = {k: getattr(plan, k).detach().numpy().copy() for k in (
        "expert_idx", "slot_pos", "weight", "valid", "aux_loss",
        "expert_counts")}
    out.update(capacity=plan.capacity, aux_grad=x.grad.numpy().copy())
    if use_rts:
        again = global_plan(x.detach(), top_k, capacity_factor,
                            use_rts=True, groups=groups)
        out["same_again"] = bool(torch.equal(again.valid, plan.valid))
    return out


def moe_eval(case: Dict[str, Any], init: Any, world: int) -> float:
    """The eval loss of a global batch (``GLOBAL_ROWS`` rows) at the
    init."""
    from deepspeed_tpu_torch import initialize

    eng = initialize(model=port_model(case, init),
                     config=case_config(case, world, 0), device="cpu")[0]
    return float(eng.eval_loss({"input_ids": token_batches(1, 1, seed=7)[0][
        "input_ids"][0]}))


def moe_ep_runs(rank: int, world: int, cases: Dict[Any, Dict],
                inits: Dict[str, Any], plans: List[Tuple],
                evals: Dict[str, Dict], checkpoints: List[Tuple]
                ) -> Dict[Any, Any]:
    """The global plans of ``plans`` ((logits, top_k, capacity factor[,
    use_rts])),
    every case of ``cases`` (keyed (variant, ep, stage), ``train_case``),
    the eval losses of ``evals`` (variant ``top2``), and the
    ``checkpoints`` steps in order: (key, case, variant, stage, directory,
    tag, save)."""
    out: Dict[Any, Any] = {}
    for i, (logits, k, cf, *rts) in enumerate(plans):
        out[("plan", i)] = moe_plan_rows(rank, world, logits, k, cf, *rts)
    for name, case in evals.items():
        out[("eval", name)] = moe_eval(case, inits["top2"], world)
    for key, case in cases.items():
        batches = token_batches(case["steps"], case["gas"])
        out[key] = train_case(case, inits[key[0]], world, key[2], batches)
    for key, case, variant, stage, directory, tag, save in checkpoints:
        out[key] = checkpoint_case(case, inits[variant], world, stage,
                                   directory, tag, save)
    return out
