#!/usr/bin/env python3
"""Read the measures of ``chip_smoke.py``'s e2e_sparse_train_parity phase
(``chip_smoke.train_parity``) with faults planted in the kernel path's LAMB,
beside sound runs at several seeds: where the update limit of
``E2E_SPARSE_TRAIN_TOL`` sits between them.

    python3 scripts/lamb_parity_faults.py [--device cpu] [--preset tiny-opt]

Each run trains ``chip_smoke.sparse_parity_inputs``' model (OPT-1.3B's
widths at 2 layers by default, fp32, S 512, the Fixed layout, LAMB lr 1e-3,
weight decay 0.01, clipping 1.0) 3 steps through the kernel path and the
plain path:

* ``sound`` at seeds 7, 8 and 9 (weights and batch);
* at seed 7, one fault each, planted in the kernel path's optimizer only
  (the plain path runs ``lamb_step(..., plain=True)`` as it is):
  ``per_layer_ratio``: one trust ratio per layer of a stacked leaf, where
  optax.lamb takes one per (stacked) leaf; ``clamp``: the ratio clamped to
  [0.01, 10], the JAX kernel's default, where optax.lamb has no clamp;
  ``bf16_update``: phase 2 applies u rounded to bf16; ``eps_1e-6``: the
  kernel's eps default, where the engine's is optax's 1e-8.

Prints one JSON line per run (the worst update leaf overall and among the
weight matrices, the worst leaf of the optimizer-alone first step, the
worst gradient leaf, the loss difference and each leaf's update measure),
then the nvidia-smi line on the GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from deepspeed_tpu_torch.models.core import tree_leaves  # noqa: E402
from deepspeed_tpu_torch.ops import (LambSegments, lamb_phase1,  # noqa: E402
                                     lamb_phase2)
from deepspeed_tpu_torch.runtime import optimizer as opt_mod  # noqa: E402

SOUND = opt_mod.lamb_step
FAULTS = ("per_layer_ratio", "clamp", "bf16_update", "eps_1e-6")


def planted(fault: str, per_layer: dict):
    """``lamb_step`` with ``fault`` on the kernel path (``plain`` unset)."""
    def step(params, grads, m, v, u, segments, count, *, plain=False, **kw):
        if plain:
            return SOUND(params, grads, m, v, u, segments, count, plain=True,
                         **kw)
        if fault == "clamp":
            kw.update(max_coeff=10.0, min_coeff=0.01)
        elif fault == "eps_1e-6":
            kw.update(eps=1e-6)
        elif fault == "per_layer_ratio":
            segments = per_layer[segments.sizes]
        elif fault == "bf16_update":
            partials = lamb_phase1(
                params, grads, m, v, u, segments, count, kw["beta1"],
                kw["beta2"], kw["eps"], kw["weight_decay"],
                kw["bias_correction"], kw["grad_scale"], kw["skip"])
            u.copy_(u.bfloat16())
            return lamb_phase2(params, u, partials, segments, kw["lr"],
                               kw["max_coeff"], kw["min_coeff"],
                               kw["param_copy"])
        return SOUND(params, grads, m, v, u, segments, count, **kw)
    return step


def leaf_table(model, dev):
    """Names, per-layer split sizes and whether each leaf is a weight
    matrix, in the optimizer's leaf order."""
    tree = model.init(torch.Generator(device=dev))
    names = chip_smoke.leaf_names(tree)
    leaves = list(tree_leaves(tree))
    L = model.config.num_layers
    split, matrix = [], {}
    for name, t in zip(names, leaves):
        stacked = name.startswith("layers.")
        split += [t.numel() // L] * L if stacked else [t.numel()]
        matrix[name] = t.dim() - int(stacked) >= 2
    return [t.numel() for t in leaves], split, matrix


def run(dev, preset: str, seed: int, fault) -> dict:
    model, cfg, plain_opt, batch = chip_smoke.sparse_parity_inputs(
        dev, seed, preset)
    sizes, split, matrix = leaf_table(model, dev)
    opt_mod.lamb_step = (SOUND if fault is None else planted(
        fault, {tuple(sizes): LambSegments.from_sizes(split)}))
    try:
        out = chip_smoke.train_parity("lamb_parity_faults", model, cfg,
                                      plain_opt, batch, tol=None)
    finally:
        opt_mod.lamb_step = SOUND
    upd = out["update_rel_by_leaf"]
    weights = {k: x for k, x in upd.items() if matrix[k]}
    worst = max(upd, key=upd.get)
    worst_w = max(weights, key=weights.get)
    worst_g = max(out["grad_rel_by_leaf"], key=out["grad_rel_by_leaf"].get)
    opt = out["opt_step_rel_by_leaf"]
    worst_o = max(opt, key=opt.get)
    tol = chip_smoke.E2E_SPARSE_TRAIN_TOL
    return dict(run=fault or "sound", seed=seed, preset=preset,
                loss_rel_err=out["loss_rel_err"],
                grad_rel_err=out["grad_rel_err"], worst_grad_leaf=worst_g,
                update_rel_err=upd[worst], worst_update_leaf=worst,
                worst_weight_update=weights[worst_w],
                worst_weight_leaf=worst_w,
                opt_step_rel_err=opt[worst_o], worst_opt_step_leaf=worst_o,
                within_update_limit=upd[worst] <= tol["update_rel"],
                within_opt_step_limit=opt[worst_o] <= tol["opt_step_rel"],
                zero_grad_leaves=out["zero_grad_leaves"],
                update_rel_by_leaf=upd)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--preset", default="opt-1.3b")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("lamb_parity_faults: no CUDA device", file=sys.stderr)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    runs = [(seed, None) for seed in (7, 8, 9)] + [(7, f) for f in FAULTS]
    for seed, fault in runs:
        print(json.dumps(run(dev, args.preset, seed, fault)), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if dev.type == "cuda":
        print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
