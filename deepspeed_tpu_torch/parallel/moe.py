"""Mixture-of-Experts: gating, dispatch, the expert FFN and combine.

Counterpart of ``deepspeed_tpu/parallel/moe.py`` (DeepSpeed-MoE's
``TopKGate`` / ``top1gating`` / ``top2gating`` and ``MOELayer``): a softmax
router, capacity factor, load-balancing aux loss (GShard l_aux = E * sum
me * ce), optional no-drop (C = T) and Random Token Selection for top-1.

Everything here is plain PyTorch, as the JAX package computes it in jnp
outside any Pallas kernel: the gating is elementwise and scan work over
(T, E), the dispatch and combine are gathers, and the expert FFN is one
``torch.bmm`` per weight bank over (E, C, H).

All shapes are static: the capacity comes from the token count on the
host, the slot maps are built by scalar scatters into E * C + 1 entries
(the last one a dump slot for dropped assignments, sliced off), and
nothing is read back to the host, so a decode loop that routes tokens
never waits on the device.

Two dispatch formulations (``dispatch_impl``):

* ``"sparse"`` (the default): tokens reach their expert queue by a gather
  through ``token_of_slot`` and come back by a (T, K) gather and weighted
  sum. Both backward passes are gathers as well (``_DispatchGather`` /
  ``_CombineGather``, JAX's custom VJPs), so the (E * C, H) tensors move
  only by gathers, forward and backward, and the sum over K runs in JAX's
  order.
* ``"einsum"``: the GShard (T, E, C) one-hot contraction
  (``_densify``), which the sparse path is held against.

Beyond one rank (``groups``, a ``parallel.topology.ExpertGroups``), as JAX
computes the layer under SPMD over its ``(expert, data)`` batch sharding:

* global gating: each rank's fp32 router logits are all-gathered in rank
  order (``_GatherRows``; its backward sums the gathered grads back,
  reduce-scatter), every rank plans over the global tokens (the capacity,
  the queue positions and the aux loss span them), and keeps its own
  tokens' rows of the plan;
* a rank then builds a slab of its own tokens only: (E, C_loc, H) with
  ``C_loc = min(C, T_local)``, each expert's kept assignments of this rank
  in JAX's queue order (top-1 before top-2, tokens in order). The expert
  FFN works row by row, so the values are JAX's, and a rank's expert FLOPs
  do not grow with the world;
* with expert parallelism (``ep > 1``, the rank holding banks
  ``[e * E / ep, (e + 1) * E / ep)``), the slab's rows go by all-to-all
  within the expert-parallel group to the rank holding their bank
  (``_AllToAll``), that rank runs its banks over the ``ep`` slabs it
  received, and the inverse all-to-all brings the outputs back; the
  backward sends the grads the same two ways. JAX replicates a bank's C
  slots over its ``data`` ranks; here each rank of the expert-data group
  computes the slots of the tokens of its own expert-parallel group, so
  every slot is computed once.

At world 1 the local slab is JAX's (E, C, H) slab (C_loc = C when T >= C,
and the queue positions agree), so the single-rank path is this one with
no collective.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import comm

# When a list, ``moe_mlp`` appends each call's routing statistics to it as
# device tensors (no host read): a measurement hook, off by default.
PLAN_LOG: Optional[List[Dict[str, Any]]] = None


class GateOutput(NamedTuple):
    combine: torch.Tensor         # (T, E, C) fp32 combine weights
    dispatch: torch.Tensor        # (T, E, C) bool dispatch mask
    aux_loss: torch.Tensor        # scalar load-balancing loss
    expert_counts: torch.Tensor   # (E,) tokens routed per expert (pre-drop)


class GatePlan(NamedTuple):
    """Index form of the gating decision: each token's K (expert, queue
    slot) assignments, what the sparse dispatch consumes directly."""

    expert_idx: torch.Tensor      # (T, K) int64 chosen expert
    slot_pos: torch.Tensor        # (T, K) int64 0-based slot in its queue
    weight: torch.Tensor          # (T, K) fp32 combine weight, 0 if dropped
    valid: torch.Tensor           # (T, K) bool kept within capacity
    capacity: int                 # static C
    aux_loss: torch.Tensor        # scalar load-balancing loss
    expert_counts: torch.Tensor   # (E,) tokens routed per expert (pre-drop)


def _capacity(num_tokens: int, num_experts: int, capacity_factor: float,
              min_capacity: int = 4) -> int:
    """DeepSpeed's ``_capacity`` on the host (JAX :56)."""
    cap = int(num_tokens / num_experts * capacity_factor)
    return max(cap, min_capacity)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot over the last axis; an index outside [0, n) gives a
    zero row, as ``jax.nn.one_hot`` (and no device-side range check)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def top1_plan(logits: torch.Tensor, capacity_factor: float = 1.0,
              min_capacity: int = 4, rng: Optional[torch.Generator] = None,
              drop_tokens: bool = True, use_rts: bool = False) -> GatePlan:
    """Switch-style top-1 gating, index form (JAX :67; JAX's
    ``noisy_gate_policy``, which no caller sets, is left out).
    ``drop_tokens=False`` is infinite capacity (C = T). ``use_rts``: Random
    Token Selection, an over-full expert keeps a random C of its tokens
    instead of the first C (draws from ``rng``, a ``torch.Generator`` on
    the logits' device, or the device's default generator when None)."""
    T, E = logits.shape
    C = T if not drop_tokens else _capacity(T, E, capacity_factor,
                                            min_capacity)
    gates = torch.softmax(logits.float(), dim=-1)                    # (T, E)
    expert_idx = torch.argmax(logits, dim=-1)                        # (T,)
    mask = _one_hot(expert_idx, E)                                   # (T, E)

    # aux loss on the pre-RTS mask, as in DeepSpeed
    me = gates.mean(dim=0)
    ce = mask.mean(dim=0)
    aux = torch.sum(me * ce) * E

    if use_rts and drop_tokens and C < T:
        # keep a random C-subset per expert: the top-C random priorities
        pri = mask * torch.rand(mask.shape, generator=rng,
                                device=mask.device)
        top_idx = torch.topk(pri.t(), C, dim=1).indices             # (E, C)
        sel = torch.zeros(E, T, device=mask.device).scatter_(1, top_idx,
                                                             1.0)
        mask = mask * sel.t()

    # position of each token within its expert queue (1-based)
    pos_in_expert = torch.cumsum(mask, dim=0) * mask
    keep = (pos_in_expert <= C) & (mask > 0)
    pos = ((pos_in_expert - 1.0) * mask).sum(dim=-1).long()
    valid = keep.any(dim=-1)                                         # (T,)
    gate_val = (gates * mask).sum(dim=-1)                            # (T,)
    weight = torch.where(valid, gate_val, torch.zeros_like(gate_val))
    return GatePlan(expert_idx=expert_idx[:, None], slot_pos=pos[:, None],
                    weight=weight[:, None], valid=valid[:, None],
                    capacity=C, aux_loss=aux,
                    expert_counts=mask.sum(dim=0))


def top2_plan(logits: torch.Tensor, capacity_factor: float = 1.0,
              min_capacity: int = 4, drop_tokens: bool = True) -> GatePlan:
    """GShard top-2 gating, index form (JAX :116): the second expert is the
    argmax with the first masked out, expert-1 assignments take their queue
    slots before expert-2 ones, both capacity-limited, and the two weights
    are renormalised by ``max(g1 + g2, 1e-9)``."""
    T, E = logits.shape
    C = T if not drop_tokens else _capacity(T, E, 2 * capacity_factor,
                                            min_capacity)
    gates = torch.softmax(logits.float(), dim=-1)

    idx1 = torch.argmax(gates, dim=-1)
    mask1 = _one_hot(idx1, E)
    gates_wo1 = gates * (1.0 - mask1)
    idx2 = torch.argmax(gates_wo1, dim=-1)
    mask2 = _one_hot(idx2, E)

    me = gates.mean(dim=0)
    ce = mask1.mean(dim=0)
    aux = torch.sum(me * ce) * E

    pos1 = torch.cumsum(mask1, dim=0) * mask1
    pos2 = (torch.cumsum(mask2, dim=0) + mask1.sum(dim=0)[None, :]) * mask2
    keep1 = (pos1 <= C) & (mask1 > 0)
    keep2 = (pos2 <= C) & (mask2 > 0)

    g1 = (gates * mask1).sum(dim=-1)
    g2 = (gates * mask2).sum(dim=-1)
    denom = torch.clamp(g1 + g2, min=1e-9)
    g1, g2 = g1 / denom, g2 / denom

    def pos0(pos):
        return (pos.sum(dim=-1) - 1.0).clamp(min=0).long()

    valid1, valid2 = keep1.any(dim=-1), keep2.any(dim=-1)
    zero = torch.zeros_like(g1)
    return GatePlan(
        expert_idx=torch.stack([idx1, idx2], dim=1),
        slot_pos=torch.stack([pos0(pos1), pos0(pos2)], dim=1),
        weight=torch.stack([torch.where(valid1, g1, zero),
                            torch.where(valid2, g2, zero)], dim=1),
        valid=torch.stack([valid1, valid2], dim=1),
        capacity=C, aux_loss=aux,
        expert_counts=(mask1 + mask2).sum(dim=0))


def _densify(plan: GatePlan, num_experts: int) -> GateOutput:
    """(T, K) index form -> (T, E, C) dense combine / dispatch (the GShard
    einsum formulation, JAX :160)."""
    E, C = num_experts, plan.capacity
    K = plan.expert_idx.shape[1]
    combine: Any = torch.zeros((), device=plan.weight.device)
    dispatch = None
    for kk in range(K):   # K <= 2: the peak stays (T, E, C)
        e_oh = _one_hot(plan.expert_idx[:, kk], E) > 0             # (T, E)
        c_oh = _one_hot(plan.slot_pos[:, kk], C) > 0               # (T, C)
        d = (e_oh[:, :, None] & c_oh[:, None, :]
             & plan.valid[:, kk, None, None])                      # (T, E, C)
        combine = combine + plan.weight[:, kk, None, None] * d
        dispatch = d if dispatch is None else (dispatch | d)
    return GateOutput(combine=combine, dispatch=dispatch,
                      aux_loss=plan.aux_loss,
                      expert_counts=plan.expert_counts)


def top1gating(logits: torch.Tensor, capacity_factor: float = 1.0,
               min_capacity: int = 4, rng: Optional[torch.Generator] = None,
               drop_tokens: bool = True, use_rts: bool = False) -> GateOutput:
    """Dense (T, E, C) rendering of :func:`top1_plan`."""
    return _densify(top1_plan(logits, capacity_factor, min_capacity, rng,
                              drop_tokens, use_rts), logits.shape[1])


def top2gating(logits: torch.Tensor, capacity_factor: float = 1.0,
               min_capacity: int = 4, drop_tokens: bool = True) -> GateOutput:
    """Dense (T, E, C) rendering of :func:`top2_plan`."""
    return _densify(top2_plan(logits, capacity_factor, min_capacity,
                              drop_tokens), logits.shape[1])


def _expert_ffn(dispatched: torch.Tensor, experts: Dict[str, torch.Tensor],
                activation: str) -> torch.Tensor:
    """(E, C, H) -> (E, C, H): every expert's MLP, one batched matmul a
    weight bank (JAX :204). SwiGLU, else tanh GELU (JAX's rule for every
    other activation); the banks carry no biases."""
    if activation == "swiglu":
        g = torch.bmm(dispatched, experts["w_gate"])
        u = torch.bmm(dispatched, experts["w_up"])
        inner = F.silu(g) * u
    else:
        inner = F.gelu(torch.bmm(dispatched, experts["w_up"]),
                       approximate="tanh")
    return torch.bmm(inner, experts["w_down"])


# -- scatter-free sparse dispatch / combine (JAX :224-287) -------------------
#
#   dispatch bwd:  dxt[t]       = sum_k valid[t,k] * ddisp[slot[t,k]]
#   combine  bwd:  dy[s]        = filled[s] * wt_of_slot[s]
#                                 * dout[token_of_slot[s]]
#                  dweight[t,k] = valid[t,k] * <dout[t], y[slot[t,k]]>
#
# Every in-range slot has exactly one writer (queue positions are unique per
# expert), unfilled slots are weighted 0 in the combine so their cotangents
# are exactly zero, and dropped assignments carry weight 0.


class _DispatchGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xt, token_of_slot, slot, valid):
        ctx.save_for_backward(slot, valid)
        return xt[token_of_slot]

    @staticmethod
    def backward(ctx, dd):
        slot, valid = ctx.saved_tensors
        take = torch.where(valid, slot, torch.zeros_like(slot))
        dxt = (dd[take] * valid[..., None].to(dd.dtype)).sum(dim=1)
        return dxt, None, None, None


class _CombineGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, weight, slot, valid, token_of_slot, wt_of_slot,
                filled):
        take = torch.where(valid, slot, torch.zeros_like(slot))
        ctx.save_for_backward(y, take, valid, token_of_slot, wt_of_slot,
                              filled)
        ctx.weight_dtype = weight.dtype
        return (weight[..., None] * y[take]).sum(dim=1)

    @staticmethod
    def backward(ctx, dout):
        y, take, valid, token_of_slot, wt_of_slot, filled = ctx.saved_tensors
        dy = (dout[token_of_slot]
              * (wt_of_slot * filled)[:, None].to(dout.dtype))
        dweight = ((dout[:, None, :] * y[take]).sum(dim=-1)
                   * valid.to(dout.dtype))
        return (dy, dweight.to(ctx.weight_dtype), None, None, None, None,
                None)


class _GatherRows(torch.autograd.Function):
    """Forward: every rank's (T, E) rows all-gathered in rank order.
    Backward: the gathered grads summed over the ranks, this rank's rows
    kept (reduce-scatter)."""

    @staticmethod
    def forward(ctx, x):
        return comm.all_gather(x.contiguous(), log_name="moe_gate_gather")

    @staticmethod
    def backward(ctx, grad):
        return comm.reduce_scatter(grad.contiguous(),
                                   log_name="moe_gate_grad_reduce_scatter")


class _AllToAll(torch.autograd.Function):
    """Dim 0 split into the group's ranks' chunks, chunk j sent to rank j;
    the backward is the same exchange of the grads."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return comm.all_to_all(x.contiguous(), group=group,
                               log_name="moe_all_to_all")

    @staticmethod
    def backward(ctx, grad):
        return comm.all_to_all(grad.contiguous(), group=ctx.group,
                               log_name="moe_all_to_all"), None


def _log_plan(plan: GatePlan, num_experts: int) -> None:
    counts = torch.zeros(num_experts, device=plan.valid.device)
    counts.index_add_(0, plan.expert_idx.reshape(-1),
                      plan.valid.reshape(-1).float())
    PLAN_LOG.append(dict(capacity=plan.capacity,
                         assigned=plan.valid.numel(),
                         kept=plan.valid.sum(), expert_load=counts,
                         aux_loss=plan.aux_loss.detach()))


def _rows(plan: GatePlan, lo: int, n: int) -> GatePlan:
    """Tokens ``[lo, lo + n)`` of a plan; the capacity, the aux loss and the
    counts stay the global ones."""
    return plan._replace(expert_idx=plan.expert_idx[lo:lo + n],
                         slot_pos=plan.slot_pos[lo:lo + n],
                         weight=plan.weight[lo:lo + n],
                         valid=plan.valid[lo:lo + n])


def local_slots(plan: GatePlan, num_experts: int) -> torch.Tensor:
    """(T, K) 0-based position of each kept assignment among this plan's
    kept assignments to its expert, top-1 before top-2 and tokens in order
    (JAX's queue order; 0 where dropped). Over every token of a plan it is
    ``slot_pos``; over a rank's rows it packs them below min(C, T).

    A rank's tokens are consecutive in the global order and each expert
    keeps a prefix of its top-1 queue, then of its top-2 queue, so the
    rank's kept k-th choices of an expert hold consecutive global slots:
    the local slot is the global one less the first of them, after the
    rank's kept choices before k. Scatters over T, no scan."""
    T, K = plan.expert_idx.shape
    dev = plan.slot_pos.device
    out = torch.zeros_like(plan.slot_pos)
    before = torch.zeros(num_experts, dtype=torch.long, device=dev)
    far = plan.capacity + T
    for k in range(K):
        e, p, v = (plan.expert_idx[:, k], plan.slot_pos[:, k],
                   plan.valid[:, k])
        first = torch.full((num_experts,), far, dtype=torch.long,
                           device=dev).scatter_reduce(
            0, e, torch.where(v, p, torch.full_like(p, far)), "amin")
        out[:, k] = torch.where(v, before[e] + p - first[e],
                                torch.zeros_like(p))
        before = before.index_add(0, e, v.long())
    return out


def global_plan(logits: torch.Tensor, top_k: int = 2,
                capacity_factor: float = 1.25, min_capacity: int = 4,
                drop_tokens: bool = True, use_rts: bool = False,
                rng: Optional[torch.Generator] = None,
                groups: Any = None) -> GatePlan:
    """This rank's rows of the plan over every rank's tokens: the (T, E)
    fp32 router logits of this rank gathered in rank order (with their
    backward), ``top1_plan`` / ``top2_plan`` over them, and rows ``[rank *
    T, (rank + 1) * T)`` kept; the capacity, the aux loss and the counts are
    the global ones. With no ``groups`` (one rank) the plan itself.
    ``PLAN_LOG`` records the global plan."""
    if top_k == 2 and use_rts:
        raise ValueError("use_rts (Random Token Selection) is top-1 only, "
                         "as in the reference (sharded_moe.py top1gating)")
    T, E = logits.shape
    world = groups.world if groups is not None else 1
    if world > 1:
        if use_rts and drop_tokens:
            raise NotImplementedError(
                "Random Token Selection beyond one rank: every rank would "
                "draw its own priorities for the global plan")
        logits = _GatherRows.apply(logits)                       # (W T, E)
    plan = (top2_plan(logits, capacity_factor, min_capacity,
                      drop_tokens=drop_tokens) if top_k == 2 else
            top1_plan(logits, capacity_factor, min_capacity,
                      drop_tokens=drop_tokens, use_rts=use_rts, rng=rng))
    if PLAN_LOG is not None:
        _log_plan(plan, E)
    if world > 1:
        plan = _rows(plan, groups.topology.rank * T, T)
    return plan


def _experts(dispatched: torch.Tensor, experts: Dict[str, torch.Tensor],
             activation: str, groups: Any) -> torch.Tensor:
    """(E, C_loc, H) rows of this rank's tokens -> their expert outputs.
    With expert parallelism the rows of each bank group go to the rank
    holding it and come back (``_AllToAll`` twice)."""
    ep = groups.ep if groups is not None else 1
    E, C, H = dispatched.shape
    banks = next(iter(experts.values())).shape[0]
    if banks * ep != E:
        raise ValueError(f"{banks} expert bank(s) a rank at "
                         f"expert_parallel_size={ep}, but the router has "
                         f"{E} experts")
    if ep == 1:
        return _expert_ffn(dispatched, experts, activation)
    recv = _AllToAll.apply(dispatched.reshape(E * C, H), groups.exchange)
    # (source, bank, C, H) -> (bank, source x C, H)
    slab = recv.view(ep, banks, C, H).transpose(0, 1).reshape(
        banks, ep * C, H)
    out = _expert_ffn(slab, experts, activation)
    back = out.view(banks, ep, C, H).transpose(0, 1).reshape(E * C, H)
    return _AllToAll.apply(back, groups.exchange).view(E, C, H)


def moe_mlp(x: torch.Tensor, router_w: torch.Tensor,
            experts: Dict[str, torch.Tensor], activation: str,
            top_k: int = 2, capacity_factor: float = 1.25,
            min_capacity: int = 4, drop_tokens: bool = True,
            use_rts: bool = False, rng: Optional[torch.Generator] = None,
            dispatch_impl: str = "sparse", groups: Any = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN of one layer (JAX :290). x (B, S, H): this rank's rows;
    router_w (H, E); ``experts``: ``w_up`` / ``w_down`` (and ``w_gate`` for
    SwiGLU) with a leading expert dim, E / ep banks a rank; ``groups``: the
    rank's ``ExpertGroups`` beyond one rank (None: one rank). Returns (out
    (B, S, H), aux_loss). The router logits are ``x.float() @
    router.float()``: fp32, as the caller's TF32 setting leaves them (the
    port keeps TF32 off)."""
    B, S, H = x.shape
    E = router_w.shape[-1]
    T = B * S
    xt = x.reshape(T, H)
    if dispatch_impl not in ("sparse", "einsum"):
        raise ValueError(f"unknown moe dispatch_impl {dispatch_impl!r} "
                         "(expected 'sparse' or 'einsum')")
    plan = global_plan(xt.float() @ router_w.float(), top_k,
                       capacity_factor, min_capacity, drop_tokens, use_rts,
                       rng, groups)
    # this rank's kept assignments, packed below C_loc in each expert; one
    # rank's plan is already packed so (local_slots would return slot_pos)
    C = min(plan.capacity, T)
    pos = (local_slots(plan, E) if groups is not None and groups.world > 1
           else plan.slot_pos)

    if dispatch_impl == "einsum":
        gate = _densify(plan._replace(slot_pos=pos, capacity=C), E)
        dispatch = gate.dispatch.to(x.dtype)                       # (T, E, C)
        dispatched = torch.einsum("tec,th->ech", dispatch, xt)     # (E, C, H)
        expert_out = _experts(dispatched, experts, activation, groups)
        out = torch.einsum("tec,ech->th", gate.combine.to(x.dtype),
                           expert_out)
        return out.reshape(B, S, H), plan.aux_loss

    # flat slot per (token, assignment); dropped assignments write to the
    # dump slot E * C, sliced off below
    slot = plan.expert_idx * C + pos                               # (T, K)
    slot_in = torch.where(plan.valid, slot, torch.full_like(slot, E * C))
    flat = slot_in.reshape(-1)
    tok = torch.arange(T, device=x.device)[:, None].expand_as(slot_in)
    token_of_slot = torch.zeros(E * C + 1, dtype=torch.long,
                                device=x.device).scatter_(
        0, flat, tok.reshape(-1))[:E * C]
    wt_of_slot = torch.zeros(E * C + 1, device=x.device).scatter_(
        0, flat, plan.weight.detach().reshape(-1))[:E * C]
    filled = torch.zeros(E * C + 1, dtype=torch.bool,
                         device=x.device).scatter_(
        0, flat, plan.valid.reshape(-1))[:E * C]

    # unfilled slots read token 0: the combine weights them 0
    dispatched = _DispatchGather.apply(xt, token_of_slot, slot,
                                       plan.valid).reshape(E, C, H)
    expert_out = _experts(dispatched, experts, activation, groups)
    y = expert_out.reshape(E * C, H)
    out = _CombineGather.apply(y, plan.weight.to(x.dtype), slot, plan.valid,
                               token_of_slot, wt_of_slot, filled)  # (T, H)
    return out.reshape(B, S, H), plan.aux_loss
