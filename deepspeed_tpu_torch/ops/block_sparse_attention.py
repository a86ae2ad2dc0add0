"""Block-sparse flash attention over a tile plan: forward, and its backward
under autograd.

Counterpart of ``deepspeed_tpu/ops/block_sparse_attention.py``. The fine
block layout of a sparsity config (``ops/sparse_attention.py``) is tiled on
the host into 128 x 128 tiles (``build_tile_plan``, numpy, the JAX arrays
bit for bit): for every (head, q-tile) the active k-tiles and the id of
each tile's token mask in a table of unique masks, and the transposed
lists (q-tiles per k-tile) that the backward walks. The port's plan adds
each list's true length (``kcount``, ``qcount_t``), so the kernels stop at
it instead of visiting the padded slots, which JAX points at k-tile 0 with
the all-zero mask (they add exp(-inf) = 0, so skipping them gives the same
result); and, for the 16-bit forward kernel, each list's live 16-key groups
packed 8 to a 128-key stage (``TilePlan.stage_plan``).

``block_sparse_attention`` launches the forward CUDA kernel of
``csrc/block_sparse_attention.cu`` on a CUDA tensor and, under autograd,
``block_sparse_attention_bwd``: one call into the backward's CUDA kernels
(delta and the stats tiles, one fused pass for dq, dk and dv, dq's
epilogue), which replaces JAX's dq and dkv kernels and the delta JAX
computes beside them (``block_sparse_attention.py:300``). On a CPU tensor,
or with ``plain=True``, it runs the kernels' plain versions
(``reference_block_sparse_attention`` and
``reference_block_sparse_attention_bwd``, dense attention over the plan's
token mask). JAX's grid-step ceiling (``MAX_GRID_STEPS``, a limit of the
TPU's scalar memory) is not carried over: a block walks its own list, so
any plan runs.

Semantics are the Pallas kernels': q / k / v (B, S, N, D) in the model's
layout (the kernels read it through strides; JAX transposes to (B, N, S, D)
first), S a multiple of 128, k / v with as many heads as q (JAX indexes k
by q's head). Query row i sees key j when the tile plan's mask has (i, j)
and, with ``causal``, j <= i on every visited tile. Scores are
``(q * scale) . k`` in fp32 with an online softmax; a row that sees no key
gives output 0, lse -inf and zero gradients (the JAX kernels' output 0 and
lse NEG_INF, ``block_sparse_attention.py:146-164``, ``:236-238``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import registry
from .flash_attention import (_bwd_workspace_floats, _check_grad_operands,
                              attention_delta)

TILE = 128          # kernel tile edge (q and kv)
QUAD = 64           # the kernels' sub-tile edge: mask quadrants
GROUP = 16          # keys of a group: the forward packs live groups
SLOTS = TILE // GROUP   # groups of a forward stage

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@dataclasses.dataclass(frozen=True, eq=False)
class TilePlan:
    """Static sparse execution plan for one (layout, seq_len): the JAX
    ``TilePlan`` arrays (numpy, equal to JAX's for equal inputs) plus the
    lists' true lengths. Hashes by identity; device copies of the arrays
    are made once per device (``device_arrays``)."""

    kidx: np.ndarray      # (N, nq, A)  int32 — k-tile index per slot
    mid: np.ndarray       # (N, nq, A)  int32 — mask-table id per slot
    qidx_t: np.ndarray    # (N, nk, At) int32 — q-tiles per k-tile
    mid_t: np.ndarray     # (N, nk, At) int32
    masks: np.ndarray     # (U, TILE, TILE) int32 — unique tile submasks
    density: float        # active / total tiles
    kcount: np.ndarray    # (N, nq) int32 — active k-tiles per q-tile
    qcount_t: np.ndarray  # (N, nk) int32 — active q-tiles per k-tile
    _cache: Dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def seq_len(self) -> int:
        return self.kidx.shape[1] * TILE

    @property
    def num_heads(self) -> int:
        return self.kidx.shape[0]

    @property
    def active_tiles(self) -> int:
        return int(self.kcount.sum())

    def stage_plan(self) -> Tuple[np.ndarray, np.ndarray]:
        """The forward's packed stages, numpy, made once: for each (head,
        q-tile), its list walked in order, each 16-key group of a tile that
        some row of the 128-row q-tile sees, packed ``SLOTS`` to a stage.
        Returns ``slots`` (N, nq, SMAX, SLOTS, 4) int32, per slot (the
        group's first key, absolute, or -1 for an empty slot; its mask id;
        its column offset in the tile; flags: bits 2 h .. 2 h + 1 say of
        the 64-row half h 0 no row sees the group, 1 every pair is visible,
        2 partial, from the mask alone), and ``scount`` (N, nq) int32, the
        stages of each list: ceil(live groups / SLOTS)."""
        key = ("stages",)
        if key not in self._cache:
            N, nq, A = self.kidx.shape
            live = (self.masks != 0).reshape(-1, 2, QUAD, SLOTS, GROUP)
            gflag = np.where(live.all(axis=(2, 4)), 1,
                             np.where(live.any(axis=(2, 4)), 2, 0))
            fl = gflag[self.mid].transpose(0, 1, 2, 4, 3)  # (N, nq, A, 8, 2)
            valid = (fl.any(axis=-1)
                     & (np.arange(A)[:, None] < self.kcount[..., None, None]))
            valid = valid.reshape(N, nq, A * SLOTS)
            count = valid.sum(axis=-1)
            scount = (count + SLOTS - 1) // SLOTS
            smax = max(1, int(scount.max()))
            pos = np.cumsum(valid, axis=-1) - 1
            grp = np.arange(A * SLOTS) % SLOTS
            entry = np.stack([
                np.repeat(self.kidx, SLOTS, axis=-1) * TILE + grp * GROUP,
                np.repeat(self.mid, SLOTS, axis=-1),
                np.broadcast_to(grp * GROUP, valid.shape),
                (fl[..., 0] | fl[..., 1] << 2).reshape(N, nq, A * SLOTS)],
                axis=-1)
            slots = np.zeros((N, nq, smax * SLOTS, 4), np.int32)
            slots[..., 0] = -1
            n, i, a = np.nonzero(valid)
            slots[n, i, pos[n, i, a]] = entry[n, i, a]
            self._cache[key] = (slots.reshape(N, nq, smax, SLOTS, 4),
                                scount.astype(np.int32))
        return self._cache[key]

    def device_arrays(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """The kernels' operands on ``device``, made once per device: the
        lists and counts as int32; the mask table as uint8 (U, 128, 128);
        ``quad`` (U, 2, 2) uint8, each 64 x 64 quadrant of a mask 0 where
        it is empty, 1 where it is full, 2 where it is partial; ``bits``
        (U, 128, 2), the masks key-major for the backward (int64 holding
        uint64 words: bit r of ``bits[m, c, h]`` is ``masks[m, 64 h + r,
        c]``); ``korder`` (S / 128,) int32, the key tiles by falling
        transposed-list length summed over heads (the backward's dispatch
        order, heaviest first). For the forward: ``slots`` and ``scount``
        (``stage_plan``); ``rowbits`` (U, 128, 2), the masks query-major
        (bit c of ``rowbits[m, r, h]`` is ``masks[m, r, 64 h + c]``);
        ``qorder`` (S / 128,) int32, the q-tiles by falling stage count
        summed over heads."""
        key = ("kernel", str(device))
        if key not in self._cache:
            live = self.masks != 0
            quads = live.reshape(-1, 2, QUAD, 2, QUAD)
            quad = np.where(quads.all(axis=(2, 4)), 1,
                            np.where(quads.any(axis=(2, 4)), 2, 0))
            shift = np.arange(QUAD, dtype=np.uint64)
            words = {
                name: np.bitwise_or.reduce(
                    m.reshape(-1, TILE, 2, QUAD).astype(np.uint64) << shift,
                    axis=-1)
                for name, m in (("bits", live.transpose(0, 2, 1)),
                                ("rowbits", live))}
            korder = np.argsort(-self.qcount_t.sum(axis=0), kind="stable")
            slots, scount = self.stage_plan()
            qorder = np.argsort(-scount.sum(axis=0), kind="stable")
            arrs = dict(kidx=self.kidx, mid=self.mid, kcount=self.kcount,
                        qidx_t=self.qidx_t, mid_t=self.mid_t,
                        qcount_t=self.qcount_t, korder=korder, slots=slots,
                        scount=scount, qorder=qorder)
            out = {k: torch.from_numpy(np.ascontiguousarray(a, np.int32)
                                       ).to(device) for k, a in arrs.items()}
            out["masks"] = torch.from_numpy(
                np.ascontiguousarray(live, np.uint8)).to(device)
            out["quad"] = torch.from_numpy(
                np.ascontiguousarray(quad, np.uint8)).to(device)
            for name, w in words.items():
                out[name] = torch.from_numpy(
                    np.ascontiguousarray(w).view(np.int64)).to(device)
            self._cache[key] = out
        return self._cache[key]

    def token_mask(self, device: torch.device) -> torch.Tensor:
        """(N, S, S) bool: the tiles' masks placed at their tiles, made once
        per device (the plain versions' operand)."""
        key = ("token", str(device))
        if key not in self._cache:
            N, nt, _ = self.kidx.shape
            tiles = np.zeros((N, nt, nt, TILE, TILE), bool)
            for h in range(N):
                for i in range(nt):
                    for a in range(int(self.kcount[h, i])):
                        tiles[h, i, self.kidx[h, i, a]] = \
                            self.masks[self.mid[h, i, a]] != 0
            tok = tiles.transpose(0, 1, 3, 2, 4).reshape(N, nt * TILE,
                                                         nt * TILE)
            self._cache[key] = torch.from_numpy(tok).to(device)
        return self._cache[key]


def build_tile_plan(layout: np.ndarray, fine_block: int, seq_len: int
                    ) -> TilePlan:
    """Fine block layout (N, S/fb, S/fb) -> padded active-tile lists + the
    unique tile-mask table (JAX ``build_tile_plan``, the same arrays), and
    the lists' lengths. Pure numpy; cache per (config, S)."""
    N = layout.shape[0]
    if seq_len % TILE:
        raise ValueError(f"seq_len {seq_len} must be a multiple of {TILE}")
    nt = seq_len // TILE
    r = TILE // fine_block  # fine blocks per tile edge
    if r * fine_block != TILE:
        raise ValueError(f"config.block ({fine_block}) must divide {TILE}")

    mask_table: Dict[bytes, int] = {}
    masks = []

    def mask_id(m: np.ndarray) -> int:
        key = m.tobytes()
        if key not in mask_table:
            mask_table[key] = len(masks)
            masks.append(m)
        return mask_table[key]

    zero_id = mask_id(np.zeros((TILE, TILE), np.int32))

    lists: list = [[[] for _ in range(nt)] for _ in range(N)]
    lists_t: list = [[[] for _ in range(nt)] for _ in range(N)]
    active = 0
    for h in range(N):
        fine = layout[h]
        for i in range(nt):
            for j in range(nt):
                sub = fine[i * r:(i + 1) * r, j * r:(j + 1) * r]
                if not sub.any():
                    continue
                active += 1
                tile_mask = np.kron(sub, np.ones((fine_block, fine_block),
                                                 np.int32))
                m = mask_id(np.ascontiguousarray(tile_mask))
                lists[h][i].append((j, m))
                lists_t[h][j].append((i, m))

    def pad(ls, width):
        idx = np.zeros((N, nt, width), np.int32)
        mid = np.full((N, nt, width), zero_id, np.int32)
        count = np.zeros((N, nt), np.int32)
        for h in range(N):
            for i in range(nt):
                count[h, i] = len(ls[h][i])
                for a, (j, m) in enumerate(ls[h][i]):
                    idx[h, i, a] = j
                    mid[h, i, a] = m
        return idx, mid, count

    A = max(1, max(len(ls) for head in lists for ls in head))
    At = max(1, max(len(ls) for head in lists_t for ls in head))
    kidx, mid, kcount = pad(lists, A)
    qidx_t, mid_t, qcount_t = pad(lists_t, At)
    return TilePlan(kidx=kidx, mid=mid, qidx_t=qidx_t, mid_t=mid_t,
                    masks=np.stack(masks),
                    density=active / float(N * nt * nt),
                    kcount=kcount, qcount_t=qcount_t)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _scale(D: int, scale: Optional[float]) -> float:
    return float(D ** -0.5 if scale is None else scale)


def _scores(q, k, plan: TilePlan, causal: bool, scale):
    """fp32 scores (B, N, S, S) of ``(q * scale) . k`` and the visibility
    mask (1, N, S, S)."""
    S = q.shape[1]
    s = torch.einsum("bsnd,btnd->bnst", q.float() * _scale(q.shape[3], scale),
                     k.float())
    keep = plan.token_mask(q.device)
    if causal:
        keep = keep & torch.ones(S, S, dtype=torch.bool,
                                 device=q.device).tril()
    return s, keep[None]


def reference_block_sparse_attention(q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor, plan: TilePlan,
                                     causal: bool = False,
                                     scale: Optional[float] = None
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: (o (B, S, N, D) in q's dtype,
    lse (B, N, S) fp32), dense attention over the plan's token mask in
    fp32; a key-less row gives o 0 and lse -inf."""
    s, keep = _scores(q, k, plan, causal, scale)
    s = torch.where(keep, s, torch.full_like(s, float("-inf")))
    lse = torch.logsumexp(s, dim=-1)
    # select, never multiply: a key-less row's lse is -inf and its p is 0
    p = torch.where(keep, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    o = torch.einsum("bnst,btnd->bsnd", p, v.float())
    return o.to(q.dtype), lse


def _reference_bwd(q, k, v, do, lse, delta, plan, causal, scale,
                   magnitude: bool = False):
    sc = _scale(q.shape[3], scale)
    s, keep = _scores(q, k, plan, causal, scale)
    p = torch.where(keep, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dof = do.float()
    dp = torch.einsum("bsnd,btnd->bnst", dof, v.float())
    ds = p * (dp - delta[..., None])
    kf, qf = k.float(), q.float()
    if magnitude:
        ds, kf, qf, dof = ds.abs(), kf.abs(), qf.abs(), dof.abs()
    dq = torch.einsum("bnst,btnd->bsnd", ds, kf) * sc
    dk = torch.einsum("bnst,bsnd->btnd", ds, qf) * sc
    dv = torch.einsum("bnst,bsnd->btnd", p, dof)
    if magnitude:
        return dq, dk, dv
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def reference_block_sparse_attention_bwd(q: torch.Tensor, k: torch.Tensor,
                                         v: torch.Tensor, o: torch.Tensor,
                                         lse: torch.Tensor, do: torch.Tensor,
                                         plan: TilePlan, causal: bool = False,
                                         scale: Optional[float] = None
                                         ) -> Tuple[torch.Tensor,
                                                    torch.Tensor,
                                                    torch.Tensor]:
    """Plain version of ``block_sparse_attention_bwd``: the recompute from
    the forward's lse (B, N, S) with delta = rowsum(dO * O), fp32 arithmetic.
    Returns (dq, dk, dv) in q's / k's / v's dtypes."""
    return _reference_bwd(q, k, v, do, lse, attention_delta(o, do), plan,
                          causal, scale)


def block_sparse_attention_bwd_magnitude(q, k, v, o, lse, do, plan,
                                         causal=False, scale=None):
    """fp32 sums of the backward terms' magnitudes (``scale * |dS| |K|``,
    ``scale * |dS|^T |Q|``, ``P^T |dO|``): the 16-bit kernels round P and
    dS once to the input type before their products, so their error
    against the plain version is at most that rounding times these."""
    return _reference_bwd(q, k, v, do, lse, attention_delta(o, do), plan,
                          causal, scale, magnitude=True)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _check_shapes(name: str, q, k, v, plan: TilePlan):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        if q.dim() == 4 and k.dim() == 4 and k.shape[2] != q.shape[2]:
            raise ValueError(
                f"{name}: k / v have {k.shape[2]} heads and q {q.shape[2]}: "
                "the block-sparse kernels read k / v by q's head (no GQA)")
        raise ValueError(f"{name}: q / k / v must share one (B, S, N, D) "
                         f"shape; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    S, N = q.shape[1], q.shape[2]
    if S != plan.seq_len or N != plan.num_heads:
        raise ValueError(f"{name}: the plan is for S {plan.seq_len} and "
                         f"{plan.num_heads} heads, got S {S}, N {N}")


def _check(name: str, q, k, v, plan: TilePlan):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    _check_shapes(name, q, k, v, plan)
    D = q.shape[3]
    if D % 8 or D > 256:
        raise ValueError(f"{name}: head_dim {D} must be a multiple of 8 "
                         "and at most 256")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q/k/v must share one of float32, "
                         f"bfloat16, float16; got {q.dtype}/{k.dtype}/"
                         f"{v.dtype}")
    for tname, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {tname} must be contiguous, 16-byte "
                             f"aligned, on {q.device}")


def _fn(symbol: str, n_ptrs: int, n_ints: int):
    return registry.function(
        "block_sparse_attention", symbol,
        [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _launch_fwd(q, k, v, plan, causal, scale):
    _check("block_sparse_attention", q, k, v, plan)
    B, S, N, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B, N, S, dtype=torch.float32, device=q.device)
    arrs = plan.device_arrays(q.device)
    err = _fn("dstt_sparse_fwd", 14, 7)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *(arrs[n].data_ptr() for n in ("kidx", "mid", "kcount", "masks",
                                       "quad", "slots", "scount", "rowbits",
                                       "qorder")),
        out.data_ptr(), lse.data_ptr(), B, S, N, D, plan.kidx.shape[2],
        arrs["slots"].shape[2], int(causal), _scale(D, scale),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    registry.check_launch("block_sparse_attention_fwd", err)
    return out, lse


def block_sparse_attention_bwd(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, o: torch.Tensor,
                               lse: torch.Tensor, do: torch.Tensor,
                               plan: TilePlan, causal: bool = False,
                               scale: Optional[float] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """(dq, dk, dv), each (B, S, N, D), of ``block_sparse_attention`` from
    its output o, its lse (B, N, S) fp32 and dout: one call into the
    backward's CUDA kernels on a CUDA tensor (delta included), the plain
    version on a CPU tensor."""
    if q.device.type == "cpu":
        return reference_block_sparse_attention_bwd(q, k, v, o, lse, do,
                                                    plan, causal, scale)
    _check("block_sparse_attention_bwd", q, k, v, plan)
    o, do = o.contiguous(), do.contiguous()
    _check_grad_operands("block_sparse_attention_bwd", q, o, do, lse)
    B, S, N, D = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ws = torch.empty(_bwd_workspace_floats(B, S, N, D), dtype=torch.float32,
                     device=q.device)
    arrs = plan.device_arrays(q.device)
    err = _fn("dstt_sparse_bwd", 20, 7)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(),
        *(arrs[n].data_ptr() for n in ("kidx", "mid", "kcount", "qidx_t",
                                       "mid_t", "qcount_t", "masks", "quad",
                                       "bits", "korder")),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ws.data_ptr(),
        B, S, N, D, plan.kidx.shape[2], plan.qidx_t.shape[2], int(causal),
        _scale(D, scale), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    registry.check_launch("block_sparse_attention_bwd", err)
    return dq, dk, dv


def block_sparse_attention_fwd(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, plan: TilePlan,
                               causal: bool = False,
                               scale: Optional[float] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): the forward kernel on a CUDA tensor, the plain version on
    a CPU tensor. No autograd."""
    if q.device.type == "cpu":
        return reference_block_sparse_attention(q, k, v, plan, causal, scale)
    return _launch_fwd(q, k, v, plan, causal, scale)


class _BlockSparse(torch.autograd.Function):
    """The forward (with lse) and ``block_sparse_attention_bwd`` under
    autograd: the kernels, or with ``plain`` their plain versions (whose
    backward is the same recompute, so a key-less row gets zero gradients
    rather than the NaN that autograd through an all -inf softmax gives)."""

    @staticmethod
    def forward(ctx, q, k, v, plan, causal, scale, plain):
        fwd = reference_block_sparse_attention if plain else _launch_fwd
        o, lse = fwd(q, k, v, plan, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.plan, ctx.causal, ctx.scale, ctx.plain = plan, causal, scale, plain
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = (reference_block_sparse_attention_bwd if ctx.plain
               else block_sparse_attention_bwd)
        grads = bwd(q, k, v, o, lse, do.contiguous(), ctx.plan, ctx.causal,
                    ctx.scale)
        return (*grads, None, None, None, None)


def block_sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           plan: TilePlan, causal: bool = False,
                           scale: Optional[float] = None,
                           plain: bool = False) -> torch.Tensor:
    """Sparse flash attention over a TilePlan (see the module docstring):
    q / k / v (B, S, N, D) -> (B, S, N, D), differentiable in q, k and v.
    The kernels on a CUDA tensor; the plain versions on a CPU tensor or
    with ``plain``."""
    _check_shapes("block_sparse_attention", q, k, v, plan)
    plain = plain or q.device.type == "cpu"
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _BlockSparse.apply(q, k, v, plan, causal, scale, plain)
    fwd = reference_block_sparse_attention if plain else _launch_fwd
    return fwd(q, k, v, plan, causal, scale)[0]
