"""ZeRO as a partition of flat buffers.

Counterpart of ``deepspeed_tpu/parallel/zero.py`` (and ``zero_policy`` of
``parallel/rules.py``). The JAX package places each state category on the
mesh and XLA emits the collectives; the port lays the params out in flat
buffers, splits them into contiguous ranges per rank, and runs the
collectives itself (``comm``). The stage table, as in JAX (reference
``stage_1_and_2.py``, ``stage3.py``):

  stage 0: params, grads and optimizer state whole on every rank; the grads
           all-reduced                                             (DDP)
  stage 1: + fp32 master and both moments only for the rank's range; the
           update runs over that range and the updated params are
           all-gathered
  stage 2: + grads only for the rank's range: each micro-batch's grads are
           reduce-scattered into an fp32 accumulator of the range
  stage 3: + params only for the rank's range: each gather unit is
           all-gathered just before its layer runs and freed after

``SHARDED_FROM`` holds it as data. ``ZeroPartition`` is the layout: a list of
``Unit``s, each a flat buffer of ``Piece``s (a whole leaf, or one layer's
slice of a leaf stacked on a leading layer axis), split into ``parts``
chunks of ``chunk`` elements (a multiple of ``ALIGN`` when there is more than
one part, so every rank's range starts on 16 elements and the fused Adam
kernel keeps its vector route). A rank's shard is its chunk of every unit,
one after the other: the fp32 master, the moments and the grad accumulator
are flat buffers of that length, so one Adam launch updates them all.

Stages 0-2 have one unit, every leaf in tree order (``parts`` 1 at stage 0).
Stage 3 has a gather unit per layer (its slice of every stacked leaf), one
for the other leaves (embedding, final norm, head), and one ``persistent``
unit holding the leaves of fewer than ``stage3_param_persistence_threshold``
elements whole on every rank, as JAX's ``fsdp_min_size`` keeps them
replicated (their optimizer state is still partitioned).

``ZeroParams`` owns the buffers at run time: the whole params of the
persistent units (views with ``.grad`` views of a flat grad buffer), the
rank's shard of the params, and stage 3's gathers. ``_Gather`` is the
autograd function of one gather unit: its forward all-gathers the unit into
a new buffer, its backward reduce-scatters the unit's grads into the rank's
accumulator and frees the buffer. ``GatheredLayers`` stands for
``params["layers"]`` at stage 3: the transformer's layer loop calls its
``run``, which gathers each layer's unit before the layer and frees the
storage right after it; a hook on the layer's output all-gathers it again
just before the layer's backward (FSDP's free / re-fill), so at most two
units (a layer and the embedding / head unit) hold gathered params at any
time (``live`` / ``peak_live`` count them).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .. import comm
from ..models.core import tree_items, tree_set

ALIGN = 16

# the first stage at which each state category lives only as the rank's
# range (JAX rules.zero_policy's thresholds)
SHARDED_FROM = {"optimizer": 1, "grads": 2, "params": 3}


def sharded(stage: int, state: str) -> bool:
    """Whether ``state`` (optimizer / grads / params) is partitioned at
    ``stage``."""
    if not 0 <= stage <= 3:
        raise ValueError(f"ZeRO stage must be 0..3, got {stage}")
    return stage >= SHARDED_FROM[state]


@dataclasses.dataclass(frozen=True)
class Piece:
    """Elements ``[start, start + numel)`` (C order) of the leaf at ``path``
    (full shape ``shape``), at ``offset`` of its unit's flat buffer.
    ``layer``: the piece is that layer's slice of a stacked leaf."""

    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    start: int
    numel: int
    offset: int
    layer: Optional[int] = None

    @property
    def view_shape(self) -> Tuple[int, ...]:
        return self.shape[1:] if self.layer is not None else self.shape


@dataclasses.dataclass(frozen=True)
class Unit:
    """One flat buffer of pieces, split into ``parts`` chunks of ``chunk``
    elements (the tail past ``numel`` is padding). ``gathered``: between
    steps a rank holds only its chunk of the params (stage 3)."""

    name: str
    pieces: Tuple[Piece, ...]
    numel: int
    chunk: int
    parts: int
    gathered: bool
    layer: Optional[int] = None

    @property
    def padded(self) -> int:
        return self.chunk * self.parts

    def rank_range(self, rank: int) -> Tuple[int, int]:
        """This rank's range of the unit's flat buffer."""
        r = rank if self.parts > 1 else 0
        return r * self.chunk, (r + 1) * self.chunk


def _chunk(numel: int, parts: int, pad: bool) -> int:
    if not pad:
        return numel
    per = -(-numel // parts)
    return -(-per // ALIGN) * ALIGN


def _pieces(leaves, layer: Optional[int] = None) -> Tuple[Tuple[Piece, ...],
                                                          int]:
    out, offset = [], 0
    for path, shape in leaves:
        total = math.prod(shape)
        if layer is None:
            start, n = 0, total
        else:
            n = total // shape[0]
            start = layer * n
        out.append(Piece(path, tuple(shape), start, n, offset, layer))
        offset += n
    return tuple(out), offset


class ZeroPartition:
    """The units of a params tree at one stage, world and rank, and where
    each unit's chunk sits in the rank's shard (``shard_offsets``)."""

    def __init__(self, stage: int, world: int, rank: int,
                 units: List[Unit]):
        self.stage, self.world, self.rank = stage, world, rank
        self.units = units
        self.shard_offsets = []
        off = 0
        for u in units:
            self.shard_offsets.append(off)
            off += u.chunk
        self.shard_numel = off

    @classmethod
    def build(cls, stage: int, params: Any, world: int = 1, rank: int = 0,
              persistence_threshold: int = 0,
              layers_key: str = "layers") -> "ZeroPartition":
        """``params``: a nested dict of tensors (or shapes). At stage 3 the
        leaves under ``params[layers_key]`` are stacked on a leading layer
        axis and make one gather unit a layer."""
        sharded(stage, "params")
        leaves = [(path, tuple(getattr(t, "shape", t)))
                  for path, t in tree_items(params)]
        if stage < 3:
            pieces, n = _pieces(leaves)
            parts = world if stage >= 1 else 1
            return cls(stage, world, rank, [Unit(
                "flat", pieces, n, _chunk(n, parts, parts > 1), parts,
                False)])
        keep = [(p, s) for p, s in leaves
                if math.prod(s) < persistence_threshold]
        stacked = [(p, s) for p, s in leaves if (p, s) not in keep
                   and p[0] == layers_key]
        rest = [(p, s) for p, s in leaves if (p, s) not in keep
                and p[0] != layers_key]
        units = []
        for name, group, layer in (
                [("persistent", keep, None)]
                + [(f"layer{li}", stacked, li)
                   for li in range(stacked[0][1][0] if stacked else 0)]
                + [("rest", rest, None)]):
            if not group:
                continue
            pieces, n = _pieces(group, layer)
            units.append(Unit(name, pieces, n, _chunk(n, world, True), world,
                              name != "persistent", layer))
        return cls(stage, world, rank, units)

    def shard_slice(self, i: int) -> slice:
        off = self.shard_offsets[i]
        return slice(off, off + self.units[i].chunk)

    def layer_units(self) -> List[int]:
        return [i for i, u in enumerate(self.units) if u.layer is not None]

    def leaf_pieces(self) -> Dict[Tuple[str, ...], List[Tuple[int, Piece]]]:
        """Each leaf's pieces with their unit index, in C order."""
        out: Dict[Tuple[str, ...], List[Tuple[int, Piece]]] = {}
        for i, u in enumerate(self.units):
            for pc in u.pieces:
                out.setdefault(pc.path, []).append((i, pc))
        for v in out.values():
            v.sort(key=lambda x: x[1].start)
        return out

    def rank_pieces(self, i: int, rank: int
                    ) -> List[Tuple[Piece, int, int, int]]:
        """The parts of unit ``i``'s pieces inside ``rank``'s range: (piece,
        first element in the leaf's C order, count, position in the rank's
        chunk)."""
        u = self.units[i]
        lo, hi = u.rank_range(rank)
        out = []
        for pc in u.pieces:
            a, b = max(lo, pc.offset), min(hi, pc.offset + pc.numel)
            if a < b:
                out.append((pc, pc.start + a - pc.offset, b - a, a - lo))
        return out

    def rank_segments(self, rank: int) -> Tuple[List[int], List[int]]:
        """(sizes, leaf ids) of the runs that tile ``rank``'s shard in order:
        its pieces, each with the index of its leaf in ``leaf_pieces()``
        order, and the padding between and after them (leaf id -1)."""
        leaf_index = {path: j for j, path in enumerate(self.leaf_pieces())}
        sizes: List[int] = []
        ids: List[int] = []
        for i, u in enumerate(self.units):
            at = 0
            for pc, _, count, pos in self.rank_pieces(i, rank):
                if pos > at:
                    sizes.append(pos - at)
                    ids.append(-1)
                sizes.append(count)
                ids.append(leaf_index[pc.path])
                at = pos + count
            if u.chunk > at:
                sizes.append(u.chunk - at)
                ids.append(-1)
        return sizes, ids

    def describe(self) -> str:
        total = sum(u.numel for u in self.units)
        gathered = sum(u.numel for u in self.units if u.gathered)
        return (f"ZeRO stage {self.stage}: {total / 1e6:.1f}M params in "
                f"{len(self.units)} unit(s) over {self.world} rank(s), "
                f"{gathered / max(total, 1) * 100:.0f}% gathered per use, "
                f"shard {self.shard_numel} elements")


# ---------------------------------------------------------------------------
# nested-dict helpers
# ---------------------------------------------------------------------------


def _merge(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(a)
    for k, v in b.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and k in out else v
    return out


def _unbind_layers(tree: Dict[str, Any], n: int) -> List[Dict[str, Any]]:
    """Per-layer views of stacked leaves, one ``unbind`` a leaf."""
    out: List[Dict[str, Any]] = [{} for _ in range(n)]
    for path, t in tree_items(tree):
        for li, part in enumerate(t.unbind(0)):
            tree_set(out[li], path, part)
    return out


# ---------------------------------------------------------------------------
# the buffers at run time
# ---------------------------------------------------------------------------


class _Gather(torch.autograd.Function):
    """Forward: unit ``i`` all-gathered into a new flat buffer. Backward:
    the buffer's grads reduce-scattered into the rank's accumulator, and
    the buffer freed. ``anchor`` is a leaf that requires grad, so that the
    backward runs."""

    @staticmethod
    def forward(ctx, anchor, zero: "ZeroParams", i: int):
        ctx.zero, ctx.i = zero, i
        return zero._gather_new(i)

    @staticmethod
    def backward(ctx, grad):
        ctx.zero._reduce_unit_grad(ctx.i, grad)
        return None, None, None


class GatheredLayers:
    """``params["layers"]`` at stage 3. ``run(x, step)`` runs ``x = step(li,
    layer, x)`` for each layer with the layer's params gathered (its unit
    plus the persistent leaves' slices) and frees them after; the layer's
    output carries a hook that gathers them again for its backward."""

    def __init__(self, zero: "ZeroParams", persistent: Dict[str, Any],
                 units: List[int]):
        self.zero, self.persistent, self.units = zero, persistent, units

    def run(self, x: torch.Tensor,
            step: Callable[[int, Dict[str, Any], torch.Tensor],
                           torch.Tensor]) -> torch.Tensor:
        n = len(self.units)
        persist = (_unbind_layers(self.persistent, n) if self.persistent
                   else [{}] * n)
        for li, i in enumerate(self.units):
            layer = _merge(self.zero.unit_views(i, self.zero.gather(i)),
                           persist[li])
            x = step(li, layer, x)
            self.zero.release(i)
            if x.requires_grad:
                x.register_hook(partial(self.zero._refill_hook, i))
        return x


class ZeroParams:
    """The params of one rank under a ``ZeroPartition``, on one device.

    * ``full[i]``: unit ``i``'s whole padded buffer, for the units that are
      not gathered per use (all of them below stage 3, the persistent unit
      at stage 3); ``grad_full[i]`` its grads. ``params`` holds their leaves
      as views that require grad, each with its ``.grad`` a view of
      ``grad_full``.
    * ``shard``: the rank's shard of the params in the compute dtype (what
      the optimizer writes): ``full[0]`` itself at stage 0, a view of this
      rank's range of ``full[0]`` at stages 1-2, a buffer of its own at
      stage 3.
    * ``acc``: the fp32 grad accumulator over the shard (stages 2-3),
      which the reduce-scatters add into.
    """

    def __init__(self, partition: ZeroPartition, params: Any,
                 dtype: torch.dtype, device: torch.device):
        self.partition = p = partition
        self.dtype, self.device = dtype, device
        self.full: Dict[int, torch.Tensor] = {}
        self.grad_full: Dict[int, torch.Tensor] = {}
        self.params: Dict[str, Any] = {}
        leaves = dict(tree_items(params))
        if p.stage == 3:
            self.shard = torch.empty(p.shard_numel, dtype=dtype,
                                     device=device)
        for i, u in enumerate(p.units):
            flat = self._pack(u, leaves)
            if not u.gathered:
                self.full[i] = flat
                self.grad_full[i] = torch.zeros_like(flat)
                with torch.no_grad():
                    for pc in u.pieces:
                        v = self._view(flat, pc)
                        v.requires_grad_(True)
                        v.grad = self._view(self.grad_full[i], pc)
                        tree_set(self.params, pc.path, v)
            if p.stage == 3:
                lo, hi = u.rank_range(p.rank)
                self.shard[p.shard_slice(i)].copy_(flat[lo:hi])
        if p.stage < 3:
            lo, hi = p.units[0].rank_range(p.rank)
            self.shard = (self.full[0] if p.units[0].parts == 1
                          else self.full[0][lo:hi])
        self.acc = (torch.zeros(p.shard_numel, dtype=torch.float32,
                                device=device)
                    if sharded(p.stage, "grads") else None)
        self.anchor = torch.zeros((), device=device, requires_grad=True)
        self._alias: Dict[int, torch.Tensor] = {}
        self.live = self.peak_live = 0

    # -- layout ----------------------------------------------------------
    def _pack(self, u: Unit, leaves: Dict[Tuple[str, ...], Any]
              ) -> torch.Tensor:
        flat = torch.zeros(u.padded, dtype=self.dtype, device=self.device)
        with torch.no_grad():
            for pc in u.pieces:
                src = leaves[pc.path].reshape(-1)[pc.start:pc.start
                                                  + pc.numel]
                flat[pc.offset:pc.offset + pc.numel].copy_(src)
        return flat

    @staticmethod
    def _view(flat: torch.Tensor, pc: Piece) -> torch.Tensor:
        return flat[pc.offset:pc.offset + pc.numel].view(pc.view_shape)

    def unit_views(self, i: int, flat: torch.Tensor) -> Dict[str, Any]:
        """The tree of unit ``i``'s pieces as views of ``flat`` (a layer
        unit's paths start below the layers key)."""
        out: Dict[str, Any] = {}
        for pc in self.partition.units[i].pieces:
            tree_set(out, pc.path[1:] if pc.layer is not None else pc.path,
                 self._view(flat, pc))
        return out

    # -- stage 3's gathers -------------------------------------------------
    def _count(self, d: int) -> None:
        self.live += d
        self.peak_live = max(self.peak_live, self.live)

    def _all_gather(self, i: int, out: torch.Tensor,
                    log_name: str = "zero_gather") -> None:
        comm.all_gather(self.shard[self.partition.shard_slice(i)], out=out,
                        log_name=log_name)

    def _gather_new(self, i: int) -> torch.Tensor:
        buf = torch.empty(self.partition.units[i].padded, dtype=self.dtype,
                          device=self.device)
        self._all_gather(i, buf)
        # an alias with its own version counter: re-filling it does not
        # look like an in-place change to the tensors autograd saved
        self._alias[i] = buf.data
        self._count(1)
        return buf

    def gather(self, i: int) -> torch.Tensor:
        """Unit ``i`` gathered whole (through ``_Gather`` when grads are
        on)."""
        if torch.is_grad_enabled():
            return _Gather.apply(self.anchor, self, i)
        return self._gather_new(i)

    def release(self, i: int) -> None:
        """Free unit ``i``'s gathered storage (views of it stay valid as
        metadata until ``_refill_hook``)."""
        alias = self._alias.get(i)
        if alias is not None and alias.untyped_storage().nbytes():
            alias.untyped_storage().resize_(0)
            self._count(-1)

    def release_all(self) -> None:
        for i in list(self._alias):
            self.release(i)
        self._alias.clear()

    def _refill_hook(self, i: int, grad: torch.Tensor) -> None:
        alias = self._alias[i]
        alias.untyped_storage().resize_(alias.numel()
                                        * alias.element_size())
        self._all_gather(i, alias)
        self._count(1)

    def _reduce_unit_grad(self, i: int, grad: torch.Tensor) -> None:
        self.reduce_into_acc(i, grad.contiguous())
        self.release(i)

    def reduce_into_acc(self, i: int, grad: torch.Tensor) -> None:
        """Reduce-scatter unit ``i``'s whole grads into the rank's fp32
        accumulator."""
        part = comm.reduce_scatter(grad, log_name="zero_reduce_scatter")
        self.acc[self.partition.shard_slice(i)].add_(part)

    def step_params(self) -> Dict[str, Any]:
        """The params tree a stage-3 loss reads: the persistent leaves, the
        non-layer unit gathered, and ``layers`` a ``GatheredLayers``."""
        p = self.partition
        tree = _merge({}, self.params)
        layers = p.layer_units()
        for i, u in enumerate(p.units):
            if u.gathered and u.layer is None:
                tree = _merge(tree, self.unit_views(i, self.gather(i)))
        if layers:
            tree["layers"] = GatheredLayers(self, tree.get("layers", {}),
                                            layers)
        return tree

    # -- the step's collectives ------------------------------------------
    def reduce_persistent_grads(self) -> None:
        """Stages 2-3: each whole unit's grads reduce-scattered into the
        accumulator."""
        for i, g in self.grad_full.items():
            self.reduce_into_acc(i, g)

    def release_grads(self) -> None:
        """Stages 2-3: free the whole units' grad buffers (the ``.grad``
        views stay valid as metadata until ``acquire_grads``)."""
        if self.acc is None:
            return
        for g in self.grad_full.values():
            g.untyped_storage().resize_(0)

    def acquire_grads(self) -> None:
        """Stages 2-3: the whole units' grad buffers back, zeroed, before a
        backward."""
        if self.acc is None:
            return
        for g in self.grad_full.values():
            if not g.untyped_storage().nbytes():
                g.untyped_storage().resize_(g.numel() * g.element_size())
                g.zero_()

    def gather_persistent(self) -> None:
        """Stages 1-3, after the update: each whole unit all-gathered from
        the ranks' shards (in place at stages 1-2)."""
        if self.partition.stage == 0:
            return
        for i, flat in self.full.items():
            self._all_gather(i, flat, "param_all_gather")

    # -- whole leaves ------------------------------------------------------
    def full_tree(self, shard: torch.Tensor) -> Dict[str, Any]:
        """The whole tree of a shard-space buffer (``shard`` itself, the
        master or a moment), gathered from every rank: new tensors. A
        collective at world > 1 (every rank calls it)."""
        p = self.partition
        pieces = p.leaf_pieces()
        bufs = {}
        for i, u in enumerate(p.units):
            chunk = shard[p.shard_slice(i)]
            if u.parts == 1:
                bufs[i] = chunk
            else:
                bufs[i] = comm.all_gather(chunk.contiguous(),
                                          log_name="zero_full_tree")
        out: Dict[str, Any] = {}
        for path, plist in pieces.items():
            shape = plist[0][1].shape
            leaf = torch.empty(math.prod(shape), dtype=shard.dtype,
                               device=shard.device)
            for i, pc in plist:
                leaf[pc.start:pc.start + pc.numel] = \
                    bufs[i][pc.offset:pc.offset + pc.numel]
            tree_set(out, path, leaf.view(shape))
        return out

    def full_params(self) -> Dict[str, Any]:
        """The whole params: the views at stages 0-2, gathered copies at
        stage 3 (a collective)."""
        if self.partition.stage < 3:
            return self.params
        with torch.no_grad():
            return self.full_tree(self.shard)
