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
Under expert parallelism (a ``Topology`` with ``ep > 1``) they have two:
the dense leaves, partitioned over the world, then the rank's expert banks
(``expert`` unit, its pieces the rank's slices of the global (L, E, ...)
leaves), partitioned over the expert-data group: the ranks that hold the
same banks (JAX shards the banks over ``expert`` and the rest of the state
over ``(expert, data)``). Their grads are reduced over those groups, and
the shard stays one flat buffer (the dense chunk, then the expert chunk).
Stage 3 has a gather unit per layer (its slice of every stacked leaf), one
for the other leaves (embedding, final norm, head), and one ``persistent``
unit holding the leaves of fewer than ``stage3_param_persistence_threshold``
elements whole on every rank, as JAX's ``fsdp_min_size`` keeps them
replicated (their optimizer state is still partitioned). Under expert
parallelism a layer has two gather units: its dense slice, split over the
world, and its slice of the rank's banks (``layer<i>_experts``), split
over the expert-data group (JAX ``rules.py:150-165``: the expert dim over
``expert``, fsdp over ``data``); bank leaves are never persistent.

``ZeroParams`` owns the buffers at run time: the whole params of the
persistent units (views with ``.grad`` views of a flat grad buffer), the
rank's shard of the params, and stage 3's gathers. ``_Gather`` is the
autograd function of one gather unit: its forward all-gathers the unit over
its group into a new buffer, its backward reduce-scatters the unit's grads
over that group into the rank's accumulator and frees the buffer.
``GatheredLayers`` stands for ``params["layers"]`` at stage 3: the
transformer's layer loop calls its ``run``, which gathers each layer's
units before the layer and frees the storage right after it; a hook on the
layer's output all-gathers them again just before the layer's backward
(FSDP's free / re-fill), so at most one layer's units and the embedding /
head unit hold gathered params at any time (``live`` / ``peak_live`` count
the units: two, three with a layer's expert unit).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .. import comm
from ..models.core import tree_items, tree_map, tree_set
from .topology import ExpertGroups, Topology

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
    ``layer``: the piece is that layer's slice of a stacked leaf.
    ``expert_axis``: the leaf is a rank's expert banks, ``shape`` its local
    shape, the global leaf ``ep`` times as long on that axis."""

    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    start: int
    numel: int
    offset: int
    layer: Optional[int] = None
    expert_axis: Optional[int] = None

    @property
    def view_shape(self) -> Tuple[int, ...]:
        return self.shape[1:] if self.layer is not None else self.shape


@dataclasses.dataclass(frozen=True)
class Unit:
    """One flat buffer of pieces, split into ``parts`` chunks of ``chunk``
    elements (the tail past ``numel`` is padding). ``gathered``: between
    steps a rank holds only its chunk of the params (stage 3). ``expert``:
    the rank's expert banks, split over its expert-data group."""

    name: str
    pieces: Tuple[Piece, ...]
    numel: int
    chunk: int
    parts: int
    gathered: bool
    layer: Optional[int] = None
    expert: bool = False

    @property
    def padded(self) -> int:
        return self.chunk * self.parts

    def rank_range(self, pos: int) -> Tuple[int, int]:
        """The range of the unit's flat buffer of the rank at ``pos`` of
        the unit's group (``ZeroPartition.rank_range`` finds it)."""
        r = pos if self.parts > 1 else 0
        return r * self.chunk, (r + 1) * self.chunk


def _chunk(numel: int, parts: int, pad: bool) -> int:
    if not pad:
        return numel
    per = -(-numel // parts)
    return -(-per // ALIGN) * ALIGN


def _pieces(leaves, layer: Optional[int] = None,
            axes: Optional[Dict[Tuple[str, ...], int]] = None
            ) -> Tuple[Tuple[Piece, ...], int]:
    out, offset = [], 0
    for path, shape in leaves:
        total = math.prod(shape)
        if layer is None:
            start, n = 0, total
        else:
            n = total // shape[0]
            start = layer * n
        out.append(Piece(path, tuple(shape), start, n, offset, layer,
                         (axes or {}).get(path)))
        offset += n
    return tuple(out), offset


class ZeroPartition:
    """The units of a params tree at one stage, world and rank, and where
    each unit's chunk sits in the rank's shard (``shard_offsets``).
    ``topology``: the ranks' expert layout (one expert group by default)."""

    def __init__(self, stage: int, world: int, rank: int,
                 units: List[Unit], topology: Optional[Topology] = None):
        self.stage, self.world, self.rank = stage, world, rank
        self.units = units
        self.topology = topology or Topology(world, 1, rank)
        self.shard_offsets = []
        off = 0
        for u in units:
            self.shard_offsets.append(off)
            off += u.chunk
        self.shard_numel = off

    @classmethod
    def build(cls, stage: int, params: Any, world: int = 1, rank: int = 0,
              persistence_threshold: int = 0,
              layers_key: str = "layers",
              topology: Optional[Topology] = None,
              experts: Optional[Dict[Tuple[str, ...], int]] = None
              ) -> "ZeroPartition":
        """``params``: a nested dict of tensors (or shapes). At stage 3 the
        leaves under ``params[layers_key]`` are stacked on a leading layer
        axis and make one gather unit a layer. ``experts``: the leaves that
        hold the rank's expert banks and their expert axis; with a
        ``topology`` of ``ep > 1`` they make the ``expert`` unit."""
        sharded(stage, "params")
        leaves = [(path, tuple(getattr(t, "shape", t)))
                  for path, t in tree_items(params)]
        ep = topology.ep if topology is not None else 1
        split = ep > 1 and bool(experts)
        if stage < 3:
            groups = [("flat", [(p, s) for p, s in leaves
                                if not split or p not in experts],
                       world, False)]
            if split:
                groups.append(("experts", [(p, s) for p, s in leaves
                                           if p in experts],
                               topology.data, True))
            units = []
            for name, group, ranks, expert in groups:
                pieces, n = _pieces(group, axes=experts if expert else None)
                parts = ranks if stage >= 1 else 1
                units.append(Unit(name, pieces, n,
                                  _chunk(n, parts, parts > 1), parts, False,
                                  expert=expert))
            return cls(stage, world, rank, units, topology)
        banks = set(experts or {}) if split else set()
        keep = [(p, s) for p, s in leaves
                if math.prod(s) < persistence_threshold and p not in banks]
        stacked = [(p, s) for p, s in leaves if (p, s) not in keep
                   and p[0] == layers_key]
        dense = [(p, s) for p, s in stacked if p not in banks]
        expert = [(p, s) for p, s in stacked if p in banks]
        rest = [(p, s) for p, s in leaves if (p, s) not in keep
                and p[0] != layers_key]
        plan = [("persistent", keep, None, False)]
        for li in range(stacked[0][1][0] if stacked else 0):
            plan += [(f"layer{li}", dense, li, False),
                     (f"layer{li}_experts", expert, li, True)]
        plan.append(("rest", rest, None, False))
        units = []
        for name, group, layer, is_expert in plan:
            if not group:
                continue
            parts = topology.data if is_expert else world
            pieces, n = _pieces(group, layer,
                                axes=experts if is_expert else None)
            units.append(Unit(name, pieces, n, _chunk(n, parts, True), parts,
                              name != "persistent", layer, is_expert))
        return cls(stage, world, rank, units, topology)

    def shard_slice(self, i: int) -> slice:
        off = self.shard_offsets[i]
        return slice(off, off + self.units[i].chunk)

    def rank_range(self, i: int, rank: int) -> Tuple[int, int]:
        """``rank``'s range of unit ``i``'s flat buffer: by its place in the
        world, or in its expert-data group for the expert unit."""
        u = self.units[i]
        return u.rank_range(self.topology.data_index(rank) if u.expert
                            else rank)

    def global_shape(self, pc: Piece) -> Tuple[int, ...]:
        """The shape of a piece's whole leaf over every rank."""
        if pc.expert_axis is None:
            return pc.shape
        a = pc.expert_axis
        return pc.shape[:a] + (pc.shape[a] * self.topology.ep,) \
            + pc.shape[a + 1:]

    def global_box(self, pc: Piece, box: List[List[int]],
                   rank: int) -> List[List[int]]:
        """A box of ``rank``'s copy of a piece's leaf in the whole leaf's
        coordinates (an expert leaf's banks sit at the rank's offset)."""
        if pc.expert_axis is None:
            return box
        a = pc.expert_axis
        off = self.topology.expert_index(rank) * pc.shape[a]
        return box[:a] + [[box[a][0] + off, box[a][1] + off]] + box[a + 1:]

    def layer_units(self) -> List[List[int]]:
        """Each layer's gather units, in layer order."""
        out: Dict[int, List[int]] = {}
        for i, u in enumerate(self.units):
            if u.layer is not None:
                out.setdefault(u.layer, []).append(i)
        return [out[li] for li in sorted(out)]

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
        lo, hi = self.rank_range(i, rank)
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
        ep = (f", the experts' over {self.topology.data} rank(s) at ep "
              f"{self.topology.ep}" if any(u.expert for u in self.units)
              else "")
        return (f"ZeRO stage {self.stage}: {total / 1e6:.1f}M params in "
                f"{len(self.units)} unit(s) over {self.world} rank(s){ep}, "
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
    layer, x)`` for each layer with the layer's params gathered (its units
    plus the persistent leaves' slices) and frees them after; the layer's
    output carries a hook for each unit that gathers it again for the
    layer's backward. ``units``: each layer's unit indices."""

    def __init__(self, zero: "ZeroParams", persistent: Dict[str, Any],
                 units: List[List[int]]):
        self.zero, self.persistent, self.units = zero, persistent, units

    def run(self, x: torch.Tensor,
            step: Callable[[int, Dict[str, Any], torch.Tensor],
                           torch.Tensor]) -> torch.Tensor:
        n = len(self.units)
        persist = (_unbind_layers(self.persistent, n) if self.persistent
                   else [{}] * n)
        for li, units in enumerate(self.units):
            layer = persist[li]
            for i in units:
                layer = _merge(self.zero.unit_views(i, self.zero.gather(i)),
                               layer)
            x = step(li, layer, x)
            for i in units:
                self.zero.release(i)
                if x.requires_grad:
                    x.register_hook(partial(self.zero._refill_hook, i))
        return x


class ZeroParams:
    """The params of one rank under a ``ZeroPartition``, on one device.

    * ``full[i]``: unit ``i``'s whole padded buffer, for the units that are
      not gathered per use (all of them below stage 3, the persistent unit
      at stage 3); ``grad_full[i]`` its grads. Below stage 3 they are views
      of one buffer each, ``whole`` and ``grad_whole``, the units one after
      the other. ``params`` holds their leaves as views that require grad,
      each with its ``.grad`` a view of ``grad_full``.
    * ``shard``: the rank's shard of the params in the compute dtype (what
      the optimizer writes): ``whole`` itself when no unit is split (stage
      0), a view of this rank's range of it with one unit at stages 1-2,
      else a buffer of its own (stage 3, or the expert unit beside the
      dense one at stages 1-2), all-gathered back after the update.
    * ``acc``: the fp32 grad accumulator over the shard (stages 2-3),
      which the reduce-scatters add into.

    ``groups``: the rank's ``ExpertGroups``, whose expert-data group
    reduces and gathers the expert unit.
    """

    def __init__(self, partition: ZeroPartition, params: Any,
                 dtype: torch.dtype, device: torch.device,
                 groups: Optional[ExpertGroups] = None):
        self.partition = p = partition
        self.dtype, self.device = dtype, device
        self.groups = groups
        self.full: Dict[int, torch.Tensor] = {}
        self.grad_full: Dict[int, torch.Tensor] = {}
        self.params: Dict[str, Any] = {}
        self.whole = self.grad_whole = None
        leaves = dict(tree_items(params))
        if p.stage == 3:
            self.shard = torch.empty(p.shard_numel, dtype=dtype,
                                     device=device)
        else:
            self.whole = torch.zeros(sum(u.padded for u in p.units),
                                     dtype=dtype, device=device)
            self.grad_whole = torch.zeros_like(self.whole)
        at = 0
        for i, u in enumerate(p.units):
            if p.stage == 3:
                flat = self._pack(u, leaves)
            else:
                flat = self._pack(u, leaves, self.whole[at:at + u.padded])
            if not u.gathered:
                self.full[i] = flat
                self.grad_full[i] = (torch.zeros_like(flat) if p.stage == 3
                                     else self.grad_whole[at:at + u.padded])
                with torch.no_grad():
                    for pc in u.pieces:
                        v = self._view(flat, pc)
                        v.requires_grad_(True)
                        v.grad = self._view(self.grad_full[i], pc)
                        tree_set(self.params, pc.path, v)
            at += u.padded
            if p.stage == 3:
                lo, hi = p.rank_range(i, p.rank)
                self.shard[p.shard_slice(i)].copy_(flat[lo:hi])
        if p.stage < 3:
            if all(u.parts == 1 for u in p.units):
                self.shard = self.whole
            elif len(p.units) == 1:
                lo, hi = p.rank_range(0, p.rank)
                self.shard = self.whole[lo:hi]
            else:
                self.shard = self._shard_of(self.whole)
        self.acc = (torch.zeros(p.shard_numel, dtype=torch.float32,
                                device=device)
                    if sharded(p.stage, "grads") else None)
        self.anchor = torch.zeros((), device=device, requires_grad=True)
        self._alias: Dict[int, torch.Tensor] = {}
        self.live = self.peak_live = 0

    # -- layout ----------------------------------------------------------
    def _pack(self, u: Unit, leaves: Dict[Tuple[str, ...], Any],
              flat: Optional[torch.Tensor] = None) -> torch.Tensor:
        if flat is None:
            flat = torch.zeros(u.padded, dtype=self.dtype,
                               device=self.device)
        with torch.no_grad():
            for pc in u.pieces:
                src = leaves[pc.path].reshape(-1)[pc.start:pc.start
                                                  + pc.numel]
                flat[pc.offset:pc.offset + pc.numel].copy_(src)
        return flat

    @staticmethod
    def _view(flat: torch.Tensor, pc: Piece) -> torch.Tensor:
        return flat[pc.offset:pc.offset + pc.numel].view(pc.view_shape)

    def _shard_of(self, whole: torch.Tensor) -> torch.Tensor:
        """The rank's chunk of each unit of a ``whole``-laid-out buffer, one
        after the other (a new buffer)."""
        p, at, parts = self.partition, 0, []
        for i, u in enumerate(p.units):
            lo, hi = p.rank_range(i, p.rank)
            parts.append(whole[at + lo:at + hi])
            at += u.padded
        return torch.cat(parts)

    # -- groups ------------------------------------------------------------
    def group_of(self, i: int) -> Tuple[Any, int]:
        """(process group, ranks) over which unit ``i`` is split and its
        grads reduced: the world, or the expert-data group."""
        if self.partition.units[i].expert:
            return self.groups.expert_data, self.partition.topology.data
        return None, self.partition.world

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
        src = self.shard[self.partition.shard_slice(i)]
        if self.partition.units[i].parts == 1:
            if out.data_ptr() != src.data_ptr():
                out.copy_(src)
            return
        group, _ = self.group_of(i)
        comm.all_gather(src, out=out, group=group, log_name=log_name)

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
        """Reduce-scatter unit ``i``'s whole grads over its group into the
        rank's fp32 accumulator."""
        group, ranks = self.group_of(i)
        if self.partition.units[i].expert and ranks == 1:
            part = grad
        else:
            part = comm.reduce_scatter(
                grad, group=group,
                log_name=("expert_reduce_scatter"
                          if self.partition.units[i].expert
                          else "zero_reduce_scatter"))
        self.acc[self.partition.shard_slice(i)].add_(part)

    def reduce_grads(self, full: torch.Tensor) -> torch.Tensor:
        """Stages 0-1: whole grads laid out as ``whole`` (``full``, in any
        float dtype) summed in place over each unit's group; returns the
        rank's shard of them."""
        p, at = self.partition, 0
        for i, u in enumerate(p.units):
            group, ranks = self.group_of(i)
            if ranks > 1 or not u.expert:
                comm.all_reduce(full[at:at + u.padded], group=group,
                                log_name=("expert_grad_all_reduce" if u.expert
                                          else "grad_all_reduce"))
            at += u.padded
        if self.shard is self.whole:
            return full
        if len(p.units) == 1:
            lo, hi = p.rank_range(0, p.rank)
            return full[lo:hi]
        return self._shard_of(full)

    def expert_norm(self) -> Optional[Tuple[int, Any]]:
        """Stage 0 under expert parallelism: (where the expert unit starts in
        the shard, the expert-parallel group). The grad norm sums the dense
        part's squares once and the expert part's over that group, so each
        bank counts once; None where the shard is not laid out so."""
        p = self.partition
        if (self.shard is not self.whole or len(p.units) < 2
                or p.topology.ep == 1):
            return None
        return p.shard_offsets[1], self.groups.exchange

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

    def _grad_bases(self) -> List[torch.Tensor]:
        return ([self.grad_whole] if self.grad_whole is not None
                else list(self.grad_full.values()))

    def release_grads(self) -> None:
        """Stages 2-3: free the whole units' grad buffers (the ``.grad``
        views stay valid as metadata until ``acquire_grads``)."""
        if self.acc is None:
            return
        for g in self._grad_bases():
            g.untyped_storage().resize_(0)

    def acquire_grads(self) -> None:
        """Stages 2-3: the whole units' grad buffers back, zeroed, before a
        backward."""
        if self.acc is None:
            return
        for g in self._grad_bases():
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
    def _whole_banks(self, leaf: torch.Tensor, pc: Piece) -> torch.Tensor:
        """A rank's banks of an expert leaf -> the whole leaf, gathered over
        the expert-parallel group (a collective)."""
        a = pc.expert_axis
        local = leaf.movedim(a, 0).contiguous()
        return comm.all_gather(local, group=self.groups.exchange,
                               log_name="expert_full_tree").movedim(0, a)

    def full_tree(self, shard: torch.Tensor) -> Dict[str, Any]:
        """The whole tree of a shard-space buffer (``shard`` itself, the
        master or a moment), gathered from every rank: new tensors, expert
        leaves with every bank. A collective at world > 1 (every rank
        calls it)."""
        p = self.partition
        pieces = p.leaf_pieces()
        bufs = {}
        for i, u in enumerate(p.units):
            chunk = shard[p.shard_slice(i)]
            if u.parts == 1:
                bufs[i] = chunk
            else:
                group, _ = self.group_of(i)
                bufs[i] = comm.all_gather(chunk.contiguous(), group=group,
                                          log_name="zero_full_tree")
        out: Dict[str, Any] = {}
        for path, plist in pieces.items():
            shape = plist[0][1].shape
            leaf = torch.empty(math.prod(shape), dtype=shard.dtype,
                               device=shard.device)
            for i, pc in plist:
                leaf[pc.start:pc.start + pc.numel] = \
                    bufs[i][pc.offset:pc.offset + pc.numel]
            leaf = leaf.view(shape)
            if plist[0][1].expert_axis is not None:
                leaf = self._whole_banks(leaf, plist[0][1])
            tree_set(out, path, leaf)
        return out

    def full_params(self) -> Dict[str, Any]:
        """The whole params: the views at stages 0-2, gathered copies at
        stage 3 (a collective); under expert parallelism the expert leaves
        gathered whole over the expert-parallel group beside the dense
        views (a collective)."""
        p = self.partition
        with torch.no_grad():
            if p.stage == 3:
                return self.full_tree(self.shard)
            if len(p.units) == 1:
                return self.params
            out = tree_map(lambda t: t, self.params)
            for pc in p.units[1].pieces:
                tree_set(out, pc.path, self._whole_banks(
                    self._view(self.full[1], pc), pc))
            return out
