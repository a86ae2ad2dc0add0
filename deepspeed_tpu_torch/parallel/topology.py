"""The rank layout of expert parallelism.

Counterpart of ``deepspeed_tpu/parallel/mesh.py`` (``build_mesh`` and the
groups accessors). JAX lays its devices out on the axes ``(pipe, expert,
data, seq, model)``, innermost fastest, and shards the batch over the
composite ``(expert, data)``; with data parallelism alone (pipe, seq and
model of 1) a rank's place is

    rank = e * (dp / ep) + d        e in [0, ep), d in [0, dp / ep)

so rank ``r`` holds rows ``r * mb ..`` of the global micro-batch in both
packages. From that:

* the expert-data group of ``e``: the ``dp / ep`` contiguous ranks that
  hold the same banks, ``[e * E / ep, (e + 1) * E / ep)`` of the E
  experts; the grads of those banks are reduced over it;
* the expert-parallel group of ``d``: the ``ep`` ranks ``d, d + dp / ep,
  ..`` with one of each bank group, which exchange tokens by all-to-all.

This is the transpose of DeepSpeed's ``groups.py`` order (contiguous
expert-parallel ranks): the port follows JAX, so that a rank's rows and
banks, and with them trajectories and checkpoints, line up with JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Topology:
    """``world`` data-parallel ranks, ``ep`` of them across each expert
    group (JAX's ``expert`` axis), ``rank`` this process's."""

    world: int = 1
    ep: int = 1
    rank: int = 0

    def __post_init__(self):
        if self.ep < 1 or self.world % self.ep:
            # JAX mesh.py:77-80
            raise ValueError(
                f"expert_parallel_size {self.ep} must divide the "
                f"data-parallel degree {self.world}")
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} outside a world of "
                             f"{self.world}")

    @property
    def data(self) -> int:
        """The size of JAX's ``data`` axis: ranks that share a bank group."""
        return self.world // self.ep

    def expert_index(self, rank: Optional[int] = None) -> int:
        return (self.rank if rank is None else rank) // self.data

    def data_index(self, rank: Optional[int] = None) -> int:
        return (self.rank if rank is None else rank) % self.data

    def expert_data_ranks(self, e: Optional[int] = None) -> List[int]:
        """The ranks holding bank group ``e`` (default this rank's)."""
        e = self.expert_index() if e is None else e
        return [e * self.data + d for d in range(self.data)]

    def expert_parallel_ranks(self, d: Optional[int] = None) -> List[int]:
        """The ranks that exchange tokens with data index ``d`` (default
        this rank's), in bank-group order."""
        d = self.data_index() if d is None else d
        return [e * self.data + d for e in range(self.ep)]

    def banks(self, num_experts: int, rank: Optional[int] = None
              ) -> Tuple[int, int]:
        """The [lo, hi) range of experts ``rank`` holds."""
        if num_experts % self.ep:
            # JAX runtime/engine.py:263-272
            raise ValueError(f"moe_num_experts={num_experts} must be "
                             f"divisible by expert_parallel_size={self.ep}")
        per = num_experts // self.ep
        e = self.expert_index(rank)
        return e * per, (e + 1) * per


@dataclasses.dataclass
class ExpertGroups:
    """The process groups one rank's MoE layers and ZeRO use: ``None`` is
    the default (world) group, and a group of one rank is ``None`` too with
    its collective skipped by the caller (``size`` 1).

    * ``gate``: every rank, whose router logits make the global plan;
    * ``exchange``: this rank's expert-parallel group (``ep`` ranks);
    * ``expert_data``: this rank's expert-data group (``world / ep``)."""

    topology: Topology
    exchange: Any = None
    expert_data: Any = None

    @property
    def world(self) -> int:
        return self.topology.world

    @property
    def ep(self) -> int:
        return self.topology.ep


def build_groups(topology: Topology) -> ExpertGroups:
    """Every expert-parallel and expert-data group of ``topology`` made on
    every rank, in one order (``torch.distributed.new_group`` is a
    collective), keeping this rank's. A group that is the whole world is
    the default group; one of a single rank is made as nothing."""
    from .. import comm

    t = topology
    mine: Dict[str, Any] = {"exchange": None, "expert_data": None}
    for name, size, count, ranks_of, own in (
            ("exchange", t.ep, t.data, t.expert_parallel_ranks,
             t.data_index()),
            ("expert_data", t.data, t.ep, t.expert_data_ranks,
             t.expert_index())):
        if size in (1, t.world):
            continue
        for j in range(count):
            group = comm.new_group(ranks_of(j))
            if j == own:
                mine[name] = group
    return ExpertGroups(t, **mine)
