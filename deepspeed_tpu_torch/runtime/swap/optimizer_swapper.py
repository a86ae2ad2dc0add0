"""Optimizer state on NVMe (ZeRO-Infinity's optimizer tier).

Counterpart of ``deepspeed_tpu/runtime/swap/optimizer_swapper.py``
(reference ``swap_tensor/pipelined_optimizer_swapper.py``). The rank's fp32
master and Adam moments live in files, one per (sub-group, kind), under
``<nvme_path>/dstpu_swap_p<rank>``; a step streams them through the host
with the offload pipeline of ``runtime/offload.py`` plus the disk:

    read group i+1     (aio, async)
    update group i     (host Adam: ``host_adam_flat``)
    write group i-1    (aio, async)

so about three sub-groups of state are on the host at once (three buffer
sets, reused; ``peak_live_groups`` counts them), besides the pinned grad and
param staging of the pipeline.

The layout is JAX's: entries are (leaf, region) pairs, a region being a box
of the leaf (a rank's range of a leaf is split into the boxes that tile it,
``checkpoint.range_boxes``), taken in JAX's leaf order (sorted paths) and
packed greedily into sub-groups of at most ``sub_group_size`` elements at 12
bytes an element (a region larger than that is a group of its own, updated
in pieces of ``sub_group_size``). At world 1 a region is a whole leaf keyed
by JAX's
``keystr`` path, so the manifest (JAX's format 2 JSON) and the files of the
two packages agree and a JAX snapshot loads here. Padding of the shard is
in no entry: the pipeline never touches it.
"""

from __future__ import annotations

import json
import math
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch

from ...ops.aio import AIOHandle
from ...utils.logging import logger
from ..checkpoint import range_boxes
from ..offload import Span, SubGroupPipeline, scatter_spans

KINDS = ("master", "exp_avg", "exp_avg_sq")
BYTES_PER_ELEMENT = 12


def keystr(path: Tuple[str, ...]) -> str:
    """JAX's ``jax.tree_util.keystr`` of a path of dict keys."""
    return "".join(f"[{k!r}]" for k in path)


Entry = Tuple[str, Tuple[Tuple[int, int], ...], Tuple[int, ...], int, int]


def swap_entries(partition, rank: int) -> List[Entry]:
    """(keystr, region, region shape, elements, position in the shard) of
    every box of ``rank``'s pieces, in JAX's leaf order."""
    out = []
    for i, _ in enumerate(partition.units):
        base = partition.shard_offsets[i]
        for pc, start, count, pos in partition.rank_pieces(i, rank):
            at = base + pos
            for box in range_boxes(pc.shape, start, start + count):
                shape = tuple(b - a for a, b in box)
                size = math.prod(shape)
                out.append((pc.path, tuple(start for start, _ in box),
                            keystr(pc.path), tuple(tuple(ab) for ab in box),
                            shape, size, at))
                at += size
    out.sort(key=lambda e: (e[0], e[1]))
    return [e[2:] for e in out]


def group_entries(entries: List[Entry],
                  sub_group_bytes: int) -> List[List[Entry]]:
    """JAX ``init_from_params``'s greedy packing at 12 bytes an element."""
    groups: List[List[Entry]] = []
    group: List[Entry] = []
    used = 0
    for e in entries:
        if group and used + e[3] * BYTES_PER_ELEMENT > sub_group_bytes:
            groups.append(group)
            group, used = [], 0
        group.append(e)
        used += e[3] * BYTES_PER_ELEMENT
    if group:
        groups.append(group)
    return groups


def _spans(group: List[Entry]) -> List[Span]:
    """The group's shard positions, adjacent entries merged."""
    out: List[List[int]] = []
    for *_, size, pos in group:
        if out and out[-1][0] + out[-1][1] == pos:
            out[-1][1] += size
        else:
            out.append([pos, size])
    return [(p, n) for p, n in out]


class NVMeOptimizerSwapper(SubGroupPipeline):
    """Adam state of one rank in swap files (see the module docstring).
    ``aio``: the config's aio section (queue depth, threads)."""

    def __init__(self, swap_dir: str, partition, rank: int,
                 sub_group_size: int, aio: Optional[Any] = None):
        self.entries = group_entries(swap_entries(partition, rank),
                                     sub_group_size * BYTES_PER_ELEMENT)
        # a group holds whole regions, so one larger than a sub-group is
        # updated in sub-group pieces
        super().__init__([_spans(g) for g in self.entries],
                         update_chunk=sub_group_size)
        os.makedirs(swap_dir, exist_ok=True)
        self.swap_dir = swap_dir
        mk = lambda: AIOHandle(  # noqa: E731
            queue_depth=getattr(aio, "queue_depth", 8),
            num_threads=getattr(aio, "thread_count", 1))
        self._reader = mk()
        self._writers = [mk(), mk()]
        self._sets: List[Optional[Tuple[torch.Tensor, ...]]] = [None] * 3
        self._live: set = set()
        self._writing: List[set] = [set(), set()]
        self._io: Dict[str, int] = {}
        self.peak_live_groups = 0
        self.step_count = 0

    # -- files ------------------------------------------------------------
    def _file(self, gi: int, kind: str) -> str:
        return os.path.join(self.swap_dir, f"group{gi:04d}.{kind}.bin")

    def _set(self, gi: int) -> Tuple[torch.Tensor, ...]:
        k = gi % 3
        if self._sets[k] is None:
            n = max(self.group_sizes)
            self._sets[k] = tuple(torch.empty(n, dtype=torch.float32)
                                  for _ in KINDS)
        n = self.group_sizes[gi]
        return tuple(b[:n] for b in self._sets[k])

    def _read(self, gi: int) -> None:
        self._live.add(gi)
        self.peak_live_groups = max(self.peak_live_groups, len(self._live))
        for kind, buf in zip(KINDS, self._set(gi)):
            self._reader.async_pread(buf, self._file(gi, kind))
        self._io["read_bytes"] += BYTES_PER_ELEMENT * self.group_sizes[gi]

    def _wait_writes(self, handle: int) -> None:
        self._writers[handle].wait()
        self._live -= self._writing[handle]
        self._writing[handle] = set()

    def write_manifest(self) -> None:
        manifest = {"step": self.step_count, "format": 2,
                    "groups": [[(k, [list(ab) for ab in r], list(s), n)
                                for k, r, s, n, _ in g]
                               for g in self.entries]}
        path = os.path.join(self.swap_dir, "manifest.json")
        with open(path + ".tmp", "w") as fh:
            json.dump(manifest, fh)
        os.replace(path + ".tmp", path)

    @torch.no_grad()
    def init_from_shard(self, shard_param: torch.Tensor) -> None:
        """Seed the files: each group's master from the shard, zeroed
        moments; one group on the host at a time."""
        for gi, spans in enumerate(self.groups):
            master, m, v = self._set(gi)
            at = 0
            for pos, n in spans:
                master[at:at + n].copy_(shard_param[pos:pos + n])
                at += n
            m.zero_()
            v.zero_()
            for kind, buf in zip(KINDS, (master, m, v)):
                self._writers[0].async_pwrite(buf, self._file(gi, kind))
            self._writers[0].wait()
        self.write_manifest()
        logger.info(f"NVMe swapper: {len(self.groups)} sub-groups, "
                    f"{sum(self.group_sizes) * BYTES_PER_ELEMENT / 1e9:.2f} "
                    f"GB of optimizer state in {self.swap_dir}")

    # -- the pipeline's state hooks -----------------------------------------
    def _begin(self) -> None:
        self._io = {"read_bytes": 0, "write_bytes": 0}
        self._read(0)

    def _acquire(self, gi: int) -> Tuple[torch.Tensor, ...]:
        self._reader.wait()                        # group gi has landed
        if gi + 1 < len(self.groups):
            # group gi + 1 takes the buffers of group gi - 2, whose writes
            # went to writer gi % 2 (gi - 1's are in the other)
            self._wait_writes(gi % 2)
            self._read(gi + 1)
        return self._set(gi)

    def _release(self, gi: int, bufs: Tuple[torch.Tensor, ...]) -> None:
        for kind, buf in zip(KINDS, bufs):
            self._writers[gi % 2].async_pwrite(buf, self._file(gi, kind))
        self._writing[gi % 2].add(gi)
        self._io["write_bytes"] += BYTES_PER_ELEMENT * self.group_sizes[gi]

    def _end(self) -> None:
        for h in (0, 1):
            self._wait_writes(h)
        self.step_count += 1
        self.write_manifest()

    def step(self, shard_param, grads, update) -> None:
        super().step(shard_param, grads, update)
        self.stats.update(self._io)

    # -- the whole state ----------------------------------------------------
    @torch.no_grad()
    def read_state(self, n: int) -> Dict[str, torch.Tensor]:
        """Each kind as one (n,) CPU fp32 tensor over the shard (0 where the
        shard is padding): group by group from the files."""
        out = {kind: torch.zeros(n, dtype=torch.float32) for kind in KINDS}
        for gi, spans in enumerate(self.groups):
            bufs = tuple(torch.empty(self.group_sizes[gi],
                                     dtype=torch.float32) for _ in KINDS)
            for kind, buf in zip(KINDS, bufs):
                self._reader.async_pread(buf, self._file(gi, kind))
            self._reader.wait()
            for kind, buf in zip(KINDS, bufs):
                scatter_spans(out[kind], spans, buf)
        return out

    def snapshot_to(self, dst_dir: str) -> None:
        """Copy the swap files and the manifest into ``dst_dir`` (a
        checkpoint's ``nvme_state_p<rank>``)."""
        shutil.copytree(self.swap_dir, dst_dir, dirs_exist_ok=True)

    def restore_snapshot(self, src_dir: str, step: int) -> None:
        """Restore the files of a snapshot whose manifest describes this
        swapper's sub-groups (JAX format 2, or format 1's whole-leaf
        entries), and set the step count."""
        path = os.path.join(src_dir, "manifest.json")
        if not os.path.exists(path):
            raise RuntimeError(f"no manifest.json in {src_dir}")
        with open(path) as fh:
            manifest = json.load(fh)
        if manifest.get("format", 1) < 2:
            manifest["groups"] = [
                [(k, [[0, int(d)] for d in s], s, n) for k, s, n in g]
                for g in manifest["groups"]]
        saved = [[(k, tuple(tuple(ab) for ab in r), tuple(s), n)
                  for k, r, s, n in g] for g in manifest["groups"]]
        live = [[(k, r, tuple(s), n) for k, r, s, n, _ in g]
                for g in self.entries]
        if saved != live:
            raise RuntimeError(
                f"NVMe snapshot layout mismatch: {src_dir} holds "
                f"{len(saved)} sub-groups that differ from the {len(live)} "
                "built from the current params and config (another "
                "sub_group_size, model or world size?)")
        for name in os.listdir(src_dir):
            if name.endswith(".bin"):
                shutil.copyfile(os.path.join(src_dir, name),
                                os.path.join(self.swap_dir, name))
        self.step_count = step
        self.write_manifest()

    def close(self, remove: bool = False) -> None:
        """Stop the aio handles; with ``remove`` delete the swap files."""
        for h in [self._reader] + self._writers:
            h.close()
        if remove:
            shutil.rmtree(self.swap_dir, ignore_errors=True)
