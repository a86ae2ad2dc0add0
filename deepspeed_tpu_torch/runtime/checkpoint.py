"""Checkpoints in the JAX package's format 2: sharded, async, reshardable.

Counterpart of ``deepspeed_tpu/runtime/checkpoint.py``; a checkpoint written
by either package loads into the other. Layout:

    <dir>/<tag>/metadata.json                format 2: tag, client_state,
                                             save_stamp, and per array its
                                             shape, dtype string and shards
    <dir>/<tag>/arrays/<key>.s<K>.npy        shard K of an array: the box
                                             ``bounds`` (a [start, stop) per
                                             dimension) of the leaf
    <dir>/latest                             the newest committed tag

Keys join path elements with ``##``: ``params##<leaf path>``,
``opt##master##<leaf path>`` (16-bit params only), the Adam moments and
counts under ``opt##inner##...`` at the positions of the optax chain the
JAX engine builds for the same optimizer (``optax_keys``), and
``opt##count``. bf16 arrays are stored as their uint16 bits with the dtype
string ``bfloat16``.

The port's state is flat (``parallel/zero.py``): each rank writes, for each
leaf, the boxes that tile its own range of it (``range_boxes`` splits a
contiguous range of a C-order array into boxes), and a leaf held whole on
every rank is written once, by rank 0. Loading assembles a rank's ranges
from whatever boxes the files hold (``_assemble_slice``), so a checkpoint
written at one world and stage loads at any other.

Integrity, as in JAX: each rank writes its shards under ``.<tag>.tmp`` and a
done marker holding this save's stamp and the crc32 of each shard's bytes;
rank 0 waits for every marker, merges the checksums into the metadata,
renames the tree into place and only then moves ``latest``.
``verify_checkpoint`` re-hashes the shards; ``load(..., verify=True)``
falls back to the newest tag that verifies clean. ``async_save`` copies the
state to the host at once and writes the files on a thread.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import comm
from ..models.core import tree_items
from ..utils.logging import log_dist, logger

_SEP = "##"
_COMMIT_TIMEOUT_S = 600

_PENDING_LOCK = threading.Lock()
_PENDING: Optional[threading.Thread] = None

_NP_DTYPES = {"float32": np.float32, "float16": np.float16,
              "int32": np.int32, "int64": np.int64, "uint8": np.uint8,
              "int8": np.int8, "bfloat16": np.uint16}
_DTYPE_STR = {torch.float32: "float32", torch.float16: "float16",
              torch.int32: "int32", torch.int64: "int64",
              torch.uint8: "uint8", torch.int8: "int8",
              torch.bfloat16: "bfloat16"}


class CheckpointCorruption(RuntimeError):
    """Raised by a verified load when no tag in the directory verifies
    clean."""


# ---------------------------------------------------------------------------
# arrays <-> files
# ---------------------------------------------------------------------------


def range_boxes(shape: Tuple[int, ...], lo: int, hi: int
                ) -> List[List[List[int]]]:
    """Boxes (a [start, stop) per dimension) that tile elements [lo, hi) of
    a C-order array of ``shape``, in order; each box is itself contiguous in
    C order. At most 2 * ndim - 1 boxes."""
    if lo >= hi:
        return []
    if not shape:
        return [[]]
    inner = math.prod(shape[1:])
    a, b = divmod(lo, inner)
    c, d = divmod(hi, inner)
    if a == c:
        return [[[a, a + 1]] + box for box in range_boxes(shape[1:], b, d)]
    boxes = []
    if b:
        boxes += [[[a, a + 1]] + box
                  for box in range_boxes(shape[1:], b, inner)]
        a += 1
    if c > a:
        boxes.append([[a, c]] + [[0, s] for s in shape[1:]])
    if d:
        boxes += [[[c, c + 1]] + box for box in range_boxes(shape[1:], 0, d)]
    return boxes


def _box_shape(box: List[List[int]]) -> Tuple[int, ...]:
    return tuple(b - a for a, b in box)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host array of the tensor's bits (bf16 as uint16)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(arr: np.ndarray, dtype_str: str) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if dtype_str == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _crc(data: np.ndarray) -> int:
    # the array's bytes (what a loader gets back), as JAX hashes them
    return zlib.crc32(np.ascontiguousarray(data).reshape(-1).view(np.uint8))


def _fname(full_key: str, shard_id: int) -> str:
    safe = re.sub(r"[^A-Za-z0-9_.#-]", "_", full_key)
    return f"{safe}.s{shard_id}.npy"


def _tmp_name(tag: str) -> str:
    return f".{tag}.tmp"


def _assemble_slice(arrays_dir: str, info: Dict, want: List[List[int]]
                    ) -> np.ndarray:
    """The box ``want`` of an array, read from the saved shards that overlap
    it (memory-mapped), in the stored dtype (bf16 as uint16 bits)."""
    out_shape = [b - a for a, b in want]
    out = np.empty(out_shape, dtype=_NP_DTYPES[info["dtype"]])
    filled = 0
    for shard in info["shards"]:
        bounds = shard["bounds"]
        inter = [[max(a0, b0), min(a1, b1)]
                 for (a0, a1), (b0, b1) in zip(want, bounds)]
        if any(a >= b for a, b in inter):
            continue
        src = np.load(os.path.join(arrays_dir, shard["file"]), mmap_mode="r")
        src_sel = tuple(slice(a - b0, b - b0)
                        for (a, b), (b0, _) in zip(inter, bounds))
        dst_sel = tuple(slice(a - w0, b - w0)
                        for (a, b), (w0, _) in zip(inter, want))
        out[dst_sel] = src[src_sel]
        filled += int(np.prod([b - a for a, b in inter]))
    expect = int(np.prod(out_shape)) if out_shape else 1
    if filled != expect:
        raise ValueError(f"checkpoint shards cover {filled}/{expect} "
                         f"elements of requested slice {want}")
    return out


def wait_pending() -> None:
    """Block until an in-flight async save has committed."""
    with _PENDING_LOCK:
        t = _PENDING
    if t is not None:
        t.join()


# ---------------------------------------------------------------------------
# tags
# ---------------------------------------------------------------------------


def verify_checkpoint(load_dir: str, tag: str) -> List[str]:
    """Integrity check of one tag: every shard in the metadata must exist,
    load, and match its recorded crc32. Returns the problems (empty: clean).
    """
    ckpt_dir = os.path.join(load_dir, tag)
    try:
        with open(os.path.join(ckpt_dir, "metadata.json")) as fh:
            meta = json.load(fh)
    except (OSError, ValueError) as e:
        return [f"{tag}: unreadable metadata.json ({e})"]
    arrays_dir = os.path.join(ckpt_dir, "arrays")
    problems: List[str] = []
    for full_key, info in meta.get("arrays", {}).items():
        for shard in info.get("shards", []):
            path = os.path.join(arrays_dir, shard["file"])
            try:
                data = np.load(path, allow_pickle=False)
            except (OSError, ValueError) as e:
                problems.append(
                    f"{tag}: shard '{shard['file']}' of '{full_key}' "
                    f"unreadable ({type(e).__name__}: {e})")
                continue
            want = shard.get("crc32")
            if want is None:
                continue
            got = _crc(data)
            if got != want:
                problems.append(
                    f"{tag}: shard '{shard['file']}' of '{full_key}' "
                    f"checksum mismatch (crc32 {got} != recorded {want})")
    return problems


def list_tags(load_dir: str) -> List[str]:
    """Committed tags in ``load_dir``, newest first (by metadata mtime);
    staging and trash directories of interrupted saves are left out."""
    out = []
    try:
        names = os.listdir(load_dir)
    except OSError:
        return []
    for name in names:
        if name.startswith(".") or name.endswith(".tmp"):
            continue
        meta = os.path.join(load_dir, name, "metadata.json")
        if os.path.isfile(meta):
            out.append((os.path.getmtime(meta), name))
    return [name for _, name in sorted(out, reverse=True)]


def read_latest_tag(load_dir: str) -> Optional[str]:
    """The tag ``latest`` names, restoring a tag left in ``<tag>.replaced.
    tmp`` by a re-save of the same tag that died between its renames."""
    wait_pending()
    latest = os.path.join(load_dir, "latest")
    if not os.path.exists(latest):
        return None
    with open(latest) as fh:
        tag = fh.read().strip()
    if tag and not os.path.isdir(os.path.join(load_dir, tag)):
        trash = os.path.join(load_dir, tag + ".replaced.tmp")
        if os.path.isfile(os.path.join(trash, "metadata.json")):
            try:
                os.rename(trash, os.path.join(load_dir, tag))
                logger.warning(f"checkpoint: recovered tag '{tag}' from an "
                               "interrupted re-save swap")
            except OSError:
                pass
    return tag


def find_verified_tag(load_dir: str, tag: Optional[str] = None) -> str:
    """``tag`` (or latest) if it verifies clean, else the newest other tag
    that does; raises ``CheckpointCorruption`` when none does."""
    tried: List[str] = []
    first = tag or read_latest_tag(load_dir)
    candidates = [first] if first else []
    candidates += [t for t in list_tags(load_dir) if t not in candidates]
    for cand in candidates:
        problems = verify_checkpoint(load_dir, cand)
        if not problems:
            if tried:
                logger.error(f"checkpoint: tag(s) {tried} failed "
                             f"verification; falling back to '{cand}'")
            return cand
        for p in problems[:3]:
            logger.error(f"checkpoint verify: {p}")
        tried.append(cand)
    raise CheckpointCorruption(
        f"no checkpoint tag in {load_dir} verifies clean "
        f"(tried {tried or '<none>'})")


def _validate_tag(tag: str, mode: str) -> None:
    """Reference ``_checkpoint_tag_validation``: every rank must save under
    the same tag."""
    if comm.get_world_size() == 1 or mode.lower() == "ignore":
        return
    h = zlib.crc32(tag.encode()) & 0xFFFFFF     # exact in float32
    seen = comm.host_all_gather_array(np.float32(h))
    if not bool((seen == h).all()):
        msg = f"checkpoint tag '{tag}' differs across processes"
        if mode.lower() == "fail":
            raise RuntimeError(msg)
        logger.warning(msg)


# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------


class ArrayPlan:
    """One array of a checkpoint: its key, shape, dtype string, every
    rank's shard boxes (the same list on every rank), and this rank's
    shards as (shard index, function returning the host array)."""

    def __init__(self, key: str, shape: Tuple[int, ...], dtype: str):
        self.key, self.shape, self.dtype = key, tuple(shape), dtype
        self.bounds: List[List[List[int]]] = []
        self.mine: List[Tuple[int, Callable[[], np.ndarray]]] = []

    def add(self, bounds: List[List[int]],
            data: Optional[Callable[[], np.ndarray]]) -> None:
        if data is not None:
            self.mine.append((len(self.bounds), data))
        self.bounds.append(bounds)

    def meta(self) -> Dict[str, Any]:
        return {"shape": list(self.shape), "dtype": self.dtype,
                "shards": [{"file": _fname(self.key, i), "bounds": b}
                           for i, b in enumerate(self.bounds)]}


def save_checkpoint(save_dir: str, tag: str, arrays: List[ArrayPlan],
                    client_state: Optional[Dict] = None,
                    save_latest: bool = True, tag_validation: str = "Warn",
                    async_save: bool = False) -> str:
    """Write ``arrays`` (each rank its own shards) as tag ``tag`` of
    ``save_dir``; returns the tag directory. A collective. With
    ``async_save`` the host copies are taken now and the files written on a
    thread; ``latest`` moves only after every rank's files landed."""
    wait_pending()
    _validate_tag(tag, tag_validation)
    rank, world = comm.get_rank(), comm.get_world_size()
    final_dir = os.path.join(save_dir, tag)
    ckpt_dir = os.path.join(save_dir, _tmp_name(tag))
    arrays_dir = os.path.join(ckpt_dir, "arrays")
    if rank == 0 and os.path.isdir(ckpt_dir):
        shutil.rmtree(ckpt_dir)      # the leftovers of a crashed save
    comm.barrier()
    os.makedirs(arrays_dir, exist_ok=True)
    cs = dict(client_state or {})
    # a per-save nonce from rank 0, so that markers left by an earlier save
    # into the same staging directory never satisfy this one's barrier
    nonce = torch.tensor([int.from_bytes(os.urandom(7), "big")],
                         dtype=torch.int64, device=comm.comm_device())
    comm.broadcast(nonce, 0, log_name="checkpoint_nonce")
    stamp = (f"{cs.get('global_steps', '')}:{cs.get('micro_steps', '')}:"
             f"{int(nonce.item())}")
    meta: Dict[str, Any] = {"format": 2, "tag": tag, "client_state": cs,
                            "save_stamp": stamp,
                            "arrays": {a.key: a.meta() for a in arrays}}
    writes = [(os.path.join(arrays_dir, _fname(a.key, i)), data)
              for a in arrays for i, data in a.mine]
    if async_save:
        writes = [(path, (lambda arr: lambda: arr)(data()))
                  for path, data in writes]
    try:
        os.remove(os.path.join(ckpt_dir, f".done.{rank}"))
    except FileNotFoundError:
        pass

    def commit():
        crcs: Dict[str, int] = {}
        for path, data in writes:
            arr = data()
            np.save(path, arr, allow_pickle=False)
            crcs[os.path.basename(path)] = _crc(arr)
        with open(os.path.join(ckpt_dir, f".done.{rank}"), "w") as fh:
            json.dump({"stamp": stamp, "crc": crcs}, fh)
        if rank == 0:
            _publish(save_dir, tag, ckpt_dir, final_dir, meta, world, stamp,
                     save_latest)
        else:
            _await_publish(final_dir, tag, stamp)

    if async_save:
        global _PENDING
        t = threading.Thread(target=commit, name=f"ckpt-save-{tag}",
                             daemon=True)
        with _PENDING_LOCK:
            _PENDING = t
        t.start()
    else:
        commit()
    return final_dir


def _marker(ckpt_dir: str, rank: int, stamp: str) -> Optional[Dict]:
    try:
        with open(os.path.join(ckpt_dir, f".done.{rank}")) as fh:
            data = json.load(fh)
    except (OSError, ValueError):
        return None
    return data if data.get("stamp") == stamp else None


def _publish(save_dir: str, tag: str, ckpt_dir: str, final_dir: str,
             meta: Dict, world: int, stamp: str, save_latest: bool) -> None:
    """Rank 0: wait for every rank's marker of this save, merge the
    checksums, rename the staging tree into place, then move ``latest``."""
    deadline = time.time() + _COMMIT_TIMEOUT_S
    while True:
        markers = [_marker(ckpt_dir, r, stamp) for r in range(world)]
        if all(m is not None for m in markers):
            break
        if time.time() > deadline:
            raise TimeoutError(
                f"checkpoint '{tag}': not all {world} ranks wrote their "
                f"shards within {_COMMIT_TIMEOUT_S}s; 'latest' not moved")
        time.sleep(0.05)
    crcs: Dict[str, int] = {}
    for m in markers:
        crcs.update(m["crc"])
    referenced = set()
    for info in meta["arrays"].values():
        for shard in info["shards"]:
            referenced.add(shard["file"])
            if shard["file"] in crcs:
                shard["crc32"] = crcs[shard["file"]]
    arrays_dir = os.path.join(ckpt_dir, "arrays")
    for name in os.listdir(arrays_dir):
        if name not in referenced:
            os.remove(os.path.join(arrays_dir, name))
    with open(os.path.join(ckpt_dir, "metadata.json"), "w") as fh:
        json.dump(meta, fh, indent=1)
    trash = None
    if os.path.isdir(final_dir):
        trash = final_dir + ".replaced.tmp"
        if os.path.isdir(trash):
            shutil.rmtree(trash)
        os.rename(final_dir, trash)
    os.rename(ckpt_dir, final_dir)
    if trash is not None:
        shutil.rmtree(trash, ignore_errors=True)
    if save_latest:
        tmp = os.path.join(save_dir, ".latest.tmp")
        with open(tmp, "w") as fh:
            fh.write(tag)
        os.replace(tmp, os.path.join(save_dir, "latest"))


def _await_publish(final_dir: str, tag: str, stamp: str) -> None:
    meta_path = os.path.join(final_dir, "metadata.json")
    deadline = time.time() + _COMMIT_TIMEOUT_S
    while time.time() < deadline:
        try:
            with open(meta_path) as fh:
                if json.load(fh).get("save_stamp") == stamp:
                    return
        except (OSError, ValueError):
            pass
        time.sleep(0.05)
    raise TimeoutError(f"checkpoint '{tag}': rank 0 never published the "
                       f"tag within {_COMMIT_TIMEOUT_S}s")


# ---------------------------------------------------------------------------
# the reader
# ---------------------------------------------------------------------------


class CheckpointReader:
    """The arrays of one committed tag: ``read_range(key, lo, hi)`` gives
    elements [lo, hi) of an array in C order as a torch tensor of the stored
    dtype."""

    def __init__(self, load_dir: str, tag: str):
        self.tag = tag
        ckpt_dir = os.path.join(load_dir, tag)
        meta_path = os.path.join(ckpt_dir, "metadata.json")
        if not os.path.exists(meta_path):
            raise FileNotFoundError(
                f"checkpoint metadata not found: {meta_path}")
        with open(meta_path) as fh:
            self.meta = json.load(fh)
        if self.meta.get("format", 1) != 2:
            raise ValueError(
                f"checkpoint '{tag}' uses format {self.meta.get('format', 1)}"
                "; this loader reads the sharded format 2")
        self.arrays = self.meta["arrays"]
        self.arrays_dir = os.path.join(ckpt_dir, "arrays")
        self.client_state = dict(self.meta.get("client_state", {}))
        self.client_state.setdefault("_checkpoint_tag", tag)

    def __contains__(self, key: str) -> bool:
        return key in self.arrays

    def shape(self, key: str) -> Tuple[int, ...]:
        if key not in self.arrays:
            raise KeyError(f"checkpoint '{self.tag}' has no array '{key}' "
                           "(a model or optimizer mismatch?)")
        return tuple(self.arrays[key]["shape"])

    def read_range(self, key: str, lo: int, hi: int) -> torch.Tensor:
        return self.read_boxes(key, range_boxes(self.shape(key), lo, hi))

    def read_boxes(self, key: str, boxes: List[List[List[int]]]
                   ) -> torch.Tensor:
        """The elements of ``boxes`` of an array, each in C order, one after
        the other (flat)."""
        if key not in self.arrays:
            raise KeyError(f"checkpoint '{self.tag}' has no array '{key}' "
                           "(a model or optimizer mismatch?)")
        info = self.arrays[key]
        parts = [_assemble_slice(self.arrays_dir, info, box).reshape(-1)
                 for box in boxes]
        flat = np.concatenate(parts) if len(parts) != 1 else parts[0]
        return _from_numpy(flat, info["dtype"])

    def read(self, key: str) -> torch.Tensor:
        shape = self.shape(key)
        return self.read_range(key, 0, math.prod(shape)).view(shape)


def open_checkpoint(load_dir: str, tag: Optional[str] = None,
                    verify: bool = False) -> Optional[CheckpointReader]:
    """The reader of ``tag`` (default: ``latest``), or None when the
    directory holds no checkpoint. ``verify``: re-hash first and fall back
    to the newest tag that verifies clean."""
    if verify:
        if tag is None and read_latest_tag(load_dir) is None \
                and not list_tags(load_dir):
            logger.warning(f"no checkpoints in {load_dir}; nothing restored")
            return None
        tag = find_verified_tag(load_dir, tag)
    tag = tag or read_latest_tag(load_dir)
    if tag is None:
        logger.warning(f"no 'latest' file in {load_dir}; nothing restored")
        return None
    return CheckpointReader(load_dir, tag)


# ---------------------------------------------------------------------------
# the engine's state <-> arrays
# ---------------------------------------------------------------------------


def optax_keys(opt_config) -> Tuple[str, str]:
    """Where the JAX engine's optax chain keeps, for this optimizer config,
    the Adam state (count, mu, nu) and the schedule's count (JAX
    ``build_optax_transform``: ``adamw`` = [adam, decay, schedule],
    ``adam`` = [adam, schedule], adam with coupled decay = [decay, [adam,
    schedule]], ``lamb`` and ``onebitlamb`` = [adam, decay, trust ratio,
    schedule], ``zerooneadam`` = [0/1 Adam, schedule]; ``onebitadam`` and
    ``cpuadam`` build the Adam chains)."""
    name = opt_config.type.lower()
    params = opt_config.params
    if name in ("lamb", "onebitlamb"):
        return "0", "3"
    if name == "zerooneadam":
        return "0", "1"
    if name == "adamw":
        return "0", "2"
    wd = params.get("weight_decay", 0.0)
    if wd and params.get("adam_w_mode", name != "adam"):
        return "0", "2"
    if wd:
        return f"1{_SEP}0", f"1{_SEP}1"
    return "0", "1"


def _join(*parts) -> str:
    return _SEP.join(parts)


def _leaf_key(path: Tuple[str, ...]) -> str:
    return _SEP.join(path)


def _scalar(key: str, value: int, rank: int) -> ArrayPlan:
    a = ArrayPlan(key, (), "int32")
    a.add([], (lambda: np.asarray(value, np.int32)) if rank == 0 else None)
    return a


def _plans(engine, prefix: str, shard: torch.Tensor,
           whole: Dict[int, torch.Tensor]) -> List[ArrayPlan]:
    """One ``ArrayPlan`` a leaf for a buffer laid out as the params are:
    ``shard`` the rank's shard of it, ``whole[i]`` unit ``i``'s whole
    buffer where every rank holds all of it (rank 0 writes those leaves;
    every other leaf is written by each rank as the boxes of its range).
    An expert leaf is the rank's banks of the global leaf: its boxes sit at
    the banks' offset, and banks held whole are written by the first rank
    of each expert-data group."""
    part = engine.partition
    topo = part.topology
    dtype = _DTYPE_STR[shard.dtype]
    plans = []
    for path, plist in part.leaf_pieces().items():
        first = plist[0][1]
        shape = first.shape
        plan = ArrayPlan(_join(prefix, _leaf_key(path)),
                         part.global_shape(first), dtype)
        plans.append(plan)
        if all(i in whole for i, _ in plist):
            def data(plist=plist, shape=shape):
                leaf = torch.cat([whole[i][pc.offset:pc.offset + pc.numel]
                                  for i, pc in plist])
                return _to_numpy(leaf).reshape(shape)
            writers = ([0] if first.expert_axis is None
                       else [e * topo.data for e in range(topo.ep)])
            for r in writers:
                plan.add(part.global_box(first, [[0, d] for d in shape], r),
                         data if part.rank == r else None)
            continue
        for r in range(part.world):
            for i, pc in plist:
                for got, start, count, pos in part.rank_pieces(i, r):
                    if got != pc:
                        continue
                    at = part.shard_offsets[i] + pos
                    for box in range_boxes(shape, start, start + count):
                        n = math.prod(_box_shape(box))
                        fn = None
                        if r == part.rank:
                            def fn(at=at, n=n, box_shape=_box_shape(box)):
                                return _to_numpy(shard[at:at + n]).reshape(
                                    box_shape)
                        plan.add(part.global_box(pc, box, r), fn)
                        at += n
    return plans


def engine_arrays(engine) -> List[ArrayPlan]:
    """The arrays of ``engine``'s state under the JAX engine's keys."""
    st = engine.opt_state
    engine.optimizer.skipped_steps(st)      # fold a pending fp16 skip
    part, zero = engine.partition, engine.zero

    def whole(buf):
        # units of one part: every rank holds all of them
        return {i: buf[part.shard_slice(i)]
                for i, u in enumerate(part.units) if u.parts == 1}

    arrays = _plans(engine, "params", zero.shard,
                    {**whole(zero.shard), **zero.full})
    if st.exp_avg is None:
        # the NVMe tier: the swap files are the optimizer state, saved as
        # the snapshot beside the tag (JAX engine.py:1873-1888)
        return arrays
    adam, sched = optax_keys(engine.config.optimizer)
    bufs = [("mu", st.exp_avg), ("nu", st.exp_avg_sq)]
    if st.master is not None and st.shard_param.dtype != torch.float32:
        # (the host tier keeps a master of fp32 params too: the params)
        arrays += _plans(engine, _join("opt", "master"), st.master,
                         whole(st.master))
    for name, buf in bufs:
        arrays += _plans(engine, _join("opt", "inner", adam, name), buf,
                         whole(buf))
    arrays += [_scalar(_join("opt", "inner", adam, "count"), st.inner_count,
                       part.rank),
               _scalar(_join("opt", "inner", sched, "count"), st.inner_count,
                       part.rank),
               _scalar(_join("opt", "count"), st.count, part.rank)]
    return arrays


def offload_arrays(engine) -> List[ArrayPlan]:
    """The arrays of a parameter-offload engine (world 1) in JAX's layout
    (JAX ``params_for_checkpoint`` / ``opt_state_arrays``, :1283-1343):
    ``params##<path>`` for every leaf in the tree's flatten order (sorted
    paths), each stack leaf one shard a block; ``opt##layer_master##<i>``,
    ``opt##layer_m##<i>``, ``opt##layer_v##<i>`` for stack leaf ``i`` in the
    same order (the index ``consolidate_checkpoint`` pairs them by);
    ``opt##res_master##<path>`` / ``res_m`` / ``res_v`` for the resident
    leaves; ``opt##step`` (int64), the applied steps."""
    ex = engine._param_offload
    rank = engine.rank
    res = {}
    at = 0
    for (path, shape), n in zip(ex.res_items, ex.res_numel):
        res[path] = (at, shape, n)
        at += n
    L = ex.num_layers

    def stack_plan(key: str, i: int, dtype: str, block_of) -> ArrayPlan:
        tail = ex.leaf_tails[i]
        plan = ArrayPlan(key, (L,) + tail, dtype)
        for g, (lo, hi) in enumerate(ex.bounds):
            def data(g=g, lo=lo, hi=hi):
                src = block_of(g)[ex.leaf_slice(g, i)]
                return _to_numpy(src).reshape((hi - lo,) + tail)
            plan.add([[lo, hi]] + [[0, d] for d in tail],
                     data if rank == 0 else None)
        return plan

    def res_plan(key: str, buf: torch.Tensor, path) -> ArrayPlan:
        off, shape, n = res[path]
        plan = ArrayPlan(key, shape, _DTYPE_STR[buf.dtype])
        plan.add([[0, d] for d in shape],
                 (lambda: _to_numpy(buf[off:off + n]).reshape(shape))
                 if rank == 0 else None)
        return plan

    arrays = []
    paths = sorted([("layers",) + p for p in ex.layer_paths] + list(res))
    for path in paths:
        key = _join("params", _leaf_key(path))
        if path[0] == "layers":
            arrays.append(stack_plan(key, ex.layer_paths.index(path[1:]),
                                     _DTYPE_STR[ex.dtype], ex.block_params))
        else:
            arrays.append(res_plan(key, ex.res_flat, path))
    for kind in ("master", "m", "v"):
        for i in range(len(ex.layer_paths)):
            arrays.append(stack_plan(_join("opt", f"layer_{kind}", str(i)),
                                     i, "float32",
                                     lambda g, kind=kind:
                                     getattr(ex, kind)[g]))
    for kind in ("master", "m", "v"):
        buf = ex.res_state(kind).float()
        for path in res:
            arrays.append(res_plan(_join("opt", f"res_{kind}",
                                         _leaf_key(path)), buf, path))
    step = ArrayPlan(_join("opt", "step"), (), "int64")
    step.add([], (lambda: np.asarray(ex.step_count, np.int64))
             if rank == 0 else None)
    return arrays + [step]


class StateKeys:
    """Where a checkpoint keeps each leaf's fp32 master and Adam moments,
    and its step counts, in either layout: the resident engines'
    (``opt##master##<path>`` for 16-bit params, ``opt##inner##<adam>##mu`` /
    ``nu``, the counts) or JAX's param-offload one (``opt##layer_master`` /
    ``layer_m`` / ``layer_v##<i>``, ``i`` the stack leaf's place among the
    metadata's ``params##layers##`` keys, as ``consolidate_checkpoint``
    pairs them; ``opt##res_*##<path>``; ``opt##step``). So each kind of
    engine loads the other's checkpoints."""

    _OFFLOAD = {"master": "master", "mu": "m", "nu": "v"}

    def __init__(self, reader: CheckpointReader, opt_config):
        self.reader = reader
        self.offload = _join("opt", "step") in reader
        head = _join("params", "layers") + _SEP
        self.layer_index = {k[len("params" + _SEP):]: i for i, k in
                            enumerate(k for k in reader.arrays
                                      if k.startswith(head))}
        self.adam = optax_keys(opt_config)[0]

    def key(self, kind: str, path: Tuple[str, ...]) -> Optional[str]:
        """The key of ``kind`` (master / mu / nu) of the leaf at ``path``;
        None for a master the checkpoint does not have (fp32 params)."""
        pkey = _leaf_key(path)
        if self.offload:
            name = self._OFFLOAD[kind]
            if path[0] == "layers":
                return _join("opt", f"layer_{name}",
                             str(self.layer_index[pkey]))
            return _join("opt", f"res_{name}", pkey)
        if kind == "master":
            key = _join("opt", "master", pkey)
            return key if key in self.reader else None
        return _join("opt", "inner", self.adam, kind, pkey)

    def counts(self) -> Tuple[int, int]:
        """(applied steps, attempted steps)."""
        r = self.reader
        if self.offload:
            step = int(r.read(_join("opt", "step")))
            return step, int(r.client_state.get("global_steps", step))
        return (int(r.read(_join("opt", "inner", self.adam, "count"))),
                int(r.read(_join("opt", "count"))))


@torch.no_grad()
def _load_offload(engine, reader: CheckpointReader,
                  load_optimizer_states: bool) -> None:
    """A checkpoint of either layout into a parameter-offload engine, a
    block at a time (the nvme tier rewrites its block files)."""
    ex = engine._param_offload
    keys = StateKeys(reader, engine.config.optimizer)
    params_key = lambda path: _join("params", _leaf_key(path))  # noqa: E731

    def stack(g: int, dst: torch.Tensor, key_of) -> None:
        lo, hi = ex.bounds[g]
        for i, path in enumerate(ex.layer_paths):
            n = ex.leaf_numel[i]
            dst[ex.leaf_slice(g, i)].copy_(
                reader.read_range(key_of(("layers",) + path), lo * n,
                                  hi * n))

    def resident(dst: torch.Tensor, key_of) -> None:
        at = 0
        for (path, shape), n in zip(ex.res_items, ex.res_numel):
            dst[at:at + n].copy_(reader.read_range(key_of(path), 0, n))
            at += n

    has_master = load_optimizer_states and keys.key(
        "master", ("layers",) + ex.layer_paths[0]) is not None
    master_key = ((lambda p: keys.key("master", p)) if has_master
                  else params_key)
    for g in range(ex.num_blocks):
        if ex.store is not None:
            host = torch.empty(ex.block_numel[g], dtype=ex.dtype)
            stack(g, host, params_key)
            ex.store.write_block_host(g, host)
        else:
            stack(g, ex.params[g], params_key)
        stack(g, ex.master[g], master_key)
        for kind, name in (("m", "mu"), ("v", "nu")):
            buf = getattr(ex, kind)[g]
            if load_optimizer_states:
                stack(g, buf, lambda p, name=name: keys.key(name, p))
            else:
                buf.zero_()
    resident(ex.res_flat, params_key)
    if ex.res_master is not None:
        resident(ex.res_master, master_key)
    for buf, name in ((ex.res_m, "mu"), (ex.res_v, "nu")):
        if load_optimizer_states:
            resident(buf, lambda p, name=name: keys.key(name, p))
        else:
            buf.zero_()
    if load_optimizer_states:
        ex.step_count, ex.attempts = keys.counts()
    else:
        # the executor's own count drives its schedule and bias correction
        ex.step_count = ex.attempts = int(
            reader.client_state.get("global_steps", 0))


def save_engine(engine, save_dir: str, tag: Optional[str],
                client_state: Optional[Dict], save_latest: bool,
                async_save: bool) -> str:
    tag = tag or f"global_step{engine.global_steps}"
    cs = dict(client_state or {})
    sched = engine.lr_scheduler
    cs.update({
        "global_steps": engine.global_steps,
        "micro_steps": engine.micro_steps,
        "skipped_steps": engine.skipped_steps,
        "loss_scale": float(engine.scaler_state.scale),
        "lr_scheduler": (sched.state_dict() if sched is not None
                         and hasattr(sched, "state_dict") else None)})
    arrays = (offload_arrays(engine) if engine._param_offload is not None
              else engine_arrays(engine))
    path = save_checkpoint(save_dir, tag, arrays, cs, save_latest,
                           engine.config.checkpoint.tag_validation,
                           async_save)
    swapper = _swapper(engine)
    if swapper is not None:
        # the final tag directory exists once the commit has renamed it
        wait_pending()
        swapper.snapshot_to(os.path.join(path, _snapshot_name(engine)))
        comm.barrier()
    log_dist(f"saved checkpoint {path}")
    return path


def _swapper(engine):
    st = engine.opt_state
    return st.offload if st is not None and st.exp_avg is None \
        and st.offload is not None else None


def _snapshot_name(engine) -> str:
    return f"nvme_state_p{engine.rank}"


def _fill(engine, reader: CheckpointReader, key_of: Callable[[Tuple], str],
          shard: torch.Tensor,
          whole: Optional[Dict[int, torch.Tensor]] = None) -> None:
    """Read a buffer laid out as the params are: the rank's ranges into
    ``shard``, and unit ``i`` whole into ``whole[i]`` where given."""
    part = engine.partition
    whole = whole or {}

    def read(pc, start, count):
        # elements [start, start + count) of the rank's copy of the leaf
        boxes = range_boxes(pc.shape, start, start + count)
        return reader.read_boxes(key_of(pc.path), [
            part.global_box(pc, box, part.rank) for box in boxes])

    with torch.no_grad():
        for i, u in enumerate(part.units):
            if i in whole:
                for pc in u.pieces:
                    whole[i][pc.offset:pc.offset + pc.numel].copy_(
                        read(pc, pc.start, pc.numel))
                lo, hi = part.rank_range(i, part.rank)
                shard[part.shard_slice(i)].copy_(whole[i][lo:hi])
                continue
            base = part.shard_offsets[i]
            for pc, start, count, pos in part.rank_pieces(i, part.rank):
                shard[base + pos:base + pos + count].copy_(
                    read(pc, start, count))


def load_engine(engine, load_dir: str, tag: Optional[str],
                load_optimizer_states: bool, load_lr_scheduler_states: bool,
                verify: bool) -> Tuple[Optional[str], Dict]:
    reader = open_checkpoint(load_dir, tag, verify)
    if reader is None:
        return None, {}
    if engine._param_offload is not None:
        _load_offload(engine, reader, load_optimizer_states)
        _load_counters(engine, reader, load_dir, load_lr_scheduler_states)
        engine._param_offload.scaler_state = engine.scaler_state
        return load_dir, reader.client_state
    zero, st = engine.zero, engine.opt_state
    params_key = lambda path: _join("params", _leaf_key(path))  # noqa: E731
    _fill(engine, reader, params_key, zero.shard, zero.full)
    swapper = _swapper(engine)
    if swapper is not None:
        steps = reader.client_state.get("global_steps", 0)
        if load_optimizer_states:
            # the snapshot of the tag the reader resolved (JAX
            # engine.py:1968-1998)
            src = os.path.join(load_dir, reader.tag, _snapshot_name(engine))
            if not os.path.isdir(src):
                raise RuntimeError(
                    f"checkpoint has no {_snapshot_name(engine)} snapshot "
                    f"at {src}: the NVMe optimizer state cannot be restored "
                    "(load_optimizer_states=False restores the params)")
            swapper.restore_snapshot(src, steps)
            st.count = st.inner_count = steps
        else:
            swapper.init_from_shard(zero.shard)
            st.count = st.inner_count = 0
        st.pending_skip = None
    elif load_optimizer_states:
        keys = StateKeys(reader, engine.config.optimizer)
        if st.master is not None:
            has = keys.key("master", next(iter(
                engine.partition.leaf_pieces()))) is not None
            _fill(engine, reader,
                  (lambda p: keys.key("master", p)) if has
                  and st.shard_param.dtype != torch.float32
                  else params_key, st.master)
        for name, buf in (("mu", st.exp_avg), ("nu", st.exp_avg_sq)):
            _fill(engine, reader, lambda p, name=name: keys.key(name, p),
                  buf)
        st.inner_count, st.count = keys.counts()
        st.pending_skip = None
    elif st.master is not None:
        # params only: the master follows the loaded params, the moments
        # and counts start afresh
        st.master.copy_(st.shard_param.float())
    _load_counters(engine, reader, load_dir, load_lr_scheduler_states)
    return load_dir, reader.client_state


def _load_counters(engine, reader: CheckpointReader, load_dir: str,
                   load_lr_scheduler_states: bool) -> None:
    """The step counters, the loss scale and the schedule's state."""
    cs = reader.client_state
    engine.global_steps = cs.get("global_steps", 0)
    engine.micro_steps = cs.get("micro_steps", 0)
    engine.skipped_steps = cs.get("skipped_steps", 0)
    if "loss_scale" in cs:
        engine.scaler_state = engine.scaler_state._replace(
            scale=torch.full_like(engine.scaler_state.scale,
                                  float(cs["loss_scale"])))
    sched = engine.lr_scheduler
    if (load_lr_scheduler_states and sched is not None
            and cs.get("lr_scheduler") is not None
            and hasattr(sched, "load_state_dict")):
        sched.load_state_dict(cs["lr_scheduler"])
    log_dist(f"loaded checkpoint from {load_dir} (tag={reader.tag})")


# ---------------------------------------------------------------------------
# flat weight files
# ---------------------------------------------------------------------------


def _write_flat_npz(path: str, flat: Dict[str, np.ndarray],
                    dtypes: Dict[str, str]) -> str:
    """The one flat-npz writer; returns the path on disk (np.savez appends
    '.npz' when the suffix is missing)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    np.savez(path, __dtypes__=json.dumps(dtypes), **flat)
    return path


def save_flat_weights(params: Any, path: str) -> str:
    """A whole params tree as one flat npz (JAX ``save_flat_weights``):
    ``__dtypes__`` and one array a leaf under its ``##``-joined path, bf16
    as uint16 bits."""
    flat, dtypes = {}, {}
    for p, t in tree_items(params):
        flat[_leaf_key(p)] = _to_numpy(t)
        dtypes[_leaf_key(p)] = _DTYPE_STR[t.dtype]
    return _write_flat_npz(path, flat, dtypes)


def load_flat_weights(path: str) -> Dict[str, torch.Tensor]:
    """The leaves of a flat npz as tensors of their recorded dtypes."""
    data = np.load(path, allow_pickle=False)
    dtypes = json.loads(str(data["__dtypes__"]))
    return {k: _from_numpy(data[k], dtypes[k]) for k in data.files
            if k != "__dtypes__"}


def consolidate_checkpoint(load_dir: str, out_path: str,
                           tag: Optional[str] = None,
                           prefer_master: bool = True) -> str:
    """A format-2 checkpoint -> one fp32 flat npz, offline (JAX
    ``consolidate_checkpoint``, the ``zero_to_fp32.py`` analog): each
    param from its fp32 master when the checkpoint has one and
    ``prefer_master``, else the param widened. Reads the JAX param-offload
    layouts' masters too (``opt##res_master``, ``opt##layer_master##i``)."""
    reader = open_checkpoint(load_dir, tag)
    if reader is None:
        raise FileNotFoundError(f"no 'latest' file in {load_dir} and no "
                                "tag given")
    arrays = reader.arrays
    head = "params" + _SEP
    layer_keys = [k for k in arrays if k.startswith(head + "layers" + _SEP)]
    master_of: Dict[str, str] = {}
    for full_key in arrays:
        if not full_key.startswith(head):
            continue
        pkey = full_key[len(head):]
        for cand in (_join("opt", "master", pkey),
                     _join("opt", "res_master", pkey)):
            if cand in arrays:
                master_of[full_key] = cand
    for i, k in enumerate(layer_keys):
        cand = _join("opt", "layer_master", str(i))
        if cand in arrays:
            master_of[k] = cand
    flat: Dict[str, np.ndarray] = {}
    used_master = 0
    for full_key in arrays:
        if not full_key.startswith(head):
            continue
        src = full_key
        if prefer_master and full_key in master_of:
            src = master_of[full_key]
            used_master += 1
        if arrays[src]["shape"] != arrays[full_key]["shape"]:
            raise ValueError(
                f"consolidate: master '{src}' shape {arrays[src]['shape']} "
                f"!= param '{full_key}' shape {arrays[full_key]['shape']}")
        flat[full_key[len(head):]] = reader.read(src).float().numpy()
    if not flat:
        raise ValueError(f"{load_dir}/{reader.tag}: no params arrays")
    if prefer_master and used_master == 0:
        logger.warning(f"{load_dir}/{reader.tag}: no fp32 master arrays; "
                       "exporting the params widened to fp32")
    return _write_flat_npz(out_path, flat, {k: "float32" for k in flat})

