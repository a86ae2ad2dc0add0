"""The port's async-I/O handle (``ops/aio.py`` over ``csrc/ds_aio.cpp``,
built with g++ at first use), the counterparts of the JAX package's
``tests/unit/test_aio.py``: a round trip, parallel writes then reads, an
offset read, a read error that surfaces, the config knobs; over CPU tensors
(pinned or not) and numpy arrays. No JAX here."""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.config import AIOConfig
from deepspeed_tpu_torch.ops import registry
from deepspeed_tpu_torch.ops.aio import AIOHandle


def test_built_by_the_host_compiler_under_its_hash():
    path = registry.host_library_path("ds_aio")
    assert path.parent == registry.BUILD_ROOT
    assert path.name.startswith("ds_aio-") and path.suffix == ".so"
    registry.host_library("ds_aio")
    assert path.exists()


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_sync_roundtrip(tmp_path, kind):
    h = AIOHandle(queue_depth=4, num_threads=2)
    data = np.frombuffer(np.random.RandomState(0).bytes(1 << 16),
                         np.uint8).copy()
    arr = data if kind == "numpy" else torch.from_numpy(data)
    path = str(tmp_path / "blob.bin")
    assert h.sync_pwrite(arr, path) == 1
    out = np.zeros_like(data) if kind == "numpy" else torch.zeros(
        data.size, dtype=torch.uint8)
    assert h.sync_pread(out, path) == 2   # the completed count accumulates
    np.testing.assert_array_equal(np.asarray(out), data)
    h.close()


def test_parallel_writes_then_reads(tmp_path):
    h = AIOHandle(queue_depth=8, num_threads=4)
    arrays = [torch.full((1 << 14,), float(i)) for i in range(8)]
    for i, a in enumerate(arrays):
        h.async_pwrite(a, str(tmp_path / f"f{i}.bin"))
    h.wait()
    outs = [torch.empty_like(a) for a in arrays]
    for i, o in enumerate(outs):
        h.async_pread(o, str(tmp_path / f"f{i}.bin"))
    h.wait()
    for a, o in zip(arrays, outs):
        assert torch.equal(a, o)
    h.close()


def test_offset_read(tmp_path):
    h = AIOHandle()
    arr = (np.arange(4096) % 251).astype(np.uint8)
    path = str(tmp_path / "off.bin")
    h.sync_pwrite(arr, path)
    part = torch.zeros(1024, dtype=torch.uint8)
    h.sync_pread(part, path, offset=1024)
    np.testing.assert_array_equal(part.numpy(), arr[1024:2048])
    h.close()


def test_read_error_surfaces(tmp_path):
    h = AIOHandle()
    buf = torch.zeros(128, dtype=torch.uint8)
    with pytest.raises(OSError):
        h.sync_pread(buf, str(tmp_path / "missing.bin"))
    short = str(tmp_path / "short.bin")
    h.sync_pwrite(np.zeros(16, np.uint8), short)
    with pytest.raises(OSError, match="failed"):   # a read past the end
        h.sync_pread(buf, short)
    h.close()


def test_buffers_must_be_contiguous_host_memory(tmp_path):
    h = AIOHandle()
    with pytest.raises(ValueError, match="contiguous"):
        h.async_pwrite(torch.zeros(8, 2).t(), str(tmp_path / "x"))
    h.close()


def test_config_knobs_kept():
    """The handle takes the queue depth and threads; the aio section's
    other knobs load from a JAX config and are ignored."""
    h = AIOHandle(queue_depth=16, num_threads=2)
    assert h.queue_depth == 16
    h.close()
    cfg = AIOConfig.from_dict({"block_size": 1 << 19, "queue_depth": 16,
                               "single_submit": True,
                               "overlap_events": False, "thread_count": 2})
    assert (cfg.block_size, cfg.single_submit, cfg.overlap_events) == (
        1 << 19, True, False)
