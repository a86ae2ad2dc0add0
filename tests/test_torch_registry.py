"""The port's kernel registry on the CPU (no nvcc needed): each library is
keyed by its own source, the headers and the flags, so an edit to one
``csrc/*.cu`` rebuilds that source alone; C entry points are bound once."""

import ctypes
import shutil

import pytest

from deepspeed_tpu_torch.ops import registry


@pytest.fixture
def csrc_copy(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(registry.CSRC, dst)
    return dst


def keys(csrc):
    return {p.stem: registry.source_key(p.stem, csrc)
            for p in sorted(csrc.glob("*.cu"))}


def test_every_kernel_source_has_a_key():
    sources = set(registry.KERNELS.values())
    assert sources <= set(keys(registry.CSRC))
    assert "quant_matmul_a8" in sources
    path = registry.library_path("quant_matmul_a8")
    assert path.parent == registry.BUILD_ROOT
    assert path.name == ("quant_matmul_a8-"
                         f"{registry.source_key('quant_matmul_a8')}.so")


@pytest.mark.parametrize("edited", ["quant_matmul_a8", "quant_matmul",
                                    "flash_attention"])
def test_editing_a_source_changes_its_key_alone(csrc_copy, edited):
    before = keys(csrc_copy)
    assert len(set(before.values())) == len(before)
    src = csrc_copy / f"{edited}.cu"
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    after = keys(csrc_copy)
    assert after[edited] != before[edited]
    assert {k: v for k, v in after.items() if k != edited} == \
        {k: v for k, v in before.items() if k != edited}


def test_editing_a_header_changes_every_key(csrc_copy):
    headers = sorted(csrc_copy.glob("*.cuh")) + sorted(csrc_copy.glob("*.h"))
    assert headers
    before = keys(csrc_copy)
    headers[0].write_bytes(headers[0].read_bytes() + b"\n// edited\n")
    after = keys(csrc_copy)
    assert all(after[k] != before[k] for k in before)


def test_flags_are_in_every_key(csrc_copy, monkeypatch):
    before = keys(csrc_copy)
    monkeypatch.setattr(registry, "NVCC_FLAGS", registry.NVCC_FLAGS + ("-G",))
    after = keys(csrc_copy)
    assert all(after[k] != before[k] for k in before)


def test_function_is_bound_once(monkeypatch):
    libc = ctypes.CDLL(None)
    loads = []

    def library(source):
        loads.append(source)
        return libc

    monkeypatch.setattr(registry, "library", library)
    monkeypatch.setattr(registry, "_functions", {})
    first = registry.function("libc", "abs", [ctypes.c_int])
    again = registry.function("libc", "abs", [ctypes.c_int])
    assert first is again and loads == ["libc"]
    assert first.argtypes == [ctypes.c_int] and first(-3) == 3
