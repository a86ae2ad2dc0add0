"""Hopper kernel library: build, load, launch counts.

Counterpart of ``deepspeed_tpu/ops/registry.py``. The JAX package picks a
Pallas kernel or its jnp reference by probing the platform; the port routes
by the tensor's device instead (each wrapper in ``ops/`` takes its plain
version for a CPU tensor and launches its kernel for a CUDA tensor), so what
is left here is the kernel library itself:

* ``library(name)`` builds ``csrc/<name>.cu`` at first use with ``nvcc`` for
  ``sm_90a`` into a shared library with a plain C interface and loads it
  with ``ctypes``. Every source is compiled by its own ``nvcc`` process, all
  started together. Each library is keyed by a hash of its own source, the
  headers and the flags (``build/torch_kernels/<name>-<hash>.so`` at the
  checkout root), so an edited source is rebuilt alone and an unchanged one
  is loaded as it is; ``library`` builds only its own source when that
  library is missing, ``build`` every missing one.
* ``function(source, symbol, argtypes)``: a C entry point bound once.
* ``check_launch`` / ``launch_counts`` / ``reset_launch_counts``: one plain
  integer per kernel, incremented by its wrapper each time it launches the
  kernel (and the launch reported no error), so a run can show that its
  path went through the kernels.
* ``op_report()``: each kernel, its launch count, and whether the library
  was built in this process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# kernel name -> the source (csrc/<source>.cu) whose library holds it
KERNELS: Dict[str, str] = {
    "fused_layer_norm": "layer_norm",
    "paged_decode_attention": "paged_attention",
    "paged_prefill_attention": "paged_attention",
    "flash_attention": "flash_attention",
    "decode_attention": "decode_attention",
    "flash_attention_bwd_dq": "flash_attention_bwd",
    "flash_attention_bwd_dkv": "flash_attention_bwd",
    "fused_adam": "fused_adam",
    "int8_matmul": "quant_matmul",
    "int8_a8_matmul": "quant_matmul_a8",
    "int4_matmul": "quant_matmul",
    "int4_a8_matmul": "quant_matmul_a8",
    "block_sparse_attention_fwd": "block_sparse_attention",
    "block_sparse_attention_bwd_dq": "block_sparse_attention",
    "block_sparse_attention_bwd_dkv": "block_sparse_attention",
    "fused_lamb": "fused_lamb",
    "fused_group_norm": "group_norm",
    "quantize_symmetric": "quantization",
}

_launches: Dict[str, int] = {name: 0 for name in KERNELS}
_libs: Dict[str, ctypes.CDLL] = {}
_functions: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels of "
        "deepspeed_tpu_torch are compiled from csrc/ at first use")


def _sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def source_key(name: str, csrc: Path = CSRC) -> str:
    """Hash of the flags, every header (``*.cuh``, ``*.h``) and
    ``<csrc>/<name>.cu``: what one source's library depends on."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(csrc.glob("*.cuh")) + sorted(csrc.glob("*.h")) \
            + [csrc / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    """``build/torch_kernels/<name>-<source_key(name)>.so``: an edited
    source gets a new path and is rebuilt; the others keep theirs."""
    return BUILD_ROOT / f"{name}-{source_key(name)}.so"


def _compile(names, verbose: bool) -> None:
    """One ``nvcc`` process per source, all running at once; raises with
    the compiler's output when a build fails."""
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in names:
        out = library_path(name)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if verbose and log:
            print(f"[nvcc {name}]\n{log}", flush=True)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def build(verbose: bool = False) -> Path:
    """Compile every ``csrc/*.cu`` whose library is missing for its current
    key, all in parallel. Returns the directory of the libraries."""
    todo = [name for name in _sources() if not library_path(name).exists()]
    if todo:
        _compile(todo, verbose)
    return BUILD_ROOT


def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>.cu``, built on first use (that
    source alone, when its library is missing)."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            path = library_path(source)
            if not path.exists():
                _compile([source], False)
            lib = ctypes.CDLL(str(path))
            _libs[source] = lib
        return lib


def function(source: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """``symbol`` of ``library(source)`` with its ``argtypes`` set and an
    int return, bound once and then taken from a cache."""
    fn = _functions.get((source, symbol))
    if fn is None:
        fn = getattr(library(source), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[(source, symbol)] = fn
    return fn


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def check_launch(name: str, err: int) -> None:
    """Raise when the C entry point reported a CUDA error (the return value
    of ``cudaGetLastError()`` right after the launch), else count it."""
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    _launches[name] += 1


def op_report() -> str:
    """Kernel / source / launches / library-built table."""
    lines = [f"{'kernel':<32}{'source':<36}{'launches':<10}built", "-" * 84]
    for name, src in KERNELS.items():
        lines.append(f"{name:<32}{'csrc/' + src + '.cu':<36}"
                     f"{_launches[name]:<10}{'yes' if src in _libs else 'no'}")
    return "\n".join(lines)
