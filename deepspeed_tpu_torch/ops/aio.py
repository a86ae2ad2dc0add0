"""Async file I/O: a handle over the host thread-pool extension.

Counterpart of ``deepspeed_tpu/ops/aio.py`` (reference ``ops/aio``
``aio_handle``: ``async_pread`` / ``async_pwrite`` / ``wait``, a bounded
queue of ``queue_depth`` ops over ``num_threads`` workers; the config's
``block_size`` / ``single_submit`` / ``overlap_events`` are accepted and
ignored, ``config.AIOConfig``). The native side is the port's ``csrc/ds_aio.cpp``, compiled by
``g++`` at first use into ``build/torch_kernels/ds_aio-<hash>.so``
(``registry.host_library``); a failed build raises, and there is no Python
file-I/O fallback. Buffers are C-contiguous CPU tensors (pinned or not) or
numpy arrays; only their address crosses into C, so the handle keeps each
one alive until the ``wait`` that fences it.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple, Union

import numpy as np
import torch

from . import registry

Buffer = Union[torch.Tensor, np.ndarray]


def _lib() -> ctypes.CDLL:
    lib = registry.host_library("ds_aio")
    if not getattr(lib, "_dstt_bound", False):
        lib.dsaio_create.restype = ctypes.c_void_p
        lib.dsaio_create.argtypes = [ctypes.c_int] * 2
        lib.dsaio_destroy.argtypes = [ctypes.c_void_p]
        lib.dsaio_open.restype = ctypes.c_int
        lib.dsaio_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                   ctypes.c_int]
        lib.dsaio_close.argtypes = [ctypes.c_int]
        for fn in (lib.dsaio_submit_pread, lib.dsaio_submit_pwrite):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_long, ctypes.c_long]
        lib.dsaio_wait.restype = ctypes.c_long
        lib.dsaio_wait.argtypes = [ctypes.c_void_p]
        lib._dstt_bound = True
    return lib


def _pointer(buf: Buffer) -> Tuple[int, int]:
    """(address, bytes) of a C-contiguous host buffer."""
    if isinstance(buf, np.ndarray):
        if not buf.flags["C_CONTIGUOUS"]:
            raise ValueError("aio buffers must be C-contiguous")
        return buf.ctypes.data, buf.nbytes
    if buf.device.type != "cpu" or not buf.is_contiguous():
        raise ValueError("aio buffers must be contiguous CPU tensors, got "
                         f"{buf.device} contiguous={buf.is_contiguous()}")
    return buf.data_ptr(), buf.numel() * buf.element_size()


class AIOHandle:
    """Bounded-queue async positional reads / writes over a pool of
    ``num_threads`` workers; ``wait()`` fences every op submitted so far."""

    def __init__(self, queue_depth: int = 32, num_threads: int = 4):
        self._lib = _lib()
        self._h = self._lib.dsaio_create(queue_depth, num_threads)
        if not self._h:
            raise RuntimeError("failed to create an aio handle")
        self.queue_depth = queue_depth
        self._pending: List[Tuple[int, Buffer]] = []

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.dsaio_destroy(self._h)
            self._h = None
            for fd, _ in self._pending:
                self._lib.dsaio_close(fd)
            self._pending = []

    __del__ = close

    def _submit(self, write: bool, buf: Buffer, path: str,
                offset: int) -> int:
        addr, nbytes = _pointer(buf)
        fd = self._lib.dsaio_open(path.encode(), int(write), 0)
        if fd < 0:
            raise OSError(f"cannot open {path} for "
                          f"{'write' if write else 'read'}")
        fn = (self._lib.dsaio_submit_pwrite if write
              else self._lib.dsaio_submit_pread)
        rc = fn(self._h, fd, addr, nbytes, offset)
        self._pending.append((fd, buf))
        return rc

    def async_pwrite(self, buf: Buffer, path: str, offset: int = 0) -> int:
        return self._submit(True, buf, path, offset)

    def async_pread(self, buf: Buffer, path: str, offset: int = 0) -> int:
        return self._submit(False, buf, path, offset)

    def wait(self) -> int:
        """Fence every submitted op; returns the handle's completed count
        so far, raises ``OSError`` when an op failed."""
        done = self._lib.dsaio_wait(self._h)
        for fd, _ in self._pending:
            self._lib.dsaio_close(fd)
        self._pending = []
        if done < 0:
            raise OSError(f"{-done} aio operation(s) failed")
        return int(done)

    def sync_pwrite(self, buf: Buffer, path: str, offset: int = 0) -> int:
        self.async_pwrite(buf, path, offset)
        return self.wait()

    def sync_pread(self, buf: Buffer, path: str, offset: int = 0) -> int:
        self.async_pread(buf, path, offset)
        return self.wait()
