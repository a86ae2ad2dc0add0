"""Error-feedback compressed all-reduce: the 1-bit optimizers' exchange.

Counterpart of ``deepspeed_tpu/comm/compressed.py`` (reference
``runtime/comm/nccl.py`` ``compressed_allreduce``). Gradients cross the wire
as int8 codes with one fp32 scale a rank, and each quantization's error is
fed back into the next step through two residuals, in two phases:

  phase 1  each rank quantizes (grad + worker residual) to int8; the codes,
           cut into ``world`` chunks, go through ``all_to_all`` (rank r
           receives every rank's chunk r) and the scales through
           ``all_gather``; rank r decodes and sums its chunk
  phase 2  rank r quantizes (its sum + server residual), the codes and the
           scales are all-gathered, and every rank decodes the whole sum

so a rank sends about 2 n bytes against a dense fp32 ring's 8 n. The
collectives are the port's ``comm.all_to_all`` / ``comm.all_gather``, so
the comms logger counts their bytes. At world 1 the exchange is a copy,
but the quantization and the error feedback still run.

``_quantize`` divides by tensors, never by a Python number: on a CUDA
tensor ATen turns ``x / python_float`` into a product with the reciprocal,
which rounds differently, and the codes must not depend on the device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import comm


def _quantize(v: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """v (n,) fp32 -> (int8 codes, scale () fp32, residual): symmetric, one
    scale max|v| / 127 for the vector. The residual overwrites ``v``."""
    scale = v.abs().max() / torch.full((), 127.0, device=v.device)
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    t = torch.div(v, safe)
    q = t.round_().clamp_(-127, 127).to(torch.int8)
    # v - q * scale, the product rounded first (one temporary: t)
    torch.mul(q, scale, out=t)
    return q, scale, v.sub_(t)


def _decode(codes: torch.Tensor, scales: torch.Tensor,
            out: torch.Tensor) -> torch.Tensor:
    """sum_r codes[r] * scales[r] over the (world, chunk) codes, in rank
    order, into ``out`` (chunk,)."""
    torch.mul(codes[0], scales[0], out=out)
    for r in range(1, codes.shape[0]):
        out.add_(codes[r].float().mul_(scales[r]))
    return out


def compressed_allreduce_flat(v: torch.Tensor, worker_res: torch.Tensor,
                              server_res: torch.Tensor, group=None,
                              out: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The mean over the group of every rank's flat fp32 ``v``, exchanged
    in int8 (JAX ``compressed_allreduce_flat``). ``v``'s length must be a
    multiple of the world size (``pad_to``); ``worker_res`` is (n,),
    ``server_res`` (n / world,), this rank's chunk. Returns (mean, new
    worker residual, new server residual): the residuals are updated in
    place, and the mean is written into ``out`` (which may be ``v``, read
    before it is written) or a new tensor."""
    world = comm.get_world_size(group)
    n = v.numel()
    if n % world:
        raise ValueError(f"compressed_allreduce_flat: length {n} is not a "
                         f"multiple of the world size {world}")
    chunk = n // world
    # phase 1: worker error feedback, quantize, exchange the chunks
    q, scale, new_worker = _quantize(worker_res.add_(v))
    recv = comm.all_to_all(q, group=group, log_name="onebit_all_to_all")
    del q
    scales = comm.all_gather(scale.reshape(1), group=group,
                             log_name="onebit_scale_gather")
    summed = _decode(recv.view(world, chunk), scales,
                     torch.empty(chunk, dtype=torch.float32,
                                 device=v.device))
    del recv
    # phase 2: server error feedback, quantize, gather
    sq, sscale, new_server = _quantize(server_res.add_(summed))
    del summed
    gathered = comm.all_gather(sq, group=group,
                               log_name="onebit_code_gather")
    del sq
    sscales = comm.all_gather(sscale.reshape(1), group=group,
                              log_name="onebit_scale_gather")
    out = torch.empty_like(v) if out is None else out
    codes = gathered.view(world, chunk)
    for r in range(world):
        dst = out[r * chunk:(r + 1) * chunk]
        torch.mul(codes[r], sscales[r], out=dst)
    out.div_(torch.full((), float(world), device=v.device))
    return out, new_worker, new_server


def pad_to(flat: torch.Tensor, multiple: int) -> torch.Tensor:
    """``flat`` zero-padded to a multiple of ``multiple`` elements (JAX
    ``tree_flatten_pad`` for a buffer that is flat already)."""
    pad = (-flat.numel()) % multiple
    return F.pad(flat, (0, pad)) if pad else flat


def padded_length(n: int, world: int) -> int:
    return n + (-n) % world
