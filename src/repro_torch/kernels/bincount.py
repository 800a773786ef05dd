"""CUDA kernel: weighted histogram (the paper's global result update).

The port of the JAX package's ``weighted_bincount_pallas``
(src/repro/kernels/bincount.py).  The TPU has no atomics and built one-hot
matmuls instead; the card has them, so ``csrc/bincount.cu`` is the paper's
own form (G-TADOC §IV-C): ``atomicAdd`` of each value into its bin, ids
outside ``[0, nbins)`` skipped, warp-aggregated over lanes that hit one
bin.  The kernel has a batch axis: row i of ``ids`` adds into row i of the
output, so the batched word count needs no flat-offset ids, and the 1-D
histogram is the batch of one row.  The C entry point zeroes the output on
the caller's stream itself.  The plain version is
``ref.weighted_bincount_ref``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _common

launches = _common.launch_counter("weighted_bincount")

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
             + [ctypes.c_int] * 3 + [ctypes.c_void_p])

#: Threads a block (the kernel is instantiated for each): the shipped
#: default and the shapes the autotuner sweeps.
DEFAULT_THREADS = 256
THREADS_CANDIDATES = (128, 256, 512, 1024)

_ID_TYPES = (torch.int32, torch.int64)


def weighted_bincount_cuda(ids: torch.Tensor, vals: torch.Tensor,
                           nbins: int,
                           out: Optional[torch.Tensor] = None,
                           threads: int = DEFAULT_THREADS) -> torch.Tensor:
    """Per row, out[i, b] = sum(vals[i][ids[i] == b]) for b in [0, nbins),
    on the card.

    ids: [T] or [rows, T] int32 or int64; vals: float32 of the same shape
    — contiguous, on one CUDA device.  Returns [nbins] for 1-D inputs,
    [rows, nbins] otherwise; ``out``, where given, is that contiguous
    float32 tensor, and the kernel overwrites it.  ``threads``: threads a
    block, one of ``THREADS_CANDIDATES``.
    """
    _common.check_launch_shape("threads", threads, THREADS_CANDIDATES)
    dev = ids.device
    if not 0 <= nbins < 2 ** 31:
        raise ValueError(f"nbins={nbins} outside the kernel's int32 range")
    if ids.dtype not in _ID_TYPES:
        raise TypeError(f"ids has dtype {ids.dtype}, expected int32 or "
                        f"int64")
    if ids.ndim not in (1, 2):
        raise ValueError(f"ids must be [T] or [rows, T], got "
                         f"{tuple(ids.shape)}")
    _common.require_hopper(dev)
    _common.check_cuda_tensor("ids", ids, ids.dtype, ids.shape, dev)
    _common.check_cuda_tensor("vals", vals, torch.float32, ids.shape, dev)
    rows, t = (1, ids.shape[0]) if ids.ndim == 1 else ids.shape
    shape = (nbins,) if ids.ndim == 1 else (rows, nbins)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=dev)
    else:
        _common.check_cuda_tensor("out", out, torch.float32, shape, dev)
    fn = _common.kernel_fn("repro_weighted_bincount", _ARGTYPES)
    err = fn(ids.data_ptr(), vals.data_ptr(), out.data_ptr(), rows, t,
             nbins, ids.element_size(), threads, _common.stream_ptr(dev))
    _common.check_launch(err, "weighted_bincount")
    launches.inc()
    return out
