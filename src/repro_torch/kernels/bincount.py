"""CUDA kernel: weighted histogram (the paper's global result update).

The port of the JAX package's ``weighted_bincount_pallas``
(src/repro/kernels/bincount.py).  The TPU has no atomics and built one-hot
matmuls instead; the card has them, so ``csrc/bincount.cu`` is the paper's
own form (G-TADOC §IV-C): ``atomicAdd`` of each value into its bin, ids
outside ``[0, nbins)`` skipped.  The plain version is
``ref.weighted_bincount_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _common

launches = _common.launch_counter("weighted_bincount")

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_void_p]


def weighted_bincount_cuda(ids: torch.Tensor, vals: torch.Tensor,
                           nbins: int) -> torch.Tensor:
    """out[b] = sum(vals[ids == b]) for b in [0, nbins), on the card.

    ids: [n] int32; vals: [n] float32 — contiguous, on one CUDA device.
    """
    n = ids.shape[0]
    dev = ids.device
    if not 0 <= nbins < 2 ** 31:
        raise ValueError(f"nbins={nbins} outside the kernel's int32 range")
    _common.require_hopper(dev)
    _common.check_cuda_tensor("ids", ids, torch.int32, (n,), dev)
    _common.check_cuda_tensor("vals", vals, torch.float32, (n,), dev)
    out = torch.zeros(nbins, dtype=torch.float32, device=dev)
    fn = _common.kernel_fn("repro_weighted_bincount", _ARGTYPES)
    err = fn(ids.data_ptr(), vals.data_ptr(), out.data_ptr(), n, nbins,
             _common.stream_ptr(dev))
    _common.check_launch(err, "weighted_bincount")
    launches.inc()
    return out
