"""CUDA kernel: one masked frontier round over the dense ELL plan.

The port of the JAX package's ``ell_propagate_batched_pallas``
(src/repro/kernels/propagate_batched.py).  The dense ELL *edge plan*
``src/freq [N, R, K]`` lists, in row ``r`` of corpus ``n``, the parents of
rule ``r`` (padding src=0 / freq=0), so one round is a gather + row sum
with no scatter:

  delta[n, r] = sum_k freq[n, r, k] * weight[n, src[n, r, k]]
                                    * active[n, src[n, r, k]]
  seen[n, r]  = sum_k [freq[n, r, k] > 0] * active[n, src[n, r, k]]

both from one pass over the plan.  The kernel is ``csrc/propagate_batched.cu``
(design and bound in its header); :func:`ell_propagate_batched_cuda` checks
its inputs, allocates the outputs and launches it on the current stream.
The plain version is ``ref.ell_propagate_batched_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _common

launches = _common.launch_counter("ell_propagate_batched")

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def ell_propagate_batched_cuda(weights: torch.Tensor, active: torch.Tensor,
                               src: torch.Tensor, freq: torch.Tensor):
    """(delta, seen), both [N, rows] float32, of one round on the card.

    weights/active: [N, R] float32; src: [N, rows, K] int32 with every
    entry in [0, R); freq: [N, rows, K] float32 — all contiguous, on one
    CUDA device.
    """
    n, rows, k = src.shape
    R = weights.shape[1]
    dev = src.device
    _common.require_hopper(dev)
    _common.check_cuda_tensor("weights", weights, torch.float32, (n, R), dev)
    _common.check_cuda_tensor("active", active, torch.float32, (n, R), dev)
    _common.check_cuda_tensor("src", src, torch.int32, (n, rows, k), dev)
    _common.check_cuda_tensor("freq", freq, torch.float32, (n, rows, k), dev)
    delta = torch.empty((n, rows), dtype=torch.float32, device=dev)
    seen = torch.empty((n, rows), dtype=torch.float32, device=dev)
    lanes = min(32, _common.floor_pow2(k))
    fn = _common.kernel_fn("repro_ell_propagate_batched", _ARGTYPES)
    err = fn(weights.data_ptr(), active.data_ptr(), src.data_ptr(),
             freq.data_ptr(), delta.data_ptr(), seen.data_ptr(),
             n, R, rows, k, lanes, _common.stream_ptr(dev))
    _common.check_launch(err, "ell_propagate_batched")
    launches.inc()
    return delta, seen
