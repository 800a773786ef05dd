"""CUDA kernel: the whole ELL frontier traversal in one launch.

The port of the JAX package's ``ell_frontier_fused_pallas``
(src/repro/kernels/propagate_fused.py).  One thread block per corpus loops
over the rounds inside the kernel; each round gathers (delta, seen) over
the corpus's plan rows into device scratch, then applies
``ready = (cur + seen == in_deg) & ~ever`` and stops when nothing became
ready or after ``max_rounds`` rounds (``num_levels`` is exact).  The kernel
is ``csrc/propagate_fused.cu`` (design and bound in its header).  The plain
version is ``ref.ell_frontier_fused_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _common

launches = _common.launch_counter("ell_frontier_fused")

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def ell_frontier_fused_cuda(weights0: torch.Tensor, in_deg: torch.Tensor,
                            src: torch.Tensor, freq: torch.Tensor,
                            max_rounds: int):
    """``(weights [N, R] float32, rounds [N] int32)`` of the whole frontier
    loop on the card.

    weights0/in_deg: [N, R] float32; src: [N, R, K] int32 with every entry
    in [0, R); freq: [N, R, K] float32 — all contiguous, on one CUDA
    device.  ``rounds`` counts the rounds each corpus ran with a non-empty
    frontier.
    """
    n, R, k = src.shape
    dev = src.device
    _common.require_hopper(dev)
    _common.check_cuda_tensor("weights0", weights0, torch.float32, (n, R),
                              dev)
    _common.check_cuda_tensor("in_deg", in_deg, torch.float32, (n, R), dev)
    _common.check_cuda_tensor("src", src, torch.int32, (n, R, k), dev)
    _common.check_cuda_tensor("freq", freq, torch.float32, (n, R, k), dev)
    w = torch.empty((n, R), dtype=torch.float32, device=dev)
    scratch = torch.empty((5, n, R), dtype=torch.float32, device=dev)
    rounds = torch.empty(n, dtype=torch.int32, device=dev)
    lanes = min(32, _common.floor_pow2(k))
    fn = _common.kernel_fn("repro_ell_frontier_fused", _ARGTYPES)
    err = fn(weights0.data_ptr(), in_deg.data_ptr(), src.data_ptr(),
             freq.data_ptr(), w.data_ptr(), scratch.data_ptr(),
             rounds.data_ptr(), n, R, k, lanes, max(int(max_rounds), 1),
             _common.stream_ptr(dev))
    _common.check_launch(err, "ell_frontier_fused")
    launches.inc()
    return w, rounds
