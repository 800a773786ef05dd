"""CUDA kernel: ELL gather row sums of one corpus.

The port of the JAX package's ``ell_row_sums_pallas``
(src/repro/kernels/propagate.py):

  row_sums[r] = sum_k freq[r, k] * weight[src[r, k]]

over a uniform-width ``[rows, W]`` ELL layout (padding: src=0, freq=0).
Masking is folded into the input: callers pass ``weight * mask``.  On the
single corpus's in-edge plan (``GrammarArrays.in_edges_ell_dense``) with the
top-down weights, row r's sum is rule r's weight again for every r >= 1 —
a flow-conservation check of the traversal.  The kernel is
``csrc/row_sums.cu`` (design and bound in its header);
:func:`ell_row_sums_cuda` checks its inputs, allocates the output and
launches it on the current stream.  The plain version is
``ref.ell_row_sums_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _common

launches = _common.launch_counter("ell_row_sums")

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def ell_row_sums_cuda(weights: torch.Tensor, src: torch.Tensor,
                      freq: torch.Tensor) -> torch.Tensor:
    """row_sums [rows] float32 on the card.

    weights: [R] float32; src: [rows, W] int32 with every entry in [0, R);
    freq: [rows, W] float32 — all contiguous, on one CUDA device.
    """
    rows, k = src.shape
    dev = src.device
    _common.require_hopper(dev)
    _common.check_cuda_tensor("weights", weights, torch.float32,
                              (weights.shape[0],), dev)
    _common.check_cuda_tensor("src", src, torch.int32, (rows, k), dev)
    _common.check_cuda_tensor("freq", freq, torch.float32, (rows, k), dev)
    out = torch.empty(rows, dtype=torch.float32, device=dev)
    lanes = min(32, _common.floor_pow2(k))
    fn = _common.kernel_fn("repro_ell_row_sums", _ARGTYPES)
    err = fn(weights.data_ptr(), src.data_ptr(), freq.data_ptr(),
             out.data_ptr(), rows, k, lanes, _common.stream_ptr(dev))
    _common.check_launch(err, "ell_row_sums")
    launches.inc()
    return out
