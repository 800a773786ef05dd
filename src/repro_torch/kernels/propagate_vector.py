"""CUDA kernel: one vector-payload round over the dense ELL plan.

The port of the JAX package's ``ell_propagate_vector_pallas``
(src/repro/kernels/propagate_vector.py), the round of the per-file
traversals:

  delta[n, r, f] = sum_k freq[n, r, k] * W[n, src[n, r, k], f]
                                       * active[n, src[n, r, k]]
  seen[n, r]     = sum_k [freq[n, r, k] > 0] * active[n, src[n, r, k]]

The kernel is ``csrc/propagate_vector.cu``: a warp per plan row (or per
few rows when K is small), the row's live, active entries compacted with
warp ballots and gathered with lanes over F (design and bound in its
header).  Root-edge exclusion stays the caller's job, via the active mask,
as in the JAX package.  The plain version is
``ref.ell_propagate_vector_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _common

launches = _common.launch_counter("ell_propagate_vector")

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p])


def ell_propagate_vector_cuda(W: torch.Tensor, active: torch.Tensor,
                              src: torch.Tensor, freq: torch.Tensor):
    """(delta [N, rows, F], seen [N, rows]) float32 of one round on the card.

    W: [N, R, F] float32; active: [N, R] float32; src: [N, rows, K] int32
    with every entry in [0, R); freq: [N, rows, K] float32 — all
    contiguous, on one CUDA device, with N * rows < 2^31.
    """
    n, rows, k = src.shape
    R, F = W.shape[1], W.shape[2]
    dev = src.device
    _common.require_hopper(dev)
    _common.check_cuda_tensor("W", W, torch.float32, (n, R, F), dev)
    _common.check_cuda_tensor("active", active, torch.float32, (n, R), dev)
    _common.check_cuda_tensor("src", src, torch.int32, (n, rows, k), dev)
    _common.check_cuda_tensor("freq", freq, torch.float32, (n, rows, k), dev)
    if n * rows >= 1 << 31:
        raise ValueError(f"ell_propagate_vector takes N * rows < 2^31, got "
                         f"{n} x {rows}")
    delta = torch.empty((n, rows, F), dtype=torch.float32, device=dev)
    seen = torch.empty((n, rows), dtype=torch.float32, device=dev)
    # 16-byte loads where rows and pointers allow: freq 8 entries a lane
    # (two loads), W rows 4 columns a lane
    w_ptr, q_ptr = W.data_ptr(), freq.data_ptr()
    epl = 8 if k % 8 == 0 and q_ptr % 16 == 0 else 1
    vw = int(F % 4 == 0 and w_ptr % 16 == 0)
    lanes_row = min(32, _common.round_up_pow2(-(-k // epl)))
    lanes_entry = min(32, _common.round_up_pow2(-(-F // (4 if vw else 1))))
    fn = _common.kernel_fn("repro_ell_propagate_vector", _ARGTYPES)
    err = fn(w_ptr, active.data_ptr(), src.data_ptr(), q_ptr,
             delta.data_ptr(), seen.data_ptr(), n, R, rows, k, F, lanes_row,
             lanes_entry, epl, vw, _common.stream_ptr(dev))
    _common.check_launch(err, "ell_propagate_vector")
    launches.inc()
    return delta, seen
