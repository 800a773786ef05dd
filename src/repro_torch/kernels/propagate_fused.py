"""CUDA kernel: the whole ELL frontier traversal in one launch.

The port of the JAX package's ``ell_frontier_fused_pallas``
(src/repro/kernels/propagate_fused.py).  One persistent cooperative grid
covers every SM of the card: it reads the padded plan once to find where
each row's real entries end, then runs the dependent rounds over those
entries only, with a grid sync between rounds; each round applies
``ready = (cur + seen == in_deg) & ~ever`` and a corpus stops when nothing
became ready or after ``max_rounds`` rounds (``num_levels`` is exact).  The
kernel is ``csrc/propagate_fused.cu`` (design and bound in its header).
The plain version is ``ref.ell_frontier_fused_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _common

launches = _common.launch_counter("ell_frontier_fused")

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
             + [ctypes.c_void_p] * 2)

#: Threads a block (the kernel is instantiated for each; the cooperative
#: grid is sized by the occupancy API per block size): the shipped default
#: and the shapes the autotuner sweeps.
DEFAULT_BLOCK = 512
BLOCK_CANDIDATES = (128, 256, 512, 1024)

#: [N, R] 4-byte scratch planes of the kernel: the stash of short rows
#: (8 planes: 4 freq, 4 src), weight buffer 1, two frontier masks, cur,
#: ever, live lengths, the lists of long rows.
SCRATCH_PLANES = 15

#: (blocks launched, co-resident blocks per SM, SMs) of the last launch.
last_grid = (0, 0, 0)


def ell_frontier_fused_cuda(weights0: torch.Tensor, in_deg: torch.Tensor,
                            src: torch.Tensor, freq: torch.Tensor,
                            max_rounds: int, block: int = DEFAULT_BLOCK):
    """``(weights [N, R] float32, rounds [N] int32)`` of the whole frontier
    loop on the card.

    weights0/in_deg: [N, R] float32; src: [N, R, K] int32 with every entry
    in [0, R); freq: [N, R, K] float32 — all contiguous, on one CUDA
    device, with N * R < 2^31.  Padding (``freq == 0``) may sit anywhere in
    a row.  ``rounds`` counts the rounds each corpus ran with a non-empty
    frontier.  ``block``: threads a block, one of ``BLOCK_CANDIDATES``.
    """
    global last_grid
    _common.check_launch_shape("block", block, BLOCK_CANDIDATES)
    n, R, k = src.shape
    dev = src.device
    _common.require_hopper(dev)
    _common.check_cuda_tensor("weights0", weights0, torch.float32, (n, R),
                              dev)
    _common.check_cuda_tensor("in_deg", in_deg, torch.float32, (n, R), dev)
    _common.check_cuda_tensor("src", src, torch.int32, (n, R, k), dev)
    _common.check_cuda_tensor("freq", freq, torch.float32, (n, R, k), dev)
    if n * R >= 1 << 31:
        raise ValueError(f"ell_frontier_fused takes N * R < 2^31 rows, got "
                         f"{n} x {R}")
    max_rounds = max(int(max_rounds), 1)
    w = torch.empty((n, R), dtype=torch.float32, device=dev)
    # the planes, then the kernel's control words (two long-row counts and
    # a flag row [N] per round), which the kernel zeroes itself
    planes = SCRATCH_PLANES * n * R
    scratch = torch.empty(planes + 2 + (max_rounds + 1) * n,
                          dtype=torch.int32, device=dev)
    rounds = torch.empty(n, dtype=torch.int32, device=dev)
    grid = (ctypes.c_int * 3)()
    # phase 0 reads freq 16 bytes a lane where rows allow it
    vec = int(k % 4 == 0 and freq.data_ptr() % 16 == 0)
    lanes = min(32, _common.floor_pow2(k // 4 if vec else k))
    fn = _common.kernel_fn("repro_ell_frontier_fused", _ARGTYPES)
    err = fn(weights0.data_ptr(), in_deg.data_ptr(), src.data_ptr(),
             freq.data_ptr(), w.data_ptr(), scratch.data_ptr(),
             scratch.data_ptr() + 4 * planes, rounds.data_ptr(), n, R, k, lanes, vec,
             max_rounds, block, ctypes.addressof(grid),
             _common.stream_ptr(dev))
    _common.check_launch(err, "ell_frontier_fused")
    launches.inc()
    last_grid = tuple(grid)
    return w, rounds
