"""CUDA kernel: each word's files ranked by count (the ranked inverted index).

No Pallas kernel of the JAX package does this: it ranks with ``jnp.argsort``
(src/repro/core/batch.py).  ``csrc/rank_files.cu`` reads the per-file term
vector in the layout its segment sum writes, ``[N, V_pad, F_pad]``, so a
word's counts sit next to each other: a group of lanes takes a word (a
warp, 32 files at a time, past 32 files), ranks its files with warp
shuffles (counts descending, ties to the lower file id, padded files left
out) and writes each file id and count at its rank.  One launch ranks
every corpus of a pack.  The plain version is
``ref.rank_files_ref``.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from . import _common

launches = _common.launch_counter("rank_files")

_ARGTYPES = ([ctypes.c_void_p] * 3
             + [ctypes.POINTER(ctypes.c_longlong),
                ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])


def rank_files_cuda(tv: torch.Tensor, num_files: Sequence[int],
                    vocab_size: Sequence[int]
                    ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per corpus i, ``(ranking [vocab_size[i], num_files[i]] int32,
    counts [vocab_size[i], num_files[i]] float32)`` on the card.

    tv: contiguous ``[N, V_pad, F_pad]`` float32 on one CUDA device.  Row
    v of corpus i's ranking lists the files ``f < num_files[i]`` by
    ``tv[i, v, f]`` descending, ties to the lower file id; the counts are
    aligned to it.  Both come as contiguous
    views of one flat buffer each.  A pack with no real file (``F_pad``
    0, or every ``num_files[i]`` 0) launches nothing and gives empty
    ``[vocab_size[i], 0]`` views.
    """
    if tv.ndim != 3:
        raise ValueError(f"tv must be [N, V_pad, F_pad], got "
                         f"{tuple(tv.shape)}")
    n, v_pad, f_pad = tv.shape
    nf = [int(x) for x in num_files]
    vs = [int(x) for x in vocab_size]
    if len(nf) != n or len(vs) != n:
        raise ValueError(f"{len(nf)} file counts and {len(vs)} vocabulary "
                         f"sizes for {n} corpora")
    if any(not 0 <= f <= f_pad for f in nf) or any(
            not 0 <= v <= v_pad for v in vs):
        raise ValueError(f"file counts {nf} or vocabulary sizes {vs} "
                         f"outside [0, {f_pad}] x [0, {v_pad}]")
    dev = tv.device
    _common.require_hopper(dev)
    _common.check_cuda_tensor("tv", tv, torch.float32, tv.shape, dev)
    sizes = [v * f for v, f in zip(vs, nf)]
    total = sum(sizes)
    ids = torch.empty(total, dtype=torch.int32, device=dev)
    counts = torch.empty(total, dtype=torch.float32, device=dev)
    if total:
        fn = _common.kernel_fn("repro_rank_files", _ARGTYPES)
        err = fn(tv.data_ptr(), ids.data_ptr(), counts.data_ptr(),
                 (ctypes.c_longlong * n)(*vs), (ctypes.c_int * n)(*nf), n,
                 v_pad, f_pad, _common.stream_ptr(dev))
        _common.check_launch(err, "rank_files")
        launches.inc()
    out = []
    start = 0
    for v, f, size in zip(vs, nf, sizes):
        out.append((ids[start: start + size].view(v, f),
                    counts[start: start + size].view(v, f)))
        start += size
    return out
