"""Plain torch versions of the kernels (the JAX package's ``kernels/ref.py``,
plus the file ranking it does with ``jnp.argsort``): the oracles the CUDA
kernels are held against, and the only path a CPU tensor takes.  Nothing on
the CUDA path calls them.

Integer-valued float32 inputs (every value on the engine path) give the
same sums in any order, so these match the JAX references and the CUDA
kernels bit for bit there; on arbitrary floats the summation order differs.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def weighted_bincount_ref(ids: torch.Tensor, vals: torch.Tensor,
                          nbins: int) -> torch.Tensor:
    """out[b] = sum(vals[ids == b]); ids outside [0, nbins) ignored.

    ``[rows, T]`` inputs give ``[rows, nbins]``, one histogram a row (the
    batch axis of the kernel): row i's ids are offset into the disjoint
    bin range ``[i * nbins, (i + 1) * nbins)`` of one flat histogram.
    """
    ids = ids.to(torch.int64)
    valid = (ids >= 0) & (ids < nbins)
    rows = ids.shape[0] if ids.ndim == 2 else 1
    if ids.ndim == 2:
        ids = ids + (torch.arange(rows, device=ids.device) * nbins)[:, None]
    safe = torch.where(valid, ids, 0)
    v = torch.where(valid, vals.to(torch.float32), 0.0)
    out = torch.zeros(rows * nbins, dtype=torch.float32, device=ids.device)
    out.index_add_(0, safe.reshape(-1), v.reshape(-1))
    return out if ids.ndim == 1 else out.view(rows, nbins)


def ell_row_sums_ref(weights: torch.Tensor, src: torch.Tensor,
                     freq: torch.Tensor) -> torch.Tensor:
    """row_sums[r] = sum_k freq[r, k] * weights[src[r, k]]."""
    return (weights.to(torch.float32)[src.to(torch.int64)] *
            freq.to(torch.float32)).sum(dim=1)


def _gather_rows(v: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """v[n, src[n, ...]] for a [N, R] vector and a [N, ...] index plan."""
    n = src.shape[0]
    flat = src.reshape(n, -1).to(torch.int64)
    return torch.gather(v, 1, flat).reshape(src.shape)


def ell_propagate_batched_ref(weights: torch.Tensor, active: torch.Tensor,
                              src: torch.Tensor, freq: torch.Tensor):
    """(delta, seen) of one round over the [N, R, K] edge plan.

    delta[n, r] = sum_k freq[n,r,k] * weights[n, src[n,r,k]]
                                    * active[n, src[n,r,k]]
    seen[n, r]  = sum_k [freq[n,r,k] > 0] * active[n, src[n,r,k]]
    """
    f = freq.to(torch.float32)
    gw = _gather_rows(weights.to(torch.float32), src)
    ga = _gather_rows(active.to(torch.float32), src)
    delta = (f * gw * ga).sum(dim=-1)
    seen = torch.where(f > 0, ga, 0.0).sum(dim=-1)
    return delta, seen


def ell_propagate_vector_ref(W: torch.Tensor, active: torch.Tensor,
                             src: torch.Tensor, freq: torch.Tensor):
    """(delta, seen) of one vector-payload round over the [N, R, K] plan.

    delta[n, r, f] = sum_k freq[n,r,k] * W[n, src[n,r,k], f]
                                       * active[n, src[n,r,k]]
    seen[n, r]     = sum_k [freq[n,r,k] > 0] * active[n, src[n,r,k]]
    """
    n, rows, k = src.shape
    F = W.shape[-1]
    flat = src.reshape(n, -1).to(torch.int64)
    f = freq.to(torch.float32)
    gw = torch.gather(W.to(torch.float32), 1,
                      flat[:, :, None].expand(n, rows * k, F))
    gw = gw.reshape(n, rows, k, F)
    ga = _gather_rows(active.to(torch.float32), src)
    delta = ((f * ga)[..., None] * gw).sum(dim=2)
    seen = torch.where(f > 0, ga, 0.0).sum(dim=-1)
    return delta, seen


def ell_frontier_fused_ref(weights0: torch.Tensor, in_deg: torch.Tensor,
                           src: torch.Tensor, freq: torch.Tensor,
                           max_rounds: int):
    """The whole frontier loop over the ELL plan as a fixed-trip loop of
    ``max(max_rounds, 1)`` rounds with no convergence test.

    Converged extra rounds are exact no-ops (delta == 0.0).  Returns
    ``(weights [N, R], rounds [N] int32)``: rounds counts, per corpus, the
    rounds that started with a non-empty frontier.
    """
    n = src.shape[0]
    w = weights0.to(torch.float32)
    ind = in_deg.to(torch.int32)
    mask = (ind == 0).to(torch.float32)
    ever = mask.clone()
    cur = torch.zeros_like(ind)
    rounds = torch.zeros(n, dtype=torch.int32, device=src.device)
    for _ in range(max(int(max_rounds), 1)):
        rounds = rounds + (mask > 0).any(dim=1).to(torch.int32)
        delta, seen = ell_propagate_batched_ref(w, mask, src, freq)
        w = w + delta
        cur = cur + seen.to(torch.int32)
        ready = ((cur == ind) & (ever == 0.0)).to(torch.float32)
        mask = ready
        ever = ever + ready
    return w, rounds


def rank_files_ref(tv: torch.Tensor, num_files: Sequence[int],
                   vocab_size: Sequence[int]
                   ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per corpus i, ``(ranking [vocab_size[i], num_files[i]] int32,
    counts [vocab_size[i], num_files[i]])`` of the ``[N, V_pad, F_pad]``
    term vector: each word's real files by count descending, ties to the
    lower file id (a stable argsort of the negated counts over an ``[F,
    V]`` view)."""
    out = []
    for i, (nf, v) in enumerate(zip(num_files, vocab_size)):
        x = tv[i, : int(v), : int(nf)].T                          # [F, V]
        order = torch.argsort(-x, dim=0, stable=True)
        ranked = torch.take_along_dim(x, order, dim=0)
        out.append((order.T.to(torch.int32), ranked.T))
    return out
