"""The six TADOC analytics of one corpus (paper §V: the CompressDirect set).

The port of the JAX package's ``core/analytics.py``.  All six operate
directly on the compressed grammar — no decompression: word count, sort,
inverted index, term vector, sequence count, ranked inverted index.

The global reduction (the paper's ``reduceResultKernel``) is an
``index_add_`` under ``backend="torch"`` (the JAX package's ``"jnp"``), or
the weighted-histogram kernel (kernels/bincount.py) under
``backend="kernel"`` (its ``"pallas"``).  Per-file analytics use the
per-file top-down weights; :func:`term_vector_sparse` is the host path with
the same math in a sparse layout.

Device results are torch tensors on ``device`` (the card unless the caller
passes ``"cpu"``); ``sequence_count`` and ``term_vector_sparse`` return
numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels._common import resolve_device

from .batch import word_major_term_vector
from .grammar import GrammarArrays
from .traversal import device_pack, per_file_weights, top_down_weights
from . import sequence as _sequence

BACKENDS = ("torch", "kernel")


def _global_reduce(ids: torch.Tensor, vals: torch.Tensor, nbins: int,
                   backend: str) -> torch.Tensor:
    if backend == "kernel":
        return kops.weighted_bincount(ids, vals, nbins)
    return torch.zeros(nbins, dtype=torch.float32,
                       device=vals.device).index_add_(0, ids, vals)


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")


def _on(t: torch.Tensor, dev: torch.device, name: str) -> torch.Tensor:
    if t.device != dev:
        raise ValueError(f"{name} are on {t.device}, expected {dev}")
    return t


# ------------------------------------------------------------------ apps --
def word_count(ga: GrammarArrays, method: str = "auto",
               backend: str = "torch", weights: torch.Tensor | None = None,
               device=None) -> torch.Tensor:
    """counts[v] = occurrences of word v in the whole corpus. [V] float32.

    ``weights`` lets callers reuse a memoized traversal on the same device
    (the store caches per-corpus weights) — it must equal
    ``top_down_weights(ga)``.
    """
    _check_backend(backend)
    dev = resolve_device(device)
    if weights is None:
        weights = top_down_weights(ga, method=_pick(ga, method), device=dev)
    _on(weights, dev, "weights")
    gb = device_pack(ga, dev)
    vals = gb.tw_cnt[0] * weights[gb.tw_rule[0]]
    return _global_reduce(gb.tw_word[0], vals, ga.vocab_size, backend)


def sort_words(ga: GrammarArrays, method: str = "auto",
               backend: str = "torch", weights: torch.Tensor | None = None,
               device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Words sorted by frequency (desc), ties by word id (stable).
    Returns (word_ids int32, counts)."""
    counts = word_count(ga, method=method, backend=backend, weights=weights,
                        device=device)
    order = torch.argsort(-counts, stable=True)
    return order.to(torch.int32), counts[order]


def term_vector(ga: GrammarArrays, method: str = "auto",
                file_weights: torch.Tensor | None = None,
                device=None) -> torch.Tensor:
    """tv[f, v] = occurrences of word v in file f.  Dense [F, V] float32.

    ``file_weights`` lets callers reuse a memoized per-file traversal on
    the same device; it must equal ``per_file_weights(ga)``.
    """
    dev = resolve_device(device)
    if file_weights is None:
        file_weights = per_file_weights(ga, method=_pick(ga, method),
                                        device=dev)          # [R, F]
    Wf = _on(file_weights, dev, "file_weights")
    gb = device_pack(ga, dev)
    V, F = ga.vocab_size, Wf.shape[1]
    if F == 0:
        # nothing to count into (the pack's padding entries would scatter
        # out of an empty table)
        return torch.zeros((0, V), dtype=torch.float32, device=dev)
    contrib = Wf[gb.tw_rule[0]] * gb.tw_cnt[0, :, None]       # [T, F]
    tv = torch.zeros((V, F), dtype=torch.float32, device=dev)
    tv = tv.index_add_(0, gb.tw_word[0], contrib).T.contiguous()  # [F, V]
    tv.view(-1).index_add_(0, gb.fword_file[0] * V + gb.fword_word[0],
                           gb.fword_cnt[0])
    return tv


def inverted_index(ga: GrammarArrays, method: str = "auto",
                   file_weights: torch.Tensor | None = None,
                   device=None) -> torch.Tensor:
    """ii[f, v] = True iff word v occurs in file f."""
    return term_vector(ga, method=method, file_weights=file_weights,
                       device=device) > 0


def ranked_inverted_index(ga: GrammarArrays, method: str = "auto",
                          file_weights: torch.Tensor | None = None,
                          device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each word: files ranked by frequency (desc, ties by file id),
    with counts.  Returns (ranking [V, F] int32 file ids, counts [V, F]
    aligned to the ranking).

    The term vector is read word-major, ``[1, V, F]`` as the packed
    engine builds it on the one-corpus pack
    (``batch.word_major_term_vector``), and ``kernels.ops.rank_files``
    ranks it: the packed engine's op, one kernel launch on the card."""
    dev = resolve_device(device)
    if file_weights is None:
        file_weights = per_file_weights(ga, method=_pick(ga, method),
                                        device=dev)          # [R, F]
    Wf = _on(file_weights, dev, "file_weights")
    gb = device_pack(ga, dev)
    (ranking, counts), = kops.rank_files(
        word_major_term_vector(gb, Wf[None]), gb.num_files, gb.vocab_sizes)
    return ranking, counts


def sequence_count(ga: GrammarArrays, l: int = 3, method: str = "auto",
                   weights: torch.Tensor | None = None, device=None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Distinct l-gram counts (paper §IV-D), numpy.  See core/sequence.py."""
    return _sequence.sequence_count(ga, l=l, method=_pick(ga, method),
                                    weights=weights, device=device)


# ---------------------------------------------------------------- helpers --
def _pick(ga: GrammarArrays, method: str) -> str:
    if method != "auto":
        return method
    from .selector import select_traversal
    return select_traversal(ga)


def term_vector_sparse(ga: GrammarArrays) -> Tuple[np.ndarray, np.ndarray,
                                                   np.ndarray]:
    """Host sparse per-file counts: returns COO (file, word, count).

    Frontier propagation of (file, rule, weight) triplets with per-level
    dedup — the scalable path for 1e5+-file corpora where dense [F, V] is
    not materializable.  Same math as :func:`term_vector`.
    """
    # per-file rule weights, propagated sparsely level by level
    from collections import defaultdict
    Wf: defaultdict = defaultdict(float)       # (rule, file) -> weight
    for c, f, q in zip(ga.fedge_child, ga.fedge_file, ga.fedge_freq):
        Wf[(int(c), int(f))] += float(q)
    by_level = [[] for _ in range(ga.num_levels)]
    for e in range(ga.num_edges):
        p = int(ga.edge_parent[e])
        if p != 0:
            by_level[int(ga.level[p])].append(e)
    for lv in range(ga.num_levels):
        for e in by_level[lv]:
            p, c, q = (int(ga.edge_parent[e]), int(ga.edge_child[e]),
                       float(ga.edge_freq[e]))
            for (r, f), w in list(Wf.items()):
                if r == p:
                    Wf[(c, f)] += q * w
    out: defaultdict = defaultdict(float)      # (file, word) -> count
    tw_by_rule = defaultdict(list)
    for r, w, c in zip(ga.tw_rule, ga.tw_word, ga.tw_cnt):
        tw_by_rule[int(r)].append((int(w), float(c)))
    for (r, f), wt in Wf.items():
        for (w, c) in tw_by_rule.get(r, ()):
            out[(f, w)] += wt * c
    for f, w, c in zip(ga.fword_file, ga.fword_word, ga.fword_cnt):
        out[(int(f), int(w))] += float(c)
    if not out:
        return (np.zeros(0, np.int32),) * 3
    items = sorted(out.items())
    ff = np.array([k[0] for k, _ in items], np.int32)
    ww = np.array([k[1] for k, _ in items], np.int32)
    cc = np.array([v for _, v in items], np.float32)
    return ff, ww, cc
