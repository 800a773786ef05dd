"""Execution of the query operators over :class:`GrammarBatch`, on the card.

The port of the JAX package's ``query/engine.py``.  One call evaluates an
operator for every corpus in a pack, entirely in the compressed domain:

* **filter / aggregate** draw per-file term counts from
  :func:`repro_torch.search.engine.batch_search_stats` — the memoized
  batched per-file traversal the search subsystem already pays for, keyed
  on the pack's plan cache.  Recurring query traffic against a cached pack
  (the serving layer's case) never re-traverses.
* **filter** gathers every predicate leaf's tf column in one ``gather``,
  compares against the per-leaf thresholds, and folds the AND/OR tree with
  ``torch.logical_and`` / ``torch.logical_or``.
* **aggregate** accumulates the gathered columns slot by slot (sum) or
  with a running ``torch.maximum`` (max) — the same discipline as the
  search scorer, one eager op per step.
* **phrase** reuses the pack's memoized sequence plans
  (``core.batch._padded_sequence_plans``): window tokens and weights come
  from the same gather as ``batched_sequence_count``'s counting
  (``core.batch._window_tokens``), are matched against the phrase, and the
  matching windows' rule weights are summed.  The JAX package's ``vmap``
  over corpora is the leading ``[N, ...]`` dimension of that gather.

Everything is integer-valued float32 (< 2**24), so every reduce is exact
in any order and each path is bit-equal to the decompress-then-scan numpy
oracle and to the JAX package.  Sharded packs (``gb.mesh``) evaluate each
shard's rows on its own card (core/batch.py DESIGN note) and merge the
per-corpus results in row order, padding rows dropped — bit-identical to
the unsharded pack.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import analytics as _analytics
from repro_torch.core.batch import (GrammarBatch, _padded_sequence_plans,
                                    _window_tokens, batched_top_down_weights,
                                    resolve_batch_method)
from repro_torch.core.grammar import pow2_bucket
from repro_torch.kernels._common import resolve_device
from repro_torch.search.engine import (_gather_terms, batch_search_stats,
                                      shard_method)
from repro_torch.search.index import base_method

from .ops import (normalize_agg, normalize_phrase, normalize_predicate,
                  predicate_leaves, predicate_mask, predicate_structure)

__all__ = ["QUERY_KINDS", "batched_filter", "batched_agg", "batched_phrase",
           "filter_corpus", "agg_corpus", "phrase_corpus",
           "run_batched_query", "query_corpus"]

# Serving kinds of the query tier (see serving/analytics_server.py):
#   filter_count — predicate filter, per-corpus matching file ids
#   agg_terms    — per-file + cross-corpus sum/max over a term set
#   phrase_count — exact phrase occurrences via sequence plans
QUERY_KINDS = ("filter_count", "agg_terms", "phrase_count")


# ----------------------------------------------------------------------- #
# The operators over a pack's tensors                                      #
# ----------------------------------------------------------------------- #
def _leaf_counts(tv, terms, tvalid) -> torch.Tensor:
    """[n, F, P] counts of the leaf terms; out-of-range leaves count 0."""
    return _gather_terms(tv, terms) * tvalid[:, None, :]


def _filter_impl(tv, fvalid, terms, tvalid, thresh, structure):
    """bool [n, F] file mask.  ``terms [n, P]`` are pre-clipped leaf term
    ids, ``tvalid`` zeroes counts of out-of-range leaves, ``thresh`` the
    per-leaf minimum counts; ``structure`` is the AND/OR tree over leaf
    slots."""
    leaf = _leaf_counts(tv, terms, tvalid) >= thresh[:, None, :]

    def fold(node):
        if node[0] == "leaf":
            return leaf[:, :, node[1]]
        kids = [fold(c) for c in node[1]]
        out = kids[0]
        for k in kids[1:]:
            out = (torch.logical_and(out, k) if node[0] == "and"
                   else torch.logical_or(out, k))
        return out

    return torch.logical_and(fold(structure), fvalid)


def _agg_impl(tv, fvalid, terms, tvalid, op: str):
    """(per_file [n, F], total [n]) float32 aggregates of the term set.

    Padded term slots contribute exactly +0.0 (sum) or never win (max —
    all counts are >= 0); padded files are zeroed before the cross-corpus
    reduce, which is exact for integer-valued float32 in any order.
    """
    contrib = _leaf_counts(tv, terms, tvalid).permute(2, 0, 1)  # [P, n, F]
    pf = torch.zeros(tv.shape[:2], dtype=torch.float32, device=tv.device)
    for j in range(contrib.shape[0]):
        pf = pf + contrib[j] if op == "sum" else torch.maximum(pf, contrib[j])
    pf = torch.where(fvalid, pf, 0.0)
    total = pf.sum(dim=1) if op == "sum" else pf.amax(dim=1)
    return pf, total


def _phrase_impl(head, tail, weights, stream, phrase) -> torch.Tensor:
    """float32 [n] exact phrase counts from the pack's sequence plans:
    the weights of the windows whose tokens equal ``phrase [n, l]``."""
    wtok, wweight = _window_tokens(head, tail, weights, *stream,
                                   phrase.shape[1])
    match = (wtok == phrase[:, None, :]).all(dim=2)
    return torch.where(match, wweight, 0.0).sum(dim=1)


# ----------------------------------------------------------------------- #
# Host prep                                                                 #
# ----------------------------------------------------------------------- #
def _leaf_arrays(leaves: Sequence[Tuple[int, int]], vocab: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """pow2-padded clipped leaf term ids [P] (int64), validity mask [P]
    float32, thresholds [P] float32.  Out-of-vocab leaves gather a padded
    column masked to 0 — their comparison sees the true count of 0."""
    P = pow2_bucket(max(len(leaves), 1))
    t = np.full(P, -1, np.int64)
    th = np.zeros(P, np.float32)
    for j, (term, min_count) in enumerate(leaves):
        t[j] = term
        th[j] = min_count
    ok = (t >= 0) & (t < vocab)
    t_clip = np.clip(t, 0, max(vocab - 1, 0)).astype(np.int64)
    return t_clip, ok.astype(np.float32), th


def _tile(gb: GrammarBatch, row: np.ndarray) -> torch.Tensor:
    """Broadcast one host row to every pack row, on the pack's device."""
    return gb._place(np.tile(row[None, :], (gb.n, 1)))


# ----------------------------------------------------------------------- #
# Batched entry points                                                      #
# ----------------------------------------------------------------------- #
def batched_filter(gb: GrammarBatch, predicate,
                   method: str = "frontier") -> List[np.ndarray]:
    """Per real corpus: ascending int32 file ids satisfying the predicate."""
    pred = normalize_predicate(predicate)
    if gb.mesh is not None:
        m = shard_method(gb, method)
        return gb.map_shards(lambda sub: batched_filter(sub, pred, m))
    st = batch_search_stats(gb, method)
    t_clip, ok, th = _leaf_arrays(predicate_leaves(pred), gb.V_pad)
    mask = _filter_impl(st.tv, st.fvalid, _tile(gb, t_clip), _tile(gb, ok),
                        _tile(gb, th), predicate_structure(pred))
    mask_h = mask.cpu().numpy()
    return [np.flatnonzero(mask_h[i, : ga.num_files]).astype(np.int32)
            for i, ga in enumerate(gb.real_gas)]


def _agg_terms(terms: Sequence[int]) -> Tuple[int, ...]:
    terms = tuple(int(t) for t in terms)
    if not terms:
        raise ValueError("agg queries need a non-empty terms sequence")
    if any(t < 0 for t in terms):
        raise ValueError(f"negative term ids are invalid: {terms}")
    return terms


def batched_agg(gb: GrammarBatch, terms: Sequence[int], op: str = "sum",
                method: str = "frontier"
                ) -> List[Tuple[np.ndarray, np.float32]]:
    """Per real corpus: (per_file [num_files] float32, total float32)."""
    op = normalize_agg(op)
    leaves = [(t, 0) for t in _agg_terms(terms)]
    if gb.mesh is not None:
        m = shard_method(gb, method)
        return gb.map_shards(lambda sub: batched_agg(sub, terms, op, m))
    st = batch_search_stats(gb, method)
    t_clip, ok, _ = _leaf_arrays(leaves, gb.V_pad)
    pf, total = _agg_impl(st.tv, st.fvalid, _tile(gb, t_clip),
                          _tile(gb, ok), op)
    pf_h = pf.cpu().numpy()
    total_h = total.cpu().numpy()
    return [(pf_h[i, : ga.num_files], np.float32(total_h[i]))
            for i, ga in enumerate(gb.real_gas)]


def batched_phrase(gb: GrammarBatch, phrase: Sequence[int],
                   method: str = "frontier") -> List[np.float32]:
    """Per real corpus: exact float32 occurrence count of the phrase."""
    phrase = normalize_phrase(phrase)
    if gb.mesh is not None:
        m = resolve_batch_method(gb, method)
        return gb.map_shards(lambda sub: batched_phrase(sub, phrase, m))
    weights = batched_top_down_weights(gb, method=method)
    head, tail, stream = _padded_sequence_plans(gb, len(phrase))
    counts = _phrase_impl(head, tail, weights, stream,
                          _tile(gb, np.asarray(phrase, np.int32)))
    counts_h = counts.cpu().numpy()
    return [np.float32(counts_h[i]) for i in range(gb.real)]


# ----------------------------------------------------------------------- #
# Single-corpus entry points                                                #
# ----------------------------------------------------------------------- #
def _corpus_tv(source, method: str, dev: torch.device
               ) -> Tuple[np.ndarray, object]:
    """Dense [F, V] float32 term vector of one corpus, traversed on
    ``dev``; ``source`` is a ``GrammarArrays`` or a ``CompressedCorpus`` —
    the latter's memoized per-file traversal weights are reused (same memo
    the search index shares)."""
    m = base_method(method)
    if hasattr(source, "per_file_weights"):
        ga = source.ga
        fw = source.per_file_weights(m, device=dev)
    else:
        ga = source
        fw = None
    tv = _analytics.term_vector(ga, method=m, file_weights=fw, device=dev)
    return tv.cpu().numpy().astype(np.float32), ga


def filter_corpus(source, predicate, method: str = "frontier",
                  device=None) -> np.ndarray:
    """Ascending int32 file ids of one corpus satisfying the predicate —
    bit-identical to the corpus's row in a batched pack."""
    pred = normalize_predicate(predicate)
    tv, _ = _corpus_tv(source, method, resolve_device(device))
    return np.flatnonzero(predicate_mask(pred, tv)).astype(np.int32)


def agg_corpus(source, terms: Sequence[int], op: str = "sum",
               method: str = "frontier", device=None
               ) -> Tuple[np.ndarray, np.float32]:
    """(per_file [num_files] float32, total float32) for one corpus."""
    op = normalize_agg(op)
    terms = _agg_terms(terms)
    tv, _ = _corpus_tv(source, method, resolve_device(device))
    F, V = tv.shape
    pf = np.zeros(F, np.float32)
    # sequential accumulation over term slots in query order, as the
    # batched path does (exact for integer-valued float32 regardless)
    for t in terms:
        cnt = tv[:, t] if t < V else np.zeros(F, np.float32)
        pf = pf + cnt if op == "sum" else np.maximum(pf, cnt)
    if op == "sum":
        total = np.float32(pf.sum(dtype=np.float32))
    else:
        total = np.float32(pf.max()) if F else np.float32(0.0)
    return pf, total


def phrase_corpus(source, phrase: Sequence[int], method: str = "frontier",
                  device=None) -> np.float32:
    """Exact float32 phrase count of one corpus, via the single-corpus
    sequence plans (``core/sequence.py``) on ``device`` — reusing the
    store-memoized top-down traversal weights when ``source`` is a
    CompressedCorpus."""
    phrase = normalize_phrase(phrase)
    dev = resolve_device(device)
    if hasattr(source, "top_down_weights"):
        ga = source.ga
        w = source.top_down_weights(method, device=dev)
    else:
        ga = source
        w = None
    grams, cnts = _analytics.sequence_count(ga, l=len(phrase), method=method,
                                            weights=w, device=dev)
    grams = np.asarray(grams)
    cnts = np.asarray(cnts, np.float32)
    if grams.size:
        hit = np.nonzero((grams == np.asarray(phrase, grams.dtype))
                         .all(axis=1))[0]
        if hit.size:
            return np.float32(cnts[hit[0]])
    return np.float32(0.0)


# ----------------------------------------------------------------------- #
# Kind dispatchers (serving layer)                                          #
# ----------------------------------------------------------------------- #
def run_batched_query(gb: GrammarBatch, kind: str, predicate=None,
                      terms=None, agg=None,
                      method: str = "frontier") -> List:
    """Dispatch one query kind over the whole pack; per-corpus results
    shaped exactly like the single-corpus functions."""
    if kind == "filter_count":
        return batched_filter(gb, predicate, method=method)
    if kind == "agg_terms":
        return batched_agg(gb, terms, op=normalize_agg(agg), method=method)
    if kind == "phrase_count":
        return batched_phrase(gb, terms, method=method)
    raise ValueError(f"unknown query kind {kind!r}; "
                     f"expected one of {QUERY_KINDS}")


def query_corpus(source, kind: str, predicate=None, terms=None, agg=None,
                 method: str = "frontier", device=None):
    """Single-corpus dispatch on ``device``, mirroring
    :func:`run_batched_query`."""
    if kind == "filter_count":
        return filter_corpus(source, predicate, method=method, device=device)
    if kind == "agg_terms":
        return agg_corpus(source, terms, op=normalize_agg(agg),
                          method=method, device=device)
    if kind == "phrase_count":
        return phrase_corpus(source, terms, method=method, device=device)
    raise ValueError(f"unknown query kind {kind!r}; "
                     f"expected one of {QUERY_KINDS}")
