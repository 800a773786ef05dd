"""Batched BM25/TF-IDF scoring + top-k over :class:`GrammarBatch`.

The port of the JAX package's ``search/engine.py``.  One call ranks every
file of every corpus in a pack against a multi-term query, entirely in the
compressed domain:

1. **Statistics** come from the batched per-file traversal
   (:func:`repro_torch.core.batch.batched_term_vector`, kernel 3's vector
   rounds under the ELL methods): ``tv [N, F, V]`` term frequencies,
   ``dl = tv.sum(V)`` doc lengths, ``df = (tv > 0).sum(F)`` document
   frequencies.  They are memoized per (pack, traversal base) on the
   pack's plan cache — recurring search traffic against a cached pack pays
   the traversal once, like the ELL and sequence plans.
2. **Transcendental prep** (idf tables, the BM25 length normalizer) runs
   on host in numpy float32 (:mod:`repro_torch.search.scoring` DESIGN note:
   ``log`` is not bit-stable across libms, so it never runs on the card).
3. **Scoring + top-k** on the pack's device: vocab-gather of the query
   terms' tf columns, the per-(doc, term) contribution, an accumulation
   over term slots, and ``kernels.ops.masked_top_k`` (a stable sort: ties
   resolve to the lower file id).

DESIGN — bit equality of non-integer scores.  Scores are float32 and not
integers, so the order and the rounding of every operation matter.  The
JAX package materialises the contributions ``[Q, n, F]`` and adds them
slot by slot in a ``fori_loop``, so no multiply-add is contracted into an
FMA; the numpy oracle mirrors it.  Here every step is one eager elementwise
torch op — one kernel, one IEEE-rounded float32 result — and the
accumulation is a Python loop of ``score = score + contrib[j]``.  A
reduction (``contrib.sum(0)``), ``addcmul``, ``torch.compile`` or a fused
kernel would change the rounding and is not used.  The constant
``K1 + 1`` enters as a float32 scalar (``float()`` of the ``np.float32``
value is exact).

Padding is inert end to end: padded files are masked to ``-inf`` before
top-k (and sliced off by ``min(k, num_files)``), padded/out-of-vocab term
slots contribute exactly ``+0.0`` (zero idf or zero tf).

Sharded packs (``gb.mesh``, core/batch.py DESIGN note) rank per shard:
each shard's sub-pack keeps its own statistics and scores and ranks its
own corpus rows on its card; the per-corpus results are merged on the host
in row order.  Every row's statistics, idf table and top-k depend on that
row alone, so the rankings (tie order included) are bit-identical to the
unsharded pack's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.batch import (GrammarBatch, batched_term_vector,
                                    resolve_batch_method)
from repro_torch.core.grammar import pow2_bucket
from repro_torch.kernels import ops as kops
from repro_torch.kernels._common import resolve_device
from repro_torch.obs import plan_stage as _plan_stage

from .index import SearchIndex, base_method, build_search_index
from .scoring import (DEFAULT_TOP_K, K1P1, SCHEMES, avg_doc_len, bm25_norm,
                      idf, normalize_terms)

__all__ = ["batched_search", "search_corpus", "search_index_topk",
           "batch_search_stats", "search_sharded", "shard_method"]


# ----------------------------------------------------------------------- #
# Scoring + top-k                                                          #
# ----------------------------------------------------------------------- #
def _gather_terms(tv: torch.Tensor, terms: torch.Tensor) -> torch.Tensor:
    """``tv[i, f, terms[i, j]]`` -> ``[n, F, Q]`` (the JAX package's
    ``take_along_axis`` over the vocab axis)."""
    n, F, _ = tv.shape
    return torch.gather(tv, 2, terms[:, None, :].expand(n, F, -1))


def _score_topk_impl(tv, terms, idf_q, norm, fvalid, k: int, scheme: str):
    """Score ``[n, F]`` docs against ``[n, Q]`` term slots and rank top-k.

    ``terms`` are pre-clipped int64 vocab indices (host prep), ``idf_q`` is
    0.0 on invalid/padded slots, ``norm`` the host-computed BM25 length
    normalizer.  Every op is one exactly-specified IEEE float32 elementwise
    op in a fixed order (module DESIGN note).
    """
    tf_q = _gather_terms(tv, terms)                              # [n, F, Q]
    if scheme == "bm25":
        k1p1 = torch.tensor(float(K1P1), dtype=torch.float32,
                            device=tv.device)
        quot = (tf_q * k1p1) / (tf_q + norm[:, :, None])
    elif scheme == "tfidf":
        quot = tf_q
    else:
        raise ValueError(f"unknown scoring scheme {scheme!r}; "
                         f"expected one of {SCHEMES}")
    contrib = (idf_q[:, None, :] * quot).permute(2, 0, 1)        # [Q, n, F]
    score = torch.zeros(tv.shape[:2], dtype=torch.float32, device=tv.device)
    for j in range(contrib.shape[0]):
        score = score + contrib[j]
    return kops.masked_top_k(score, fvalid, k)


# ----------------------------------------------------------------------- #
# Pack-level retrieval statistics (memoized like the ELL/sequence plans)   #
# ----------------------------------------------------------------------- #
@dataclass(frozen=True)
class _BatchSearchStats:
    tv: torch.Tensor      # [N, F_pad, V_pad] on the pack's device
    norm: torch.Tensor    # [N, F_pad] on the device, bm25_norm per corpus
    fvalid: torch.Tensor  # [N, F_pad] bool on the device (file < num_files)
    df: np.ndarray        # [N, V_pad] float32 host document frequencies
    nf: np.ndarray        # [N] int64 host true file counts


def batch_search_stats(gb: GrammarBatch,
                       method: str = "frontier") -> _BatchSearchStats:
    """Doc lengths / document frequencies / tf lookups for a whole pack,
    derived from the batched per-file traversal and memoized on the pack
    (key: traversal base).  A sharded pack keeps them on its shards."""
    if gb.mesh is not None:
        raise ValueError("a sharded pack keeps its search statistics on its "
                         "shards (see batched_search)")
    m = base_method(method)
    key = ("search", m)
    if key not in gb._plan_cache:
        with _plan_stage("search_stats"):
            tv = batched_term_vector(gb, method=m)
            # dl/df are integer-valued (exact in float32 in any reduce
            # order)
            dl = tv.sum(dim=2).cpu().numpy().astype(np.float32)  # [N, F_pad]
            df = (tv > 0).sum(dim=1).cpu().numpy().astype(np.float32)
            nf = gb.num_files.astype(np.int64)
            norm = np.stack([
                bm25_norm(dl[i], avg_doc_len(dl[i], int(nf[i])))
                for i in range(gb.n)]).astype(np.float32)
            fvalid = np.arange(gb.F_pad)[None, :] < nf[:, None]
            gb._plan_cache[key] = _BatchSearchStats(
                tv=tv, norm=gb._place(norm), fvalid=gb._place(fvalid),
                df=df, nf=nf)
    return gb._plan_cache[key]


def shard_method(gb: GrammarBatch, method: str) -> str:
    """The per-file traversal a sharded pack's shards run for ``method``:
    its statistics base, resolved once against the whole pack."""
    return resolve_batch_method(gb, base_method(method), per_file=True)


def _query_arrays(df: np.ndarray, nf: np.ndarray, vocab: int,
                  terms: Tuple[int, ...], scheme: str
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Host query prep: pow2-padded clipped term indices [Qp] (int64, the
    gather index type) and the per-corpus idf table [N, Qp] (0.0 on padded
    / out-of-range slots — their contribution must be exactly +0.0)."""
    qp = pow2_bucket(len(terms))
    t = np.full(qp, -1, np.int64)
    t[: len(terms)] = terms
    ok = (t >= 0) & (t < vocab)
    t_clip = np.clip(t, 0, max(vocab - 1, 0)).astype(np.int64)
    df_q = np.where(ok[None, :], df[:, t_clip], np.float32(0.0))
    idf_q = idf(df_q, nf[:, None], scheme)
    idf_q = np.where(ok[None, :], idf_q, np.float32(0.0)).astype(np.float32)
    return t_clip, idf_q


def _check_query(k: int, scheme: str) -> int:
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scoring scheme {scheme!r}; "
                         f"expected one of {SCHEMES}")
    k = int(k)
    if k < 1:
        raise ValueError(f"top-k needs k >= 1, got {k}")
    return k


# ----------------------------------------------------------------------- #
# Entry points                                                             #
# ----------------------------------------------------------------------- #
def batched_search(gb: GrammarBatch, terms: Sequence[int],
                   k: int = DEFAULT_TOP_K, scheme: str = "bm25",
                   method: str = "frontier"
                   ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Rank every corpus in the pack against one query, on the pack's
    device.

    Returns per real corpus ``(doc_ids [k_i] int32, scores [k_i] float32)``
    with ``k_i = min(k, num_files)``, scores descending, ties broken
    toward the lower file id.  Sharded packs rank per shard and merge on
    the host.
    """
    terms = normalize_terms(terms)
    k = _check_query(k, scheme)
    if gb.mesh is not None:
        m = shard_method(gb, method)
        return gb.map_shards(lambda sub: batched_search(sub, terms, k,
                                                        scheme, m))
    st = batch_search_stats(gb, method)
    t_clip, idf_q = _query_arrays(st.df, st.nf, gb.V_pad, terms, scheme)
    terms_dev = gb._place(np.tile(t_clip[None, :], (gb.n, 1)))
    idf_dev = gb._place(idf_q)
    # k bucketed to pow2 (<= F_pad), as in the JAX package; the per-corpus
    # slice below restores the exact ask
    k_run = min(pow2_bucket(k), gb.F_pad)
    vals, idx = _score_topk_impl(st.tv, terms_dev, idf_dev, st.norm,
                                 st.fvalid, k_run, scheme)
    vals_h = vals.cpu().numpy()
    idx_h = idx.cpu().numpy()
    out: List[Tuple[np.ndarray, np.ndarray]] = []
    for i, ga in enumerate(gb.real_gas):
        k_eff = min(k, ga.num_files)
        out.append((idx_h[i, :k_eff].astype(np.int32), vals_h[i, :k_eff]))
    return out


def _index_device_arrays(si: SearchIndex, dev: torch.device):
    """Copies of an index's tf/norm/valid on ``dev``, memoized on the
    index: repeat single-corpus traffic pays the [F, V] upload once, like
    the batched path's pack-resident statistics."""
    key = str(dev)
    if key not in si._device_cache:
        si._device_cache[key] = (
            torch.as_tensor(si.tf, device=dev)[None],
            torch.as_tensor(si.norm, device=dev)[None],
            torch.ones((1, si.n_docs), dtype=torch.bool, device=dev))
    return si._device_cache[key]


def search_index_topk(si: SearchIndex, terms: Sequence[int],
                      k: int = DEFAULT_TOP_K, scheme: str = "bm25",
                      device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Rank one corpus through its :class:`SearchIndex` on ``device`` (the
    card unless ``"cpu"``) — the same scoring program and host query prep
    as the batched path, at N == 1: results bit-identical to the corpus's
    row in a batched pack."""
    terms = normalize_terms(terms)
    k = _check_query(k, scheme)
    dev = resolve_device(device)
    if si.n_docs == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.float32)
    t_clip, idf_q = _query_arrays(si.df[None, :],
                                  np.array([si.n_docs], np.int64),
                                  si.vocab_size, terms, scheme)
    tf_dev, norm_dev, valid_dev = _index_device_arrays(si, dev)
    k_run = min(pow2_bucket(k), si.n_docs)
    vals, idx = _score_topk_impl(
        tf_dev, torch.as_tensor(t_clip, device=dev)[None],
        torch.as_tensor(idf_q, device=dev), norm_dev, valid_dev, k_run,
        scheme)
    k_eff = min(k, si.n_docs)
    return (idx[0, :k_eff].cpu().numpy().astype(np.int32),
            vals[0, :k_eff].cpu().numpy())


def search_corpus(source, terms: Sequence[int], k: int = DEFAULT_TOP_K,
                  scheme: str = "bm25", method: str = "frontier",
                  device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Single-corpus retrieval on ``device`` (the card unless ``"cpu"``).
    ``source`` is a ``GrammarArrays`` or a ``CompressedCorpus`` — the
    latter's memoized index (and per-file traversal weights) are reused
    across queries."""
    dev = resolve_device(device)
    si = (source.search_index(base_method(method), device=dev)
          if hasattr(source, "search_index")
          else build_search_index(source, method=method, device=dev))
    return search_index_topk(si, terms, k=k, scheme=scheme, device=dev)


def search_sharded(gas: Sequence, terms: Sequence[int],
                   k: int = DEFAULT_TOP_K, scheme: str = "bm25", mesh=None,
                   method: str = "frontier", bucket: bool = True,
                   device=None) -> List[Tuple[np.ndarray, np.ndarray]]:
    """One-call sharded retrieval: pad + pack + shard + rank
    (:func:`repro_torch.distributed.shard_batch.shard_batch`);
    bit-identical to :func:`batched_search` on one pack.  Recurring
    traffic should keep the pack (serving layer) instead of re-packing per
    query."""
    from repro_torch.distributed.shard_batch import shard_batch
    gb = shard_batch(gas, mesh=mesh, bucket=bucket, device=device)
    return batched_search(gb, terms, k=k, scheme=scheme, method=method)
