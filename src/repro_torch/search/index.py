"""Per-corpus search index derived from the compressed grammar.

The port of the JAX package's ``search/index.py``.  A :class:`SearchIndex`
is the retrieval-side view of one corpus: the ``[F, V]`` term-frequency
table, ``[F]`` document lengths, ``[V]`` document frequencies and the BM25
length normalizer — all computed from the per-file traversal weights
(:func:`repro_torch.core.analytics.term_vector`, on the card unless the
caller asks for the CPU), never from decompressed text.  Building one
costs a single per-file traversal; everything else is host-side numpy over
the resulting integer statistics.

The index is memoized like traversal weights:
:meth:`repro_torch.data.store.CompressedCorpus.search_index` caches it per
(corpus, traversal base, device), so recurring search traffic against a
registered store pays the traversal once.  Batched packs keep the
equivalent statistics on the pack itself (:mod:`repro_torch.search.engine`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.analytics import term_vector
from repro_torch.core.grammar import GrammarArrays
from repro_torch.kernels._common import resolve_device

from .scoring import avg_doc_len, bm25_norm, idf

#: The per-file traversal base an index build (or the pack-level search
#: statistics) runs for each requested method: the ELL methods run their
#: vector-payload per-file rounds, ``frontier_fused`` its per-round ELL base
#: (the fused kernel is scalar-payload), and ``auto`` the frontier base so
#: index cache keys stay stable across pack shapes — the JAX package's map.
_BASE_METHOD = {"frontier_fused": "frontier_ell", "auto": "frontier",
                "top_down": "frontier", "bottom_up": "frontier"}


def base_method(method: str) -> str:
    """The per-file traversal base a search index build actually runs."""
    return _BASE_METHOD.get(method, method)


@dataclass(frozen=True)
class SearchIndex:
    """Host-side retrieval statistics of one corpus (all float32; every
    value is an integer count except ``avgdl`` and ``norm``)."""

    tf: np.ndarray        # [F, V] term frequencies (== term_vector)
    dl: np.ndarray        # [F] document lengths (word terminals per file)
    df: np.ndarray        # [V] document frequencies
    norm: np.ndarray      # [F] BM25 length normalizer (bm25_norm(dl, avgdl))
    avgdl: np.float32     # mean document length (>= 1.0 guard on empty)
    n_docs: int           # F
    vocab_size: int       # V
    # device copies of tf/norm/valid, keyed by device and filled by the
    # scoring engine on first use: repeat single-corpus queries must not
    # re-upload the [F, V] table per call (a mutable memo on a frozen
    # dataclass, like the pack's plan cache)
    _device_cache: dict = field(default_factory=dict, repr=False,
                                compare=False)

    def idf_for_terms(self, terms, scheme: str) -> np.ndarray:
        """float32 ``[Q]`` idf values for a term-id sequence; out-of-range
        ids get df == 0 (their tf is 0 everywhere, contribution +0.0)."""
        t = np.asarray(terms, np.int64)
        df_q = np.zeros(len(t), np.float32)
        ok = (t >= 0) & (t < self.vocab_size)
        df_q[ok] = self.df[t[ok]]
        return idf(df_q, self.n_docs, scheme)


def build_search_index(source, method: str = "frontier",
                       device=None) -> SearchIndex:
    """Build a :class:`SearchIndex` from a :class:`GrammarArrays` or
    anything carrying one as ``.ga`` (a ``CompressedCorpus`` — duck-typed
    so this module never imports the store and the store can lazily import
    it).  The traversal runs on ``device`` (the card unless ``"cpu"``); a
    source with memoized ``per_file_weights`` contributes them, so
    store-backed builds share the traversal with the other per-file
    analytics."""
    m = base_method(method)
    dev = resolve_device(device)
    ga = getattr(source, "ga", source)
    if not isinstance(ga, GrammarArrays):
        raise TypeError(f"cannot index {type(source).__name__}")
    fw = (source.per_file_weights(m, device=dev)
          if hasattr(source, "per_file_weights") else None)
    tf = term_vector(ga, method=m, file_weights=fw,
                     device=dev).cpu().numpy().astype(np.float32)
    dl = tf.sum(axis=1, dtype=np.float32)
    df = (tf > 0).sum(axis=0).astype(np.float32)
    avgdl = avg_doc_len(dl)
    return SearchIndex(tf=tf, dl=dl, df=df, norm=bm25_norm(dl, avgdl),
                       avgdl=avgdl, n_docs=int(ga.num_files),
                       vocab_size=int(ga.vocab_size))
