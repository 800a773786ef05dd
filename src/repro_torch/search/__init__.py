"""Compressed-domain ranked retrieval: BM25 / TF-IDF top-k directly on
grammars, on the card.

The port of the JAX package's ``search``: term frequencies, document
frequencies and document lengths are derived from the batched per-file
traversal weights (never from decompressed text), idf tables are prepared
on host (numpy float32 — bit-stable against the decompress-then-scan
oracle), and scoring + top-k run on the pack's device — batched across
corpora and served through the same grouping/flush machinery as the six
analytics (query kinds ``search_bm25`` / ``search_tfidf``).
"""

from .scoring import (DEFAULT_TOP_K, KIND_SCHEME, SCHEMES, SEARCH_KINDS,
                      idf_bm25, idf_tfidf, normalize_terms)
from .index import SearchIndex, base_method, build_search_index
from .engine import (batch_search_stats, batched_search, search_corpus,
                     search_index_topk)

__all__ = [
    "SEARCH_KINDS", "KIND_SCHEME", "SCHEMES", "DEFAULT_TOP_K",
    "idf_bm25", "idf_tfidf", "normalize_terms",
    "SearchIndex", "build_search_index", "base_method",
    "batched_search", "search_corpus", "search_index_topk",
    "batch_search_stats",
]
