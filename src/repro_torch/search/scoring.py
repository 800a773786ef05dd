"""Host-side scoring math for compressed-domain ranked retrieval.

A numpy copy of the JAX package's ``search/scoring.py`` (same constants,
same expressions, same operation order).  The retrieval subsystem answers
multi-term queries with BM25 or plain TF-IDF top-k document rankings
computed *directly from the grammar* — term frequencies, document
frequencies and document lengths all come from the per-file traversal
weights (no decompression anywhere).  This module owns the scoring
formulas; :mod:`repro_torch.search.engine` owns the batched evaluation on
the card.

DESIGN — why the transcendental parts live on host, in numpy float32:
rankings must be *bit-identical* to the decompress-then-scan oracle and to
the JAX package, and IEEE float32 add/mul/div are exactly specified — but
``log`` is not: the card's libm, XLA's and numpy's disagree by a couple of
ulp.  So everything that needs a ``log`` (the idf tables) or feeds a
division chain that is cheap per *document* rather than per (document,
term) (the BM25 length normalizer) is computed here with numpy on the
small host-side ``df``/``dl`` statistics, and the device program is left
with only exactly-specified elementwise ops.  Every expression below is
deliberately float32 end to end and must keep its operation ORDER if
edited.

Formulas (the classic Robertson/Sparck-Jones variants):

* ``idf_bm25(df, n) = ln(1 + (n - df + 0.5) / (df + 0.5))`` — the
  "+1 inside the log" form, positive for every df in [0, n];
* ``bm25`` per-(doc, term) contribution:
  ``idf * tf * (k1 + 1) / (tf + k1 * (1 - b + b * dl / avgdl))``;
* ``idf_tfidf(df, n) = ln((n + 1) / (df + 1)) + 1`` (smoothed, positive);
  ``tfidf`` contribution: ``idf * tf``.

A term outside a corpus's vocabulary simply has ``tf == df == 0``: it
contributes exactly ``+0.0`` to every document's score, so out-of-vocab
(and padded) query slots need no special cases anywhere downstream.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

#: Query kinds served by the retrieval subsystem (serving layer accepts
#: these alongside core.batch.ANALYTICS_KINDS).
SEARCH_KINDS = ("search_bm25", "search_tfidf")

#: Query kind -> scoring scheme.
KIND_SCHEME = {"search_bm25": "bm25", "search_tfidf": "tfidf"}

SCHEMES = ("bm25", "tfidf")

#: Documents returned when a search query does not say how many.
DEFAULT_TOP_K = 10

# BM25 free parameters (the standard defaults), pinned to float32 — the
# device scorer and the numpy oracle must see the exact same constants.
K1 = np.float32(1.2)
B = np.float32(0.75)
_ONE = np.float32(1.0)
_HALF = np.float32(0.5)
K1P1 = K1 + _ONE


def normalize_terms(terms: Optional[Sequence[int]]) -> Tuple[int, ...]:
    """Canonical query-term tuple: ints, order preserved (scores accumulate
    in term order, so order is part of the query identity), duplicates kept
    (a repeated term legitimately counts twice).  Empty/None is an error —
    a search with no terms has no defined ranking."""
    if terms is None:
        raise ValueError("search queries need a non-empty terms sequence")
    out = tuple(int(t) for t in terms)
    if not out:
        raise ValueError("search queries need at least one term")
    if any(t < 0 for t in out):
        raise ValueError(f"negative term ids are invalid: {out}")
    return out


def idf_bm25(df: np.ndarray, n_docs) -> np.ndarray:
    """BM25 idf, float32, elementwise over ``df`` (``n_docs`` broadcasts).
    Positive for every df in [0, n]; df == 0 (out-of-vocab term) is
    well-defined and never reached by a non-zero tf anyway."""
    df = np.asarray(df, np.float32)
    n = np.asarray(n_docs, np.float32)
    return np.log(_ONE + (n - df + _HALF) / (df + _HALF)).astype(np.float32)


def idf_tfidf(df: np.ndarray, n_docs) -> np.ndarray:
    """Smoothed TF-IDF idf, float32: ``ln((n + 1) / (df + 1)) + 1``."""
    df = np.asarray(df, np.float32)
    n = np.asarray(n_docs, np.float32)
    return (np.log((n + _ONE) / (df + _ONE)) + _ONE).astype(np.float32)


def idf(df: np.ndarray, n_docs, scheme: str) -> np.ndarray:
    if scheme == "bm25":
        return idf_bm25(df, n_docs)
    if scheme == "tfidf":
        return idf_tfidf(df, n_docs)
    raise ValueError(f"unknown scoring scheme {scheme!r}; "
                     f"expected one of {SCHEMES}")


def avg_doc_len(dl: np.ndarray, n_docs: Optional[int] = None) -> np.float32:
    """Mean document length in float32.  ``n_docs`` overrides the divisor
    when ``dl`` carries padded (all-zero) document slots beyond the real
    count.  An all-empty corpus gets 1.0 so the BM25 length normalizer
    stays finite (tf == 0 everywhere then; scores are all +0.0)."""
    dl = np.asarray(dl, np.float32)
    n = int(dl.shape[0]) if n_docs is None else int(n_docs)
    avg = np.float32(dl.sum(dtype=np.float32)) / np.float32(max(n, 1))
    return avg if avg > 0 else _ONE


def bm25_norm(dl: np.ndarray, avgdl) -> np.ndarray:
    """Per-document BM25 length normalizer ``k1 * (1 - b + b*dl/avgdl)``,
    float32, elementwise over ``dl`` — the whole denominator except the
    per-term tf.  Strictly positive (dl >= 0, avgdl > 0)."""
    dl = np.asarray(dl, np.float32)
    return (K1 * (_ONE - B + B * (dl / np.float32(avgdl)))).astype(
        np.float32)
