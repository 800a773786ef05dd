"""Composable compressed-query operators: filter / aggregate / phrase.

The port of the JAX package's ``query``: predicate filters with AND/OR
composition over per-file term counts, grouped sum/max aggregations over
term sets, and exact phrase counts via the paper's §IV-D sequence support
— each evaluated for a whole pack on the card, with statistics drawn from
the same memoized per-file traversal the search subsystem uses, and served
through the same grouping/flush machinery (query kinds ``filter_count`` /
``agg_terms`` / ``phrase_count``).  Every path is bit-equal to the
decompress-then-scan numpy oracle.
"""

from .ops import (AGG_OPS, and_, normalize_agg, normalize_phrase,
                  normalize_predicate, or_, predicate_leaves,
                  predicate_mask, predicate_structure, term_pred)
from .engine import (QUERY_KINDS, agg_corpus, batched_agg, batched_filter,
                     batched_phrase, filter_corpus, phrase_corpus,
                     query_corpus, run_batched_query)
from .frontend import (lookup_term, phrase_from_text, predicate_from_text,
                       terms_from_text)

__all__ = [
    "QUERY_KINDS", "AGG_OPS",
    "term_pred", "and_", "or_", "normalize_predicate", "normalize_agg",
    "normalize_phrase", "predicate_leaves", "predicate_structure",
    "predicate_mask",
    "batched_filter", "batched_agg", "batched_phrase",
    "filter_corpus", "agg_corpus", "phrase_corpus",
    "run_batched_query", "query_corpus",
    "lookup_term", "terms_from_text", "phrase_from_text",
    "predicate_from_text",
]
