"""TADOC core, ported: text analytics directly on Sequitur-compressed data.

Pipeline: ``sequitur.compress_files`` (offline, host) ->
``grammar.flatten`` (static layout) -> ``batch.GrammarBatch`` (N corpora
packed on the device) -> the six analytics via ``batch.run_batched``.
"""

from .sequitur import Grammar, IncrementalSequitur, compress_files
from .grammar import GrammarArrays, StaleGrammarError, flatten, pow2_bucket
from .batch import (ANALYTICS_KINDS, METHODS, GrammarBatch,
                    batched_inverted_index, batched_per_file_weights,
                    batched_ranked_inverted_index, batched_sequence_count,
                    batched_sort_words, batched_term_vector,
                    batched_top_down_weights, batched_word_count,
                    resolve_batch_method, resolve_traversal_method,
                    run_batched, unbatch)

__all__ = [
    "Grammar", "IncrementalSequitur", "compress_files",
    "GrammarArrays", "StaleGrammarError", "flatten", "pow2_bucket",
    "GrammarBatch", "batched_top_down_weights", "batched_per_file_weights",
    "batched_word_count", "batched_sort_words", "batched_term_vector",
    "batched_inverted_index", "batched_ranked_inverted_index",
    "batched_sequence_count", "run_batched", "unbatch", "ANALYTICS_KINDS",
    "METHODS", "resolve_traversal_method", "resolve_batch_method",
]
