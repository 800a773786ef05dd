"""TADOC core, ported: text analytics directly on Sequitur-compressed data.

Pipeline: ``sequitur.compress_files`` (offline, host) ->
``grammar.flatten`` (static layout) -> ``traversal`` / ``analytics`` /
``sequence`` (one corpus on the device) with ``memory`` planning the
arenas and ``selector`` choosing the traversal strategy, or
``batch.GrammarBatch`` (N corpora packed on the device) -> the six
analytics via ``batch.run_batched``.
"""

from .sequitur import Grammar, IncrementalSequitur, compress, compress_files
from .grammar import (GrammarArrays, StaleGrammarError, expand_range,
                      flatten, pow2_bucket)
from .batch import (ANALYTICS_KINDS, METHODS, GrammarBatch,
                    batched_inverted_index, batched_per_file_weights,
                    batched_ranked_inverted_index, batched_sequence_count,
                    batched_sort_words, batched_term_vector,
                    batched_top_down_weights, batched_word_count,
                    resolve_batch_method, resolve_traversal_method,
                    run_batched, unbatch)
from .traversal import (bottom_up_bounds, bottom_up_tables, per_file_weights,
                        resolve_single_method, top_down_weights,
                        traversal_rounds)
from .analytics import (inverted_index, ranked_inverted_index,
                        sequence_count, sort_words, term_vector,
                        term_vector_sparse, word_count)
from .selector import estimate_costs, select_direction
from .memory import (ArenaPlan, head_tail_upper_limit, plan_local_tables,
                     plan_streams, stream_upper_limit)

__all__ = [
    "Grammar", "IncrementalSequitur", "compress", "compress_files",
    "GrammarArrays", "StaleGrammarError", "flatten", "expand_range",
    "pow2_bucket",
    "top_down_weights", "per_file_weights", "bottom_up_tables",
    "bottom_up_bounds", "traversal_rounds", "resolve_single_method",
    "word_count", "sort_words", "inverted_index", "term_vector",
    "ranked_inverted_index", "sequence_count", "term_vector_sparse",
    "select_direction", "estimate_costs",
    "ArenaPlan", "plan_local_tables", "plan_streams",
    "head_tail_upper_limit", "stream_upper_limit",
    "GrammarBatch", "batched_top_down_weights", "batched_per_file_weights",
    "batched_word_count", "batched_sort_words", "batched_term_vector",
    "batched_inverted_index", "batched_ranked_inverted_index",
    "batched_sequence_count", "run_batched", "unbatch", "ANALYTICS_KINDS",
    "METHODS", "resolve_traversal_method", "resolve_batch_method",
]
