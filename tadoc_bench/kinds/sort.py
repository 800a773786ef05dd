"""``sort``: the words by descending count, with their counts."""

from tadoc_bench.reference import sort_words
from tadoc_bench.roofline import top_down_bytes


def reference(part, params):
    return sort_words(part.word_count)


def input_bytes(sizes, params):
    return top_down_bytes(sizes)
