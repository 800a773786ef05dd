"""``ranked_inverted_index``: per word, the files by descending count."""

from tadoc_bench.reference import ranked
from tadoc_bench.roofline import per_file_bytes


def reference(part, params):
    return ranked(part.term_vector)


def input_bytes(sizes, params):
    return per_file_bytes(sizes)
