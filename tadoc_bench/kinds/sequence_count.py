"""``sequence_count``: the count of every l-gram inside files."""

from tadoc_bench.roofline import sequence_bytes


def reference(part, params):
    return part.grams(int(params["l"]))


def input_bytes(sizes, params):
    return sequence_bytes(sizes)
