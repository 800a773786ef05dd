"""``word_count``: how often each word occurs in a partition."""

from tadoc_bench.roofline import top_down_bytes


def reference(part, params):
    return part.word_count


def input_bytes(sizes, params):
    return top_down_bytes(sizes)
