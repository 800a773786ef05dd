"""``inverted_index``: which files hold each word (dense bool ``[F, V]``)."""

from tadoc_bench.roofline import per_file_bytes


def reference(part, params):
    return part.term_vector > 0


def input_bytes(sizes, params):
    return per_file_bytes(sizes)
