"""``term_vector``: each file's count of each word (dense ``[F, V]``)."""

from tadoc_bench.roofline import per_file_bytes


def reference(part, params):
    return part.term_vector


def input_bytes(sizes, params):
    return per_file_bytes(sizes)
