"""``sequence_count_ms``: the mean of the server's ``execute`` spans of
``sequence_count`` chunks (host sequence planning and the window count)."""

from tadoc_bench.readers import mean_ms, stage_spans


def read(run):
    return mean_ms(stage_spans(run, "execute", kind="sequence_count"))
