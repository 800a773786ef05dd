"""``execute_ms``: the mean of the server's ``execute`` spans in the window
(one batched call, ending with its answers copied to the host)."""

from tadoc_bench.readers import mean_ms, stage_spans


def read(run):
    return mean_ms(stage_spans(run, "execute"))
