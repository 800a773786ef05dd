"""``device_idle_pct``: the share of the profiled span in which no
operation ran on the device (the profiler's trace)."""

from tadoc_bench.readers import idle_pct


def read(run):
    return idle_pct(run)
