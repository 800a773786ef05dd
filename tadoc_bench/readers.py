"""What the metric readers (``e2e/``, ``metrics/``) share.

Each reader is a module with ``read(run) -> float | None``, where ``run``
is the :class:`tadoc_bench.harness.RunRecord` of one run; it returns None
when the run holds nothing for it to read, and the metric is then left
out of the run's line.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def stage_spans(run, stage: str, kind: Optional[str] = None) -> List:
    """The server's ``stage`` spans (``execute``, ``pack_build``, ...) of
    the window, each once; with ``kind``, only those of chunks of that
    kind."""
    out, seen = [], set()
    for tree in run.span_trees():
        for chunk in tree.walk():
            if chunk.name != "chunk" or id(chunk) in seen:
                continue
            seen.add(id(chunk))
            if kind is not None and chunk.attrs.get("kind") != kind:
                continue
            out += [s for s in chunk.children if s.name == stage]
    return out


def mean_ms(spans) -> Optional[float]:
    if not spans:
        return None
    return float(np.mean([s.duration for s in spans])) * 1e3


def idle_pct(run) -> Optional[float]:
    """The device's idle share of the profiled span."""
    t = run.trace
    if t is None or not t["window_s"] > 0 or not t["busy_s"] > 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
