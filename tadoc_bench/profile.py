"""The device trace of a traced run: ``torch.profiler`` over a steady span.

:class:`DeviceTrace` starts the profiler, marks the profiled span with a
host annotation (``tadoc_bench.window``) whose interval, in the trace's own
clock, is the window every figure here is taken over, and reduces the
trace to:

``busy_s``     the union of the intervals in which a device operation
               (kernel, copy, set) ran, inside the window;
``window_s``   the window's length;
``device_ops`` the ten operations that took most device time, by name;
``idle_gaps``  the device's idle time inside the window, by what the host
               was doing: the innermost host operation (a torch op, a CUDA
               runtime call, or a request's annotation when the host was
               in Python alone) covering each gap's midpoint, summed by
               name, the ten largest.
"""

from __future__ import annotations

import heapq
from collections import defaultdict
from contextlib import ExitStack
from typing import Dict, List, Optional, Tuple

WINDOW = "tadoc_bench.window"
REQUEST = "tadoc_bench.request:"


def _events(prof):
    """(device [(start, end, name)], host [(start, end, name)]) in ns."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = int(e.start_ns())
        end = start + int(e.duration_ns())
        name = e.name()
        ann = getattr(e, "is_user_annotation", None)
        if e.device_type() == DeviceType.CUDA:
            if (ann is not None and ann()) or name.startswith("tadoc_bench"):
                continue            # the annotations' device-side copies
            dev.append((start, end, name))
        elif e.device_type() == DeviceType.CPU:
            host.append((start, end, name))
    return dev, host


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _innermost(points: List[int], host) -> List[str]:
    """For each point (sorted), the name of the shortest host event that
    covers it ("host, no traced op" where none does)."""
    host = sorted(host)
    heap: List[Tuple[int, int, str]] = []
    names, j = [], 0
    for m in points:
        while j < len(host) and host[j][0] <= m:
            s, e, name = host[j]
            heapq.heappush(heap, (e - s, e, name))
            j += 1
        while heap and heap[0][1] < m:
            heapq.heappop(heap)
        names.append(heap[0][2] if heap else "host, no traced op")
    return names


def reduce(dev, host, t0: int, t1: int) -> Dict[str, object]:
    """The figures of the window ``[t0, t1)`` (ns) from the trace's
    device and host events."""
    clipped = [(max(s, t0), min(e, t1), n) for s, e, n in dev
               if e > t0 and s < t1]
    busy = _union([(s, e) for s, e, _ in clipped])
    by_op: Dict[str, int] = defaultdict(int)
    for s, e, n in clipped:
        by_op[n[:160]] += e - s
    gaps, prev = [], t0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if prev < t1:
        gaps.append((prev, t1))
    inner = [h for h in host if h[2] != WINDOW]
    by_host: Dict[str, int] = defaultdict(int)
    for (s, e), name in zip(gaps, _innermost([(s + e) // 2
                                              for s, e in gaps], inner)):
        by_host[name[:160]] += e - s
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": sum(e - s for s, e in busy) / 1e9,
            "window_s": (t1 - t0) / 1e9,
            "device_ops": [[n, ns / 1e9] for n, ns in top],
            "idle_gaps": [[n, ns / 1e9] for n, ns in idle]}


class DeviceTrace:
    """Profile the device from :meth:`start` to :meth:`stop`, called on
    request boundaries; :attr:`summary` holds the reduced figures."""

    def __init__(self, device):
        self.device = device
        self.summary: Optional[Dict[str, object]] = None
        self._stack: Optional[ExitStack] = None

    def _sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _activities(self):
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return acts

    def prime(self) -> None:
        """Bring the profiler up once (its first start takes about a
        second), so that starting it in the window costs little."""
        import torch
        from torch.profiler import profile
        with profile(activities=self._activities()):
            torch.zeros(1, device=self.device).add_(1)
            self._sync()

    def start(self) -> None:
        from torch.profiler import profile, record_function
        self._sync()
        self._stack = ExitStack()
        self._prof = self._stack.enter_context(
            profile(activities=self._activities()))
        self._stack.enter_context(record_function(WINDOW))

    def stop(self) -> None:
        self._sync()
        self._stack.close()
        dev, host = _events(self._prof)
        win = [h for h in host if h[2] == WINDOW]
        t0, t1 = win[0][0], win[0][1]
        self.summary = reduce(dev, host, t0, t1)
        self._prof = None

    @property
    def active(self) -> bool:
        return self._stack is not None and self.summary is None
