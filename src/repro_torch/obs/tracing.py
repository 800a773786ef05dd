"""Span-based tracing of a query's lifecycle, plus the bounded event logs.

A :class:`Span` is one named interval with attributes and children; the
serving layer builds one tree per query — submit → (queue_wait) → flush →
chunk → pack_build → plan:* → compile-or-execute — carried on
``Query.trace`` / ``FlushEvent.span`` and appended to the owning server's
bounded ``trace_log``.  Trees may *share* subtrees: a flush that answers
five queries is one flush span appearing under five query roots, which is
exactly the batching the engine performed.

Propagation is ambient: :func:`span` (and :func:`activate`) push the
current span **and its clock** onto a :class:`contextvars.ContextVar`, so
instrumented library code (``plan_stage`` in core/batch.py,
search/engine.py) attaches children to whatever query is executing without
any parameter threading — and reads time from the same injectable clock
domain as the server that opened the root (simulated-clock tests stay
deterministic).  Context vars are per-thread, so concurrent flushes build
disjoint trees.

When no span is active, ``plan_stage`` still feeds the global
``repro_plan_build_seconds`` histogram and costs one contextvar read
otherwise — instrumentation must be safe to leave on everywhere.
"""

from __future__ import annotations

import math
import time
from collections import deque
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from .registry import global_registry

__all__ = ["Span", "span", "activate", "current", "current_clock",
           "plan_stage", "BoundedLog", "span_problems"]


@dataclass
class Span:
    """One named interval in a query's lifecycle tree."""
    name: str
    t0: float
    t1: float = math.nan               # nan until finish()
    attrs: Dict[str, object] = field(default_factory=dict)
    children: List["Span"] = field(default_factory=list)

    def finish(self, t: float) -> "Span":
        if not self.finished:
            self.t1 = t
        return self

    @property
    def finished(self) -> bool:
        return not math.isnan(self.t1)

    @property
    def duration(self) -> float:
        return (self.t1 - self.t0) if self.finished else math.nan

    def walk(self) -> Iterator["Span"]:
        """Pre-order traversal of the tree rooted here."""
        stack = [self]
        while stack:
            s = stack.pop()
            yield s
            stack.extend(reversed(s.children))

    def find(self, name: str) -> List["Span"]:
        return [s for s in self.walk() if s.name == name]

    def to_dict(self) -> dict:
        """JSON-safe rendering (shared subtrees are duplicated)."""
        return {"name": self.name, "t0": self.t0,
                "t1": None if not self.finished else self.t1,
                "attrs": dict(self.attrs),
                "children": [c.to_dict() for c in self.children]}


# (active span, its clock) — per-thread/task via contextvars
_ACTIVE: ContextVar[Optional[Tuple[Span, Callable[[], float]]]] = \
    ContextVar("repro_torch_obs_active_span", default=None)


def current() -> Optional[Span]:
    """The ambient span, or None outside any instrumented scope."""
    top = _ACTIVE.get()
    return None if top is None else top[0]


def current_clock() -> Callable[[], float]:
    """The clock of the ambient span (``time.monotonic`` outside one)."""
    top = _ACTIVE.get()
    return time.monotonic if top is None else top[1]


@contextmanager
def activate(s: Span, clock: Callable[[], float]):
    """Make an *externally managed* span ambient: children attach to it,
    but entering/exiting does not start/finish it (the serving layer opens
    query roots at submit time and finishes them when futures resolve)."""
    token = _ACTIVE.set((s, clock))
    try:
        yield s
    finally:
        _ACTIVE.reset(token)


@contextmanager
def span(name: str, clock: Optional[Callable[[], float]] = None,
         attrs: Optional[dict] = None):
    """Open a child of the ambient span (or a root), finish it on exit.
    Without an explicit ``clock`` the parent's clock domain is inherited."""
    parent = _ACTIVE.get()
    clk = clock if clock is not None else (
        parent[1] if parent is not None else time.monotonic)
    s = Span(name, clk(), attrs=dict(attrs) if attrs else {})
    if parent is not None:
        parent[0].children.append(s)
    token = _ACTIVE.set((s, clk))
    try:
        yield s
    finally:
        _ACTIVE.reset(token)
        s.finish(clk())


@contextmanager
def plan_stage(plan: str):
    """Instrument one host-side plan construction (the lazy pack memos:
    ``ell`` / ``sequence`` / ``search_stats``).  Attaches a ``plan:<name>``
    child to the ambient span when one is active, and always feeds the
    global ``repro_plan_build_seconds{plan=...}`` histogram — plan builds
    happen inside cached properties, so which *query* paid the build cost
    is visible only through this hook."""
    parent = _ACTIVE.get()
    clk = parent[1] if parent is not None else time.monotonic
    t0 = clk()
    s: Optional[Span] = None
    if parent is not None:
        s = Span(f"plan:{plan}", t0)
        parent[0].children.append(s)
    try:
        yield s
    finally:
        t1 = clk()
        if s is not None:
            s.finish(t1)
        global_registry().histogram(
            "repro_plan_build_seconds",
            "host-side plan construction per lazy pack memo",
            ("plan",)).labels(plan).observe(t1 - t0)


class BoundedLog:
    """``deque(maxlen=n)`` with drop accounting: appending past capacity
    evicts the oldest entry and counts it (optionally into a gauge), so
    truncation under overload is visible instead of silent — the fix for
    the queue's raw ``flush_log`` ring."""

    def __init__(self, maxlen: int, gauge=None):
        if maxlen < 1:
            raise ValueError("maxlen must be >= 1")
        self._d: deque = deque(maxlen=maxlen)
        self._gauge = gauge
        self.dropped = 0

    @property
    def maxlen(self) -> int:
        return self._d.maxlen

    def append(self, item) -> None:
        if len(self._d) == self._d.maxlen:
            self.dropped += 1
            if self._gauge is not None:
                self._gauge.set(float(self.dropped))
        self._d.append(item)

    def clear(self) -> None:
        self._d.clear()

    def __len__(self) -> int:
        return len(self._d)

    def __getitem__(self, i):
        return self._d[i]

    def __iter__(self):
        return iter(self._d)

    def __repr__(self) -> str:
        return (f"BoundedLog(len={len(self._d)}, "
                f"maxlen={self._d.maxlen}, dropped={self.dropped})")


def span_problems(root: Span, require: Tuple[str, ...] = (),
                  eps: float = 1e-6) -> List[str]:
    """Structural validation of one span tree — the test harness for the
    'no stage gaps' acceptance bar.  Checks every span is finished and
    non-negative, children stay inside their parent's interval and start
    in order, and each ``require`` name appears somewhere in the tree.
    Returns human-readable problems ([] == clean)."""
    problems: List[str] = []
    names: List[str] = []

    def walk(s: Span, lo: Optional[float], hi: Optional[float]) -> None:
        names.append(s.name)
        if not s.finished:
            problems.append(f"span {s.name!r} never finished")
        else:
            if s.t1 < s.t0 - eps:
                problems.append(f"span {s.name!r} ends before it starts "
                                f"({s.t0} -> {s.t1})")
            if lo is not None and (s.t0 < lo - eps or s.t1 > hi + eps):
                problems.append(
                    f"span {s.name!r} [{s.t0}, {s.t1}] escapes its "
                    f"parent [{lo}, {hi}]")
        prev = None
        for c in s.children:
            if prev is not None and c.t0 < prev - eps:
                problems.append(f"children of {s.name!r} start out of "
                                f"order at {c.name!r}")
            prev = c.t0
            if s.finished:
                walk(c, s.t0, s.t1)
            else:
                walk(c, None, None)

    walk(root, None, None)
    for r in require:
        if r not in names:
            problems.append(f"missing required span {r!r} "
                            f"(tree has {sorted(set(names))})")
    return problems
