"""Span trees with ambient (contextvar) propagation, and ``plan_stage``.

The same model as the JAX package's ``obs/tracing.py``, cut to what the
packed engine uses: :func:`span` pushes the current span and its clock onto
a :class:`contextvars.ContextVar`, so library code (``plan_stage`` in
core/batch.py) attaches children to whatever request is executing without
parameter threading.  When no span is active, ``plan_stage`` still feeds
the global ``repro_plan_build_seconds`` histogram.
"""

from __future__ import annotations

import math
import time
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from .registry import global_registry

__all__ = ["Span", "span", "current", "plan_stage"]


@dataclass
class Span:
    """One named interval in a request's lifecycle tree."""
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


# (active span, its clock) — per-thread/task via contextvars
_ACTIVE: ContextVar[Optional[Tuple[Span, Callable[[], float]]]] = \
    ContextVar("repro_torch_obs_active_span", default=None)


def current() -> Optional[Span]:
    """The ambient span, or None outside any instrumented scope."""
    top = _ACTIVE.get()
    return None if top is None else top[0]


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
    ``ell`` / ``sequence``).  Attaches a ``plan:<name>`` child to the
    ambient span when one is active, and always feeds the global
    ``repro_plan_build_seconds{plan=...}`` histogram."""
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
