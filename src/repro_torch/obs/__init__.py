"""Observability for the port: the process metrics registry and the
host-side plan-build hook (the parts of the JAX package's ``obs`` layer
that the packed engine calls).  ``global_registry()`` holds the
library-level counters: kernel dispatch decisions (kernels/ops.py),
ingest throughput (core/sequitur.py) and plan builds (``plan_stage``)."""

from .registry import DEFAULT_BUCKETS, MetricsRegistry, global_registry
from .tracing import Span, current, plan_stage, span

__all__ = ["MetricsRegistry", "DEFAULT_BUCKETS", "global_registry",
           "Span", "span", "current", "plan_stage"]
