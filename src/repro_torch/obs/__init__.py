"""Unified observability layer: metrics registry + lifecycle tracing (a
copy of the JAX package's ``obs``, with its metric and span names).

``registry`` — thread-safe counters/gauges/fixed-bucket histograms with
JSON (:meth:`MetricsRegistry.snapshot`) and Prometheus-text
(:meth:`MetricsRegistry.render_prometheus`) exposition; ``tracing`` —
span trees following a query from submit to result, with ambient
(contextvar) propagation so library code attaches children without
parameter threading.  ``global_registry()`` holds library-level metrics
(kernel dispatch, store memos, ingest, plan builds); each
:class:`~repro_torch.serving.AnalyticsServer` owns a private registry for
its serving metrics.
"""

from .registry import DEFAULT_BUCKETS, MetricsRegistry, global_registry
from .tracing import (BoundedLog, Span, activate, current, current_clock,
                      plan_stage, span, span_problems, traverse)

__all__ = ["MetricsRegistry", "DEFAULT_BUCKETS", "global_registry",
           "Span", "span", "activate", "current", "current_clock",
           "plan_stage", "traverse", "BoundedLog", "span_problems"]
