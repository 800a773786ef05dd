"""Serving on the card: batched KV-cache decode of the LM zoo on top of
``models.decode_step``, plus the query-dispatch layer over the batched
multi-corpus analytics engine (``AnalyticsServer``) and its async
deadline-aware submission queue (``AsyncAnalyticsServer``)."""

from .decode import make_serve_step, make_prefill_step, greedy_generate
from .analytics_server import AnalyticsServer, Query, ServerStats, \
    SERVED_KINDS
from .queue import (AsyncAnalyticsServer, DeadlineExceeded, FlushEvent,
                    QueueFull)

__all__ = ["make_serve_step", "make_prefill_step", "greedy_generate",
           "AnalyticsServer", "Query", "ServerStats", "SERVED_KINDS",
           "AsyncAnalyticsServer", "DeadlineExceeded", "FlushEvent",
           "QueueFull"]
