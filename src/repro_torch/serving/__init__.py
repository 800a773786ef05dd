"""Serving on the card: the query-dispatch layer over the batched
multi-corpus analytics engine (``AnalyticsServer``) and its async
deadline-aware submission queue (``AsyncAnalyticsServer``).  The JAX
package's LM decode loop is not ported yet."""

from .analytics_server import AnalyticsServer, Query, ServerStats, \
    SERVED_KINDS
from .queue import (AsyncAnalyticsServer, DeadlineExceeded, FlushEvent,
                    QueueFull)

__all__ = ["AnalyticsServer", "Query", "ServerStats", "SERVED_KINDS",
           "AsyncAnalyticsServer", "DeadlineExceeded", "FlushEvent",
           "QueueFull"]
