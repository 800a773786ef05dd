"""Thread-safe metrics registry: counters and fixed-bucket histograms.

The same model as the JAX package's ``obs/registry.py``, cut to what the
packed engine records: one :class:`MetricsRegistry` holds named metric
*families*; a family with label names fans out into per-label-value
children, and a label-less family IS its single child
(``registry.counter("x", "...").inc()`` just works).  All mutation goes
through one re-entrant lock, so ``inc``/``observe`` from many threads never
lose updates.  Exposition (JSON, Prometheus text) comes with the serving
slice that reads it.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Dict, Iterable, Optional, Tuple

__all__ = ["MetricsRegistry", "DEFAULT_BUCKETS", "global_registry"]

#: Default latency buckets (seconds): log-spaced from 100 us to 60 s, + +Inf.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, math.inf)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


class _Counter:
    """Monotonic counter child."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increments must be >= 0, got {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _Histogram:
    """Fixed-bucket histogram."""

    __slots__ = ("_lock", "_uppers", "_counts", "_sum", "_count")

    def __init__(self, lock: threading.RLock, buckets: Tuple[float, ...]):
        self._lock = lock
        self._uppers = buckets
        self._counts = [0] * len(buckets)
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        with self._lock:
            self._count += 1
            self._sum += v
            for i, ub in enumerate(self._uppers):
                if v <= ub:
                    self._counts[i] += 1
                    break

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum


class _Family:
    """One named metric family; children keyed by label-value tuples."""

    def __init__(self, registry: "MetricsRegistry", kind: str, name: str,
                 help_: str, labelnames: Tuple[str, ...],
                 buckets: Tuple[float, ...]):
        self.registry = registry
        self.kind = kind
        self.name = name
        self.help = help_
        self.labelnames = labelnames
        self.buckets = buckets
        self._children: Dict[Tuple[str, ...], object] = {}
        if not labelnames:
            self.labels()                      # materialize the bare child

    def labels(self, *values: str):
        """The child for one label-value combination (created on first
        use; values coerced to str)."""
        if len(values) != len(self.labelnames):
            raise ValueError(f"{self.name} takes {len(self.labelnames)} "
                             f"label values {self.labelnames}, "
                             f"got {values!r}")
        key = tuple(str(v) for v in values)
        with self.registry._lock:
            child = self._children.get(key)
            if child is None:
                child = (_Histogram(self.registry._lock, self.buckets)
                         if self.kind == "histogram"
                         else _Counter(self.registry._lock))
                self._children[key] = child
            return child

    # ---- label-less proxy: the family IS its single child ----
    def _bare(self):
        if self.labelnames:
            raise ValueError(f"{self.name} has labels {self.labelnames}; "
                             f"use .labels(...)")
        return self._children[()]

    def inc(self, n: float = 1.0) -> None:
        self._bare().inc(n)

    def observe(self, v: float) -> None:
        self._bare().observe(v)

    @property
    def value(self) -> float:
        return self._bare().value

    @property
    def count(self) -> int:
        return self._bare().count


class MetricsRegistry:
    """Named metric families behind one lock; see the module docstring."""

    def __init__(self):
        self._lock = threading.RLock()
        self._families: Dict[str, _Family] = {}

    def _register(self, kind: str, name: str, help_: str,
                  labelnames: Iterable[str],
                  buckets: Optional[Iterable[float]] = None) -> _Family:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        labelnames = tuple(labelnames)
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r} on {name}")
        bks = DEFAULT_BUCKETS if buckets is None else tuple(buckets)
        if kind == "histogram":
            if list(bks) != sorted(bks) or len(set(bks)) != len(bks):
                raise ValueError(f"histogram buckets must be strictly "
                                 f"increasing, got {bks}")
            if not math.isinf(bks[-1]):
                bks = bks + (math.inf,)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.labelnames}, cannot re-register "
                        f"as {kind}{labelnames}")
                return fam
            fam = _Family(self, kind, name, help_, labelnames, bks)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help_: str = "",
                labelnames: Iterable[str] = ()) -> _Family:
        return self._register("counter", name, help_, labelnames)

    def histogram(self, name: str, help_: str = "",
                  labelnames: Iterable[str] = (),
                  buckets: Optional[Iterable[float]] = None) -> _Family:
        return self._register("histogram", name, help_, labelnames, buckets)


#: Process-global registry for library-level metrics that have no server to
#: hang off: kernel dispatch decisions, ingest throughput, plan builds.
_GLOBAL = MetricsRegistry()


def global_registry() -> MetricsRegistry:
    return _GLOBAL
