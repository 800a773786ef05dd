"""Thread-safe metrics registry: counters, gauges, fixed-bucket histograms.

A copy of the JAX package's ``obs/registry.py`` with the same metric
names and exposition, so a dashboard built on either package reads the
other.  One :class:`MetricsRegistry` holds named metric *families*; a
family with label names fans out into per-label-value children, a
label-less family IS its single child
(``registry.counter("x", "...").inc()`` just works).  All mutation goes
through one re-entrant lock, so ``inc``/``observe`` from many threads never
lose updates.

Two exposition formats, both computed under the lock from live state:

* :meth:`MetricsRegistry.snapshot` — a JSON-safe dict (histograms carry
  count / sum / p50 / p95 / p99 and the cumulative bucket table);
* :meth:`MetricsRegistry.render_prometheus` — Prometheus text format
  (``# HELP`` / ``# TYPE``, ``_bucket{le="..."}`` / ``_sum`` / ``_count``
  for histograms, label values escaped per the spec).

The ``enabled`` flag is deliberately asymmetric: **counters and gauges
always record** — serving *policy* reads them (rejected/shed accounting,
flush-reason counts, queue depth), so disabling them would change
behaviour, not just visibility — while **histograms (and the span tracing
built on top in obs/tracing.py) become no-ops** when ``enabled=False``.
That disabled mode is the baseline against which the instrumentation's
cost is measured.

The clock is injectable (mirroring ``serving/queue.py``) so latency-
producing callers and the registry agree on a time domain in
simulated-clock tests; the registry itself stores no timestamps.
"""

from __future__ import annotations

import math
import re
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

__all__ = ["MetricsRegistry", "DEFAULT_BUCKETS", "global_registry"]

#: Default latency buckets (seconds): log-spaced from 100 us to 60 s, the
#: range between "one cached dispatch" and "a cold jit compile", + +Inf.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, math.inf)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _escape_label(v: str) -> str:
    """Prometheus label-value escaping: backslash, double-quote, newline."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return format(v, ".10g")


class _Counter:
    """Monotonic counter child.  ``set`` exists for the thin attribute
    views in serving (``stats.x += 1`` reads then writes) — it must never
    move the value backwards."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increments must be >= 0, got {n}")
        with self._lock:
            self._value += n

    def set(self, v: float) -> None:
        with self._lock:
            if v < self._value:
                raise ValueError(
                    f"counter cannot move backwards ({self._value} -> {v})")
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _reset(self) -> None:
        self._value = 0.0

    def _sample(self) -> dict:
        return {"value": self._value}


class _Gauge:
    """Free-moving instantaneous value (queue depth, drop counts)."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _reset(self) -> None:
        self._value = 0.0

    def _sample(self) -> dict:
        return {"value": self._value}


class _Histogram:
    """Fixed-bucket histogram with interpolated percentile summaries.

    ``observe`` is gated on the owning registry's ``enabled`` flag (the
    module docstring's asymmetry); percentiles interpolate linearly within
    the bucket containing the target rank, so they are bucket-resolution
    estimates — exactly what a Prometheus ``histogram_quantile`` would
    compute from the same buckets."""

    __slots__ = ("_lock", "_registry", "_uppers", "_counts", "_sum",
                 "_count")

    def __init__(self, lock: threading.RLock, registry: "MetricsRegistry",
                 buckets: Tuple[float, ...]):
        self._lock = lock
        self._registry = registry
        self._uppers = buckets
        self._counts = [0] * len(buckets)
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        if not self._registry.enabled:
            return
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

    def percentile(self, q: float) -> float:
        """Interpolated q-th percentile (nan when empty)."""
        with self._lock:
            counts = list(self._counts)
            total = self._count
        if total == 0:
            return float("nan")
        rank = (q / 100.0) * total
        cum = 0
        lo = 0.0
        for ub, c in zip(self._uppers, counts):
            prev = cum
            cum += c
            if cum >= rank and c > 0:
                if math.isinf(ub):
                    return lo          # open-ended last bucket: lower bound
                frac = (rank - prev) / c
                return lo + (ub - lo) * frac
            if not math.isinf(ub):
                lo = ub
        return lo

    def _reset(self) -> None:
        self._counts = [0] * len(self._uppers)
        self._sum = 0.0
        self._count = 0

    def _sample(self) -> dict:
        cum, table = 0, []
        for ub, c in zip(self._uppers, self._counts):
            cum += c
            table.append([ub if not math.isinf(ub) else "+Inf", cum])
        out = {"count": self._count, "sum": self._sum, "buckets": table}
        for q in (50, 95, 99):
            out[f"p{q}"] = self.percentile(q)
        return out


_KINDS = {"counter": _Counter, "gauge": _Gauge, "histogram": _Histogram}


class _Family:
    """One named metric family; children keyed by label-value tuples.

    A label-less family proxies the metric API straight to its single
    ``()`` child, so callers never special-case "no labels"."""

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

    def _make_child(self):
        if self.kind == "histogram":
            return _Histogram(self.registry._lock, self.registry,
                              self.buckets)
        return _KINDS[self.kind](self.registry._lock)

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
                child = self._children[key] = self._make_child()
            return child

    def remove(self, *values: str) -> None:
        with self.registry._lock:
            self._children.pop(tuple(str(v) for v in values), None)

    def children(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self.registry._lock:
            return sorted(self._children.items())

    # ---- label-less proxy: the family IS its single child ----
    def _bare(self):
        if self.labelnames:
            raise ValueError(f"{self.name} has labels {self.labelnames}; "
                             f"use .labels(...)")
        return self._children[()]

    def inc(self, n: float = 1.0) -> None:
        self._bare().inc(n)

    def dec(self, n: float = 1.0) -> None:
        self._bare().dec(n)

    def set(self, v: float) -> None:
        self._bare().set(v)

    def observe(self, v: float) -> None:
        self._bare().observe(v)

    @property
    def value(self) -> float:
        return self._bare().value

    @property
    def count(self) -> int:
        return self._bare().count

    @property
    def sum(self) -> float:
        return self._bare().sum

    def percentile(self, q: float) -> float:
        return self._bare().percentile(q)


class MetricsRegistry:
    """Named metric families behind one lock; see the module docstring."""

    def __init__(self, enabled: bool = True,
                 clock: Callable[[], float] = time.monotonic):
        self.enabled = enabled
        self.clock = clock
        self._lock = threading.RLock()
        self._families: Dict[str, _Family] = {}

    # ------------------------------------------------------- registration --
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
                # idempotent re-registration: the same family handed back,
                # a *conflicting* one refused loudly
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

    def gauge(self, name: str, help_: str = "",
              labelnames: Iterable[str] = ()) -> _Family:
        return self._register("gauge", name, help_, labelnames)

    def histogram(self, name: str, help_: str = "",
                  labelnames: Iterable[str] = (),
                  buckets: Optional[Iterable[float]] = None) -> _Family:
        return self._register("histogram", name, help_, labelnames, buckets)

    def reset(self) -> None:
        """Zero every child in place (views/handles stay valid)."""
        with self._lock:
            for fam in self._families.values():
                for _, child in fam._children.items():
                    child._reset()

    # --------------------------------------------------------- exposition --
    def snapshot(self) -> dict:
        """JSON-safe dump of every family's current state."""
        out: Dict[str, dict] = {}
        with self._lock:
            for name, fam in sorted(self._families.items()):
                out[name] = {
                    "type": fam.kind,
                    "help": fam.help,
                    "labelnames": list(fam.labelnames),
                    "samples": [
                        {"labels": dict(zip(fam.labelnames, key)),
                         **child._sample()}
                        for key, child in fam.children()],
                }
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: List[str] = []
        with self._lock:
            for name, fam in sorted(self._families.items()):
                lines.append(f"# HELP {name} {fam.help}")
                lines.append(f"# TYPE {name} {fam.kind}")
                for key, child in fam.children():
                    base = ",".join(
                        f'{ln}="{_escape_label(v)}"'
                        for ln, v in zip(fam.labelnames, key))
                    if fam.kind != "histogram":
                        suffix = f"{{{base}}}" if base else ""
                        lines.append(
                            f"{name}{suffix} {_fmt(child.value)}")
                        continue
                    cum = 0
                    for ub, c in zip(child._uppers, child._counts):
                        cum += c
                        le = f'le="{_fmt(ub)}"'
                        lbl = f"{base},{le}" if base else le
                        lines.append(f"{name}_bucket{{{lbl}}} {cum}")
                    suffix = f"{{{base}}}" if base else ""
                    lines.append(f"{name}_sum{suffix} {_fmt(child._sum)}")
                    lines.append(f"{name}_count{suffix} {child._count}")
        return "\n".join(lines) + "\n"


#: Process-global registry for library-level metrics that have no server to
#: hang off: kernel dispatch decisions (kernels/ops.py), store memo traffic
#: (data/store.py), ingest throughput (core/sequitur.py), plan builds
#: (obs/tracing.py plan_stage).  Per-server metrics live on the server's
#: own registry so test processes stay isolated.
_GLOBAL = MetricsRegistry()


def global_registry() -> MetricsRegistry:
    return _GLOBAL
