"""Async deadline-aware request queue over the batched analytics engine.

The port of the JAX package's ``serving/queue.py``: host code, copied, with
the same flush policy, shedding, backpressure and ``FlushEvent`` log.  A
flush runs on whichever thread fires it (a submitting thread, the
background serve thread, a drainer); the engine makes its card current for
each execution (``AnalyticsServer._device_scope``), so a flush on the
serve thread launches on the pack's card.

The synchronous :class:`AnalyticsServer` batches whatever one caller hands
it in a single ``run``.  Under serving load, queries arrive one at a time
from many callers — batching opportunities exist *across* submissions, not
within them.  :class:`AsyncAnalyticsServer` exposes ``submit(query,
deadline=...) -> Future`` and holds queries in a pending queue, grouped by
:meth:`Query.group_key` (kind + normalized l) and by grammar-size bucket
(power-of-two rule count, so a flush packs corpora of similar size into
one pack with little padding).  A group is flushed — one call into the
shared engine core (:meth:`AnalyticsServer.run_group`) — when any of:

``max_batch``  the group reaches one flush's worth of distinct corpora —
               ``max_batch`` on one device, ``max_batch * target_shards``
               when a corpus mesh is available (a full pack, nothing to
               wait for; checked on every submit);
``deadline``   the earliest deadline in the group is within one estimated
               batch latency (the per-signature EWMA tracked by
               ``ServerStats.observe_latency``) of *now* — waiting longer
               would miss it;
``idle``       no new query joined the group for ``idle_timeout`` seconds —
               traffic has moved on, stop holding the stragglers;
``max_wait``   the OLDEST query in the group has waited ``max_wait``
               seconds — a sustained same-corpus stream resets idleness on
               every arrival and never fills a pack, so waiting is bounded
               by submission age too;
``drain``      an explicit :meth:`drain` / :meth:`close`.

Search queries (kinds ``search_bm25`` / ``search_tfidf``) and the query
operators (``filter_count`` / ``agg_terms`` / ``phrase_count``) ride the
same machinery: their normalized parameters (query terms, top-k, the
filter predicate, the aggregation op) are part of
:meth:`Query.group_key`, so two distinct queries can never share a
batched chunk, while identical queries against many corpora batch
exactly like the six analytics.

Backpressure: ``max_pending`` bounds the queue depth.  A submit that
would exceed it raises :class:`QueueFull` (and counts
``stats.rejected``), or — with ``block=True`` — waits until a flush frees
space (requires something else to drive flushes: the background thread,
or another thread calling :meth:`poll`/:meth:`drain`).  The depth
high-water mark is ``ServerStats.max_queue_depth``.

Deadline shedding: a query whose deadline has *already passed* when its
group flushes can no longer produce a useful answer — executing it would
burn an engine slot for a result nobody can use.  Such queries are shed
at flush time: their futures get a :class:`DeadlineExceeded` exception
instead of a result, ``stats.shed`` counts them, and each
:class:`FlushEvent` records its group's shed count (``n_shed``).
Shedding composes with ``max_pending`` backpressure into the overload
contract: under sustained overload the server sheds and rejects but never
crashes, and every non-shed result stays bit-identical to the sync path.

Because flushes call the same ``run_group`` / ``execute_chunk`` core as the
sync path, results are bit-identical to a one-shot ``AnalyticsServer.run``
of the same queries.

Ingest freshness: a query can sit in the pending queue while its
registered :class:`~repro_torch.data.store.CompressedCorpus` absorbs
appended files (``append_files`` bumps the store epoch).  Flushes stay fresh
because ``execute_chunk`` re-snapshots every mutated corpus at flush time
(``AnalyticsServer.refresh``, the re-registration path) before packing —
so a submit-append-drain sequence serves post-append data, never the
grammar that was current at submit time.

Sharded flushes: ``target_shards`` > 1 asks the engine to split large
flushes row-wise across the corpus mesh instead of running
``max_batch``-sized chunks one after another — one flush of up to
``max_batch * target_shards`` corpora executes as one sharded pack over
that many devices (``AnalyticsServer.chunk_capacity`` /
``GrammarBatch.shard``).  The knob is a target: with fewer devices (or
one), capacity degrades to the plain per-device flush, and results stay
bit-identical throughout.

Time is injectable (``clock=``): the flush-policy tests drive a simulated
clock through :meth:`poll`, deterministically.  For real deployments,
:meth:`start` runs a small daemon thread that polls at ``poll_interval``;
``submit`` is thread-safe and flushes triggered by a full group execute on
the submitting thread.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.obs import BoundedLog
from repro_torch.obs import tracing as _trace

from .analytics_server import (DEFAULT_LATENCY_ESTIMATE, AnalyticsServer,
                               Query)


class QueueFull(RuntimeError):
    """submit() would push the pending-query depth past ``max_pending``."""


class DeadlineExceeded(RuntimeError):
    """The query's deadline had already passed when its group flushed, so
    it was shed instead of executed (``stats.shed``); the future carries
    this exception instead of a result."""


@dataclass
class _Pending:
    query: Query
    deadline: Optional[float]       # absolute, in the server's clock domain
    future: Future
    submitted_at: float
    # root Span opened at submit time (registry enabled only).  Carried
    # here rather than read back off query.trace: the same Query object
    # may be submitted repeatedly, and each submission is its own tree.
    span: Optional[_trace.Span] = None


@dataclass
class _Group:
    kind: str
    l: Optional[int]                # normalized (None unless sequence_count)
    terms: Optional[Tuple[int, ...]] = None  # normalized (search/agg/phrase)
    k: Optional[int] = None                  # normalized (search kinds only)
    predicate: Optional[Tuple] = None        # normalized (filter_count only)
    agg: Optional[str] = None                # normalized (agg_terms only)
    items: List[_Pending] = field(default_factory=list)
    last_arrival: float = 0.0
    # distinct corpora in arrival order (dict-as-ordered-set: submit must
    # stay O(1), not rescan items, while holding the queue lock)
    corpora_seen: Dict[str, None] = field(default_factory=dict)

    def add(self, p: _Pending) -> None:
        self.items.append(p)
        self.last_arrival = p.submitted_at
        self.corpora_seen.setdefault(p.query.corpus)

    def corpora(self) -> List[str]:
        return list(self.corpora_seen)

    def earliest_deadline(self) -> Optional[float]:
        ds = [p.deadline for p in self.items if p.deadline is not None]
        return min(ds) if ds else None


@dataclass(frozen=True)
class FlushEvent:
    """One flush, as observed by tests/benchmarks (``flush_log``).

    ``reason`` is the transition that fired the flush — exactly one of
    ``max_batch`` / ``deadline`` / ``idle`` / ``max_wait`` / ``drain``.
    ``n_shed`` is orthogonal to the reason: however the flush fired, the
    group members whose deadline had already passed were shed
    (:class:`DeadlineExceeded`) instead of executed, and ``n_queries``
    counts only the queries actually answered by the engine call.
    """
    reason: str         # max_batch | deadline | idle | max_wait | drain
    kind: str
    l: Optional[int]
    n_queries: int
    n_corpora: int
    at: float                       # clock time the flush fired
    n_shed: int = 0                 # group members shed (expired deadline)
    terms: Optional[Tuple[int, ...]] = None  # search/agg_terms/phrase_count
    k: Optional[int] = None                  # search kinds only
    predicate: Optional[Tuple] = None        # filter_count only
    agg: Optional[str] = None                # agg_terms only
    # the flush's Span (chunk/pack_build/execute children below it),
    # present when the engine registry is enabled; compare=False so event
    # equality stays about the flush facts
    span: Optional[_trace.Span] = field(default=None, compare=False,
                                        repr=False)


class AsyncAnalyticsServer:
    """Deadline-aware submission queue wrapping an :class:`AnalyticsServer`.

    Parameters
    ----------
    server:        the engine; its ``max_batch``/``method``/pack cache and
                   its ``stats`` (flush counters, latency EWMA) are shared.
    idle_timeout:  seconds a group may sit without new arrivals before it is
                   flushed anyway (condition ``idle``).
    max_wait:      hard bound on how long any single query may sit queued
                   (condition ``max_wait``); defaults to ``10 *
                   idle_timeout``.
    default_latency: batch-latency estimate used for a kind that has never
                   executed (seeds the ``deadline`` condition before the
                   EWMA has observations).
    clock:         monotonic-time source; defaults to the engine's
                   injectable ``server.clock`` so the whole serving stack
                   shares one time domain, and is separately injectable
                   for simulated-clock tests.  Deadlines passed to
                   :meth:`submit` are absolute values in this clock's
                   domain.
    poll_interval: sleep granularity of the background thread
                   (:meth:`start`); also the staleness bound on the
                   ``deadline``/``idle`` conditions when threaded.
    max_pending:   queue-depth bound (backpressure).  ``None`` (default):
                   unbounded, the original behaviour.  With a bound, a
                   submit that would exceed it raises :class:`QueueFull`
                   unless ``block=True``, which instead waits for a flush
                   to free space.  ``ServerStats.max_queue_depth`` records
                   the observed high-water mark, ``stats.rejected`` the
                   refused submissions.
    target_shards: how many devices one flush should aim to span.  Raises
                   the ``max_batch`` fill condition to the engine's
                   ``chunk_capacity(target_shards)`` and forwards the
                   target to ``run_group``, so a large flush executes as
                   one sharded pack instead of sequential ``max_batch``
                   chunks.  Clamped by the devices in the engine's mesh; 1
                   (default) keeps the single-device flush policy exactly.
    """

    def __init__(self, server: AnalyticsServer, *,
                 idle_timeout: float = 0.005,
                 max_wait: Optional[float] = None,
                 default_latency: float = DEFAULT_LATENCY_ESTIMATE,
                 clock: Optional[Callable[[], float]] = None,
                 poll_interval: float = 0.001,
                 max_pending: Optional[int] = None,
                 target_shards: int = 1):
        if idle_timeout < 0:
            raise ValueError("idle_timeout must be >= 0")
        if poll_interval <= 0:
            raise ValueError("poll_interval must be > 0")
        if max_pending is not None and max_pending < 1:
            raise ValueError("max_pending must be >= 1 (or None)")
        if target_shards < 1:
            raise ValueError("target_shards must be >= 1")
        self._engine = server
        self.target_shards = target_shards
        self.max_pending = max_pending
        self.idle_timeout = float(idle_timeout)
        self.max_wait = (10.0 * self.idle_timeout if max_wait is None
                         else float(max_wait))
        if self.max_wait < self.idle_timeout:
            raise ValueError("max_wait must be >= idle_timeout")
        self.default_latency = float(default_latency)
        self.poll_interval = float(poll_interval)
        # one clock domain for the whole stack by default: the engine's
        # injectable clock (satellite of the same PR that added it there).
        # An explicit clock= stays queue-local so simulated-clock tests
        # keep driving the flush policy alone.
        self._now = clock if clock is not None else server.clock
        self._pending: Dict[Tuple, _Group] = {}
        self._depth = 0                      # total pending queries, O(1)
        self._lock = threading.RLock()
        # signalled whenever _pop lowers the depth (or the queue closes):
        # wakes submits blocked on the max_pending bound
        self._space = threading.Condition(self._lock)
        self._exec_lock = threading.Lock()   # one engine call at a time
        # bounded observability ring (long-lived servers must not leak);
        # evictions are counted and exposed as a gauge, never silent
        self.flush_log: BoundedLog = BoundedLog(
            4096, gauge=server.registry.gauge(
                "repro_queue_flush_log_dropped_events",
                "FlushEvents evicted from the bounded flush_log ring"))
        self._depth_gauge = server.registry.gauge(
            "repro_queue_depth", "pending queries in the async queue")
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._closed = False

    # ------------------------------------------------------------- state --
    @property
    def stats(self):
        return self._engine.stats

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return self._depth

    # ------------------------------------------------------------ submit --
    def submit(self, query: Query, deadline: Optional[float] = None,
               block: bool = False) -> Future:
        """Enqueue one query; returns a future resolving to exactly what
        ``AnalyticsServer.run([query])[0]`` would.  ``deadline`` is an
        absolute time in the server's clock domain (``None``: flushed by
        ``max_batch`` or ``idle`` only).  Invalid queries raise here, not on
        the future.

        With ``max_pending`` set, a submit into a full queue raises
        :class:`QueueFull` — or, when ``block=True``, waits until a flush
        frees space (something else must drive flushes: the background
        thread, or another thread polling/draining).  A close() while
        blocked raises ``RuntimeError`` like any post-close submit."""
        self._engine.validate(query)
        to_flush: Optional[_Group] = None
        fut: Future = Future()
        with self._lock:
            while True:
                if self._closed:
                    raise RuntimeError("queue is closed")
                if (self.max_pending is None
                        or self._depth < self.max_pending):
                    break
                if not block:
                    self.stats.rejected += 1
                    raise QueueFull(
                        f"queue depth {self._depth} at max_pending="
                        f"{self.max_pending}")
                self._space.wait()
            now = self._now()
            gk = query.group_key()
            key = (gk, self._engine.size_bucket(query.corpus))
            g = self._pending.get(key)
            if g is None:
                kind, l, terms, k, predicate, agg = gk
                g = self._pending[key] = _Group(kind=kind, l=l, terms=terms,
                                                k=k, predicate=predicate,
                                                agg=agg)
            root = None
            if self._engine.registry.enabled:
                root = _trace.Span("query", now,
                                   attrs={"corpus": query.corpus,
                                          "kind": query.kind,
                                          "path": "async"})
                object.__setattr__(query, "trace", root)
            g.add(_Pending(query, deadline, fut, now, span=root))
            self.stats.submitted += 1
            self._depth += 1
            self._depth_gauge.set(float(self._depth))
            self.stats.max_queue_depth = max(self.stats.max_queue_depth,
                                             self._depth)
            if len(g.corpora_seen) >= self._engine.chunk_capacity(
                    self.target_shards):
                to_flush = self._pop(key)
        if to_flush is not None:
            self._flush_group(to_flush, "max_batch", self._now())
        self._kick()
        return fut

    # -------------------------------------------------------------- poll --
    def poll(self, now: Optional[float] = None) -> Optional[float]:
        """Fire every due flush condition; returns the next time a condition
        could trigger (for the serve loop's sleep), or ``None`` if the queue
        is empty.  Simulated-clock tests call this directly with ``now``."""
        if now is None:
            now = self._now()
        due: List[Tuple[_Group, str]] = []
        with self._lock:
            for key in list(self._pending):
                g = self._pending[key]
                reason = self._due_reason(g, now)
                if reason is not None:
                    due.append((self._pop(key), reason))
        for g, reason in due:
            self._flush_group(g, reason, now)
        with self._lock:
            wakes = [self._next_trigger(g) for g in self._pending.values()]
        return min(wakes) if wakes else None

    def _due_reason(self, g: _Group, now: float) -> Optional[str]:
        ed = g.earliest_deadline()
        if ed is not None:
            est = self.stats.estimate_latency(g.kind,
                                              default=self.default_latency)
            if ed - now <= est:
                return "deadline"
        if now - g.last_arrival >= self.idle_timeout:
            return "idle"
        # steady same-group arrivals reset idleness forever — bound the
        # oldest query's wait regardless
        if now - g.items[0].submitted_at >= self.max_wait:
            return "max_wait"
        return None

    def _next_trigger(self, g: _Group) -> float:
        t = min(g.last_arrival + self.idle_timeout,
                g.items[0].submitted_at + self.max_wait)
        ed = g.earliest_deadline()
        if ed is not None:
            est = self.stats.estimate_latency(g.kind,
                                              default=self.default_latency)
            t = min(t, ed - est)
        return t

    # ------------------------------------------------------------- drain --
    def drain(self) -> None:
        """Flush everything pending, regardless of deadlines/timeouts."""
        with self._lock:
            groups = [self._pop(key) for key in list(self._pending)]
        now = self._now()
        for g in groups:
            self._flush_group(g, "drain", now)

    def _pop(self, key: Tuple) -> _Group:
        """Remove a group from the queue (lock held by caller); wakes any
        submit blocked on the ``max_pending`` bound."""
        g = self._pending.pop(key)
        self._depth -= len(g.items)
        self._depth_gauge.set(float(self._depth))
        self._space.notify_all()
        return g

    # ------------------------------------------------------------- flush --
    def _flush_group(self, g: _Group, reason: str, now: float) -> None:
        tracing = self._engine.registry.enabled
        # claim each future (running state): callers may have cancel()ed a
        # pending one — set_result on it would raise InvalidStateError,
        # starving the rest of the group and killing the serve loop
        claimed = [p for p in g.items
                   if p.future.set_running_or_notify_cancel()]
        if tracing:
            # every claimed query waited submit -> flush, shed or not
            wait_hist = self.stats.stage_seconds.labels("queue_wait")
            for p in claimed:
                wait_hist.observe(now - p.submitted_at)
                if p.span is not None:
                    p.span.children.append(_trace.Span(
                        "queue_wait", p.submitted_at).finish(now))
        # shed the expired: a deadline already in the past cannot be met by
        # any execution, so the engine slot goes to queries that can still
        # use it.  Fail the futures before the engine call — their callers
        # unblock immediately instead of waiting out a batch they are not in.
        shed = [p for p in claimed
                if p.deadline is not None and now > p.deadline]
        for p in shed:
            p.future.set_exception(DeadlineExceeded(
                f"deadline {p.deadline:.6f} passed before flush at "
                f"{now:.6f} (queued {now - p.submitted_at:.6f}s)"))
            if p.span is not None:
                p.span.attrs["outcome"] = "shed"
                self._engine.trace_log.append(p.span.finish(now))
        live = [p for p in claimed
                if p.deadline is None or now <= p.deadline]
        names: List[str] = []
        for p in live:
            if p.query.corpus not in names:
                names.append(p.query.corpus)
        # ONE flush span shared by every query the flush answers — the
        # chunk/pack_build/execute children hang off it via the ambient
        # context inside run_group
        fspan = _trace.Span("flush", now,
                            attrs={"reason": reason, "kind": g.kind,
                                   "n_queries": len(live),
                                   "n_corpora": len(names),
                                   "n_shed": len(shed)}) if tracing else None
        err: Optional[Exception] = None
        if live:
            try:
                # run_group -> execute_chunk refreshes every name against
                # its store's current epoch before packing, so queries that
                # queued before an append_files still serve fresh data
                with self._exec_lock:
                    if fspan is not None:
                        with _trace.activate(fspan, self._now):
                            by_corpus = self._engine.run_group(
                                g.kind, names, l=g.l, terms=g.terms,
                                k=g.k, predicate=g.predicate, agg=g.agg,
                                target_shards=self.target_shards)
                    else:
                        by_corpus = self._engine.run_group(
                            g.kind, names, l=g.l, terms=g.terms, k=g.k,
                            predicate=g.predicate, agg=g.agg,
                            target_shards=self.target_shards)
            except Exception as e:              # noqa: BLE001 — fanned out
                err = e
                for p in live:
                    p.future.set_exception(e)
            else:
                for p in live:
                    p.future.set_result(by_corpus[p.query.corpus])
        if fspan is not None:
            if err is not None:
                fspan.attrs["error"] = type(err).__name__
            fspan.finish(self._now())
            done = fspan.t1
            for p in live:
                if p.span is not None:
                    p.span.children.append(fspan)
                    p.span.attrs["outcome"] = ("error" if err is not None
                                               else "ok")
                    self._engine.trace_log.append(p.span.finish(done))
        with self._lock:                 # concurrent flushes race the stats
            self.stats.count_flush(reason)
            self.stats.shed += len(shed)
            self.flush_log.append(FlushEvent(
                reason=reason, kind=g.kind, l=g.l, n_queries=len(live),
                n_corpora=len(names), at=now, n_shed=len(shed),
                terms=g.terms, k=g.k, predicate=g.predicate, agg=g.agg,
                span=fspan))

    # ---------------------------------------------------------- threaded --
    def start(self) -> "AsyncAnalyticsServer":
        """Run the flush policy on a background daemon thread."""
        with self._lock:
            if self._closed:
                raise RuntimeError("queue is closed")
            if self._thread is not None:
                raise RuntimeError("serve thread already running")
            self._stop.clear()
            self._wake.clear()
            self._thread = threading.Thread(target=self._serve_loop,
                                            name="analytics-queue",
                                            daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        """Stop accepting queries, stop the serve thread (if any), and
        drain the rest — a submit racing close either drains here or
        raises, never hangs.  Idempotent; the queue stays closed."""
        t = None
        with self._lock:
            self._closed = True
            t, self._thread = self._thread, None
            self._space.notify_all()     # blocked submits must fail, not hang
        if t is not None:
            self._stop.set()
            self._wake.set()
            t.join()
        self.drain()

    def _serve_loop(self) -> None:
        while not self._stop.is_set():
            nxt = self.poll()
            now = self._now()
            delay = self.poll_interval
            if nxt is not None:
                delay = min(delay, max(nxt - now, 0.0))
            self._wake.wait(delay)
            self._wake.clear()

    def _kick(self) -> None:
        if self._thread is not None:
            self._wake.set()

    def __enter__(self) -> "AsyncAnalyticsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
