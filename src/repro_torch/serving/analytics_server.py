"""Query dispatch for the batched analytics engine, on the card.

The port of the JAX package's ``serving/analytics_server.py``: the same
``Query`` type, grouping, chunking, pack cache, counters, spans and
metric names, with every pack and store read on the server's ``device``
(the card unless the caller passes ``device="cpu"``).

Serving shape of the workload: many registered compressed corpora, a stream
of (corpus, analytics-kind) queries.  Running each query alone wastes the
device (one dispatch + one plan build per corpus shape).  The server:

1. groups incoming queries by analytics kind (and params, e.g. the l of
   sequence_count);
2. within a group, dedups corpora and orders them by grammar size so that
   each chunk of ``max_batch`` packs corpora of similar size (minimal
   padding waste — the bucketed :class:`GrammarBatch` dims round up to
   powers of two, so similar sizes collapse onto one compiled program);
3. executes ONE batched call per chunk (``core.batch.run_batched``, the
   search and query engines), on the pack's device;
4. answers duplicate queries for the same corpus from the chunk result;
   single-corpus chunks take the per-corpus path reusing the traversal
   weights memoized on :class:`repro_torch.data.CompressedCorpus`, or a
   cached size-1 pack (ELL and sequence plans reused) for bare
   :class:`GrammarArrays` registrations.

``GrammarBatch`` packs are cached by corpus-id tuple, so a steady query mix
pays the host-side packing once.

The engine core is split so the synchronous :meth:`AnalyticsServer.run` and
the async queue (:mod:`repro_torch.serving.queue`) execute the exact same
code:

* :meth:`AnalyticsServer.plan_groups` — validate + group a query list;
* :meth:`AnalyticsServer.run_group`   — canonical size-sorted chunking of
  one (kind, l) group;
* :meth:`AnalyticsServer.execute_chunk` — ONE batched (or memoized
  single-corpus) execution, with the observed latency folded into the
  per-signature EWMA on :class:`ServerStats` (the async flush policy reads
  those estimates to decide when a group's earliest deadline is "one batch
  away").

Devices: every execution runs under ``torch.cuda.device(server.device)``,
so a flush on the async queue's background thread (PyTorch's current
device is per thread) launches on the pack's card and on that thread's
current stream.
Answers reach the host through ``core.host_copy.to_host`` (page-locked
copies, one synchronise a call); the bytes it copies are the one metric
family the JAX package's server lacks, ``repro_server_host_copy_bytes_total``.

Corpus-sharded execution: with more than one visible card the server holds
a corpus mesh (``mesh="auto"`` ->
:func:`repro_torch.distributed.shard_batch.corpus_mesh`, or a caller's
:class:`~repro_torch.distributed.CorpusMesh`, whose devices may repeat) and
:meth:`execute_chunk` selects a sharded pack by group size — chunks of at
least ``shard_min_corpora`` corpora (default: the mesh size) split
row-wise across the mesh, each shard on its own card and host thread
(:meth:`GrammarBatch.shard`).  :meth:`chunk_capacity` allows up to
``max_batch * shards`` corpora a sharded chunk, which the async queue uses
through its ``target_shards`` knob.  On one card everything runs the
single-card pack; results are bit-identical either way.
The stage name ``compile`` (a (kind, signature)'s first execution, which
the latency EWMA skips) is kept for the JAX package's dashboards: on the
card that call pays plan builds, not a compile.
"""

from __future__ import annotations

import time
from collections.abc import MutableMapping
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.obs import BoundedLog, MetricsRegistry
from repro_torch.obs import tracing as _trace

from repro_torch.core import GrammarArrays, analytics as _analytics
from repro_torch.core.host_copy import count_host_copies, to_host
from repro_torch.core.batch import (ANALYTICS_KINDS, PER_FILE_KINDS,
                                    GrammarBatch, is_segment_sum_fallback,
                                    resolve_batch_method, run_batched,
                                    _round_up_pow2)
from repro_torch.core.traversal import resolve_single_method
from repro_torch.data.store import CompressedCorpus
from repro_torch.distributed.shard_batch import (corpus_mesh, mesh_size,
                                                 shard_batch)
from repro_torch.kernels._common import resolve_device
from repro_torch.query.engine import (QUERY_KINDS, query_corpus,
                                      run_batched_query)
from repro_torch.query.ops import (normalize_agg, normalize_phrase,
                                   normalize_predicate)
from repro_torch.search.engine import batched_search, search_corpus
from repro_torch.search.index import base_method
from repro_torch.search.scoring import (DEFAULT_TOP_K, KIND_SCHEME,
                                        SEARCH_KINDS, normalize_terms)

#: Everything the server accepts: the six analytics + ranked retrieval +
#: the composable query operators (filter / aggregate / phrase).
SERVED_KINDS = ANALYTICS_KINDS + SEARCH_KINDS + QUERY_KINDS

#: Query-tier kinds whose ``terms`` field is live (the agg term set, the
#: phrase token sequence).
_TERM_QUERY_KINDS = ("agg_terms", "phrase_count")


@dataclass(frozen=True)
class Query:
    """One analytics / search / query-operator request against a
    registered corpus."""
    corpus: str
    kind: str                  # one of SERVED_KINDS
    l: int = 3                 # sequence_count only
    terms: Optional[Tuple[int, ...]] = None   # search/agg_terms/phrase_count
    k: Optional[int] = None                   # search kinds only (top-k)
    predicate: Optional[Tuple] = None         # filter_count only
    agg: Optional[str] = None                 # agg_terms only (sum/max)
    # root Span of this query's lifecycle, set by the serving layer when
    # its registry is enabled (obs/tracing.py).  compare=False keeps it
    # out of eq/hash, so group keys and dataclass equality are untouched.
    trace: Optional[object] = field(default=None, compare=False,
                                    repr=False)

    def __post_init__(self):
        # keep the frozen dataclass hashable / group-keyable when callers
        # pass a list of term ids or a list-shaped predicate tree
        if self.terms is not None and not isinstance(self.terms, tuple):
            object.__setattr__(self, "terms",
                               tuple(int(t) for t in self.terms))
        if self.predicate is not None:
            object.__setattr__(self, "predicate",
                               normalize_predicate(self.predicate))

    def effective_l(self) -> Optional[int]:
        """``l`` is a sequence_count parameter ONLY: for every other kind it
        is normalized to ``None`` so it can neither split a group (two
        word_count queries with different ``l`` share one batched call) nor
        mis-share one (a sequence_count group always carries its real
        ``l``).  phrase_count's window length is the phrase itself, so even
        there ``l`` stays None."""
        return self.l if self.kind == "sequence_count" else None

    def effective_terms(self) -> Optional[Tuple[int, ...]]:
        """Query terms are live for the search kinds, ``agg_terms`` (the
        aggregation term set) and ``phrase_count`` (the phrase tokens) —
        normalized to ``None`` everywhere else (same contract as
        :meth:`effective_l`: a stray ``terms`` on word_count can neither
        split nor mis-share a group).  Term-carrying kinds always keep
        their real terms, so two distinct queries never share a chunk."""
        if self.kind in SEARCH_KINDS or self.kind in _TERM_QUERY_KINDS:
            return self.terms
        return None

    def effective_k(self) -> Optional[int]:
        """Top-k is a search parameter ONLY; search queries that omit it
        get :data:`repro_torch.search.DEFAULT_TOP_K` so explicit-default and
        omitted-k queries share one group."""
        if self.kind not in SEARCH_KINDS:
            return None
        return DEFAULT_TOP_K if self.k is None else int(self.k)

    def effective_predicate(self) -> Optional[Tuple]:
        """The filter predicate is a ``filter_count`` parameter ONLY
        (canonicalized in ``__post_init__``); ``None`` off that kind so a
        stray predicate can never split an unrelated group, and two
        distinct predicates never share a chunk."""
        return self.predicate if self.kind == "filter_count" else None

    def effective_agg(self) -> Optional[str]:
        """The aggregation op is an ``agg_terms`` parameter ONLY; queries
        that omit it get the canonical default (``sum``) so explicit-
        default and omitted-op queries share one group."""
        if self.kind != "agg_terms":
            return None
        return normalize_agg(self.agg)

    def group_key(self) -> Tuple:
        return (self.kind, self.effective_l(), self.effective_terms(),
                self.effective_k(), self.effective_predicate(),
                self.effective_agg())


#: Flush/latency signature of the single-corpus execution path (no pack).
SINGLE_SIGNATURE: Tuple = ("single",)

#: Seconds assumed for a (kind, signature) pair never executed before; the
#: async queue uses this until real observations feed the EWMA.
DEFAULT_LATENCY_ESTIMATE = 0.02


def _encode_label(key) -> str:
    """Stable label rendering for dict-view keys: pack-signature tuples
    become ``8x16x...``, plain strings pass through."""
    if isinstance(key, tuple):
        return "x".join(str(v) for v in key)
    return str(key)


class _MetricDict(MutableMapping):
    """Dict-shaped view over one labeled counter family.

    Keys keep their original Python type (a flush reason string, the pack
    signature tuple) and values read back as ints, so the pre-registry
    call sites — ``stats.flushes.get("drain", 0)``,
    ``stats.signatures[sig] = ... + 1``, ``stats.method_fallbacks ==
    {...}`` — behave exactly as they did on a plain dict while every
    update lands in the registry."""

    def __init__(self, family, encode: Callable[[object], str] = str):
        self._family = family
        self._encode = encode
        self._children: Dict = {}

    def __getitem__(self, key):
        child = self._children.get(key)
        if child is None:
            raise KeyError(key)
        return int(child.value)

    def __setitem__(self, key, value) -> None:
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = \
                self._family.labels(self._encode(key))
        child.set(float(value))

    def __delitem__(self, key) -> None:
        del self._children[key]
        self._family.remove(self._encode(key))

    def __iter__(self):
        return iter(self._children)

    def __len__(self) -> int:
        return len(self._children)

    def __eq__(self, other) -> bool:
        if isinstance(other, _MetricDict):
            other = dict(other)
        return dict(self) == other

    __hash__ = None

    def __repr__(self) -> str:
        return repr(dict(self))


class ServerStats:
    """Serving counters, all backed by a
    :class:`~repro_torch.obs.MetricsRegistry`
    (the attribute API is a thin view: ``stats.queries += 1`` reads and
    writes the registered counter, the dict-shaped fields are
    :class:`_MetricDict` views over labeled families — so the same numbers
    show up in ``registry.snapshot()`` / ``render_prometheus()`` without
    any call-site churn).

    Scalar counters:

    * ``queries`` / ``groups`` — requests accepted, (kind, params) groups;
    * ``batched_calls`` / ``sharded_calls`` / ``single_calls`` — batched
      executions, of which sharded across a corpus mesh, and per-corpus
      ones;
    * ``batch_cache_hits`` — GrammarBatch packs reused;
    * ``epoch_invalidations`` — packs dropped / corpora re-snapshotted
      because a registered store's epoch moved (append_files): each count
      is one "stale grammar could NOT be served" event;
    * ``submitted`` / ``rejected`` / ``shed`` — async queue accounting
      (entered through submit, refused by max_pending, expired at flush);
    * ``max_queue_depth`` — pending-query high-water mark (a gauge).

    Dict views (labeled counter families):

    * ``signatures`` — pad signature -> batched-call count (bounded by the
      number of distinct bucket shapes, not traffic volume);
    * ``method_fallbacks`` — "requested->resolved" counts of explicit
      ELL-family requests that degraded to their segment_sum base
      (core.batch.is_segment_sum_fallback);
    * ``flushes`` — flush reason -> count (written by serving/queue.py);
    * ``host_copy_bytes`` — bytes the engine copied off the device for the
      answers it handed back (``core.host_copy.to_host``), by host buffer:
      ``"pinned"`` (page-locked, the card's path) or ``"pageable"`` (page-
      locked memory could not be had); both stay 0 on a CPU server.

    The latency estimator state (``latency_ewma`` / ``latency_obs``) stays
    plain host dicts: it is flush-*policy* control state keyed by tuples,
    not a metric — the per-stage histograms carry the observable side.
    """

    _SCALARS = {
        "queries": ("repro_server_queries_total",
                    "queries accepted by run()/submit()"),
        "groups": ("repro_server_groups_total",
                   "(kind, params) query groups executed"),
        "batched_calls": ("repro_server_batched_calls_total",
                          "batched executions"),
        "sharded_calls": ("repro_server_sharded_calls_total",
                          "batched executions that spanned a device mesh"),
        "single_calls": ("repro_server_single_calls_total",
                         "per-corpus executions (memoized weights)"),
        "batch_cache_hits": ("repro_server_batch_cache_hits_total",
                             "GrammarBatch packs reused from the cache"),
        "epoch_invalidations": ("repro_server_epoch_invalidations_total",
                                "stale packs/corpora dropped on an epoch "
                                "bump (ingest appends)"),
        "submitted": ("repro_queue_submitted_total",
                      "queries entered through the async queue"),
        "rejected": ("repro_queue_rejected_total",
                     "submits refused by the max_pending bound"),
        "shed": ("repro_queue_shed_total",
                 "queries shed at flush time (deadline already passed)"),
    }

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        r = self.registry
        self._scalars = {attr: r.counter(name, help_)
                         for attr, (name, help_) in self._SCALARS.items()}
        self._depth_high = r.gauge(
            "repro_queue_depth_high_water",
            "pending-query depth high-water mark")
        self.flushes = _MetricDict(r.counter(
            "repro_queue_flushes_total",
            "async queue flushes by firing condition", ("reason",)))
        self.signatures = _MetricDict(r.counter(
            "repro_server_pack_signatures_total",
            "batched calls by pack pad signature", ("signature",)),
            _encode_label)
        self.method_fallbacks = _MetricDict(r.counter(
            "repro_server_method_fallbacks_total",
            "explicit ELL-family requests degraded to a segment_sum base",
            ("transition",)))
        copies = r.counter(
            "repro_server_host_copy_bytes_total",
            "bytes of answers copied off the device, by host buffer",
            ("path",))
        self._host_copy = {p: copies.labels(p)
                           for p in ("pinned", "pageable")}
        # submit-to-result decomposition: pack_build / compile / execute /
        # queue_wait (docs/observability.md has the stage model)
        self.stage_seconds = r.histogram(
            "repro_server_stage_seconds",
            "per-stage latency of query execution", ("stage",))
        # ----- latency estimator (plain host state, see class docstring):
        # EWMA of observed chunk latencies keyed by (kind, signature) —
        # GrammarBatch pad signature for batched chunks, SINGLE_SIGNATURE
        # for the per-corpus path.  Bounded by the number of distinct
        # (kind, bucket-shape) pairs, not by traffic volume.
        self.latency_ewma: Dict[Tuple, float] = {}
        self.latency_obs: Dict[Tuple, int] = {}
        self.ewma_alpha: float = 0.25

    @property
    def host_copy_bytes(self) -> Dict[str, int]:
        return {p: int(c.value) for p, c in self._host_copy.items()}

    def count_host_copy(self, path: str, nbytes: int) -> None:
        self._host_copy[path].inc(nbytes)

    @property
    def max_queue_depth(self) -> int:
        return int(self._depth_high.value)

    @max_queue_depth.setter
    def max_queue_depth(self, v: int) -> None:
        self._depth_high.set(float(v))

    def __repr__(self) -> str:
        scalars = ", ".join(f"{a}={getattr(self, a)}"
                            for a in self._SCALARS)
        return (f"ServerStats({scalars}, "
                f"max_queue_depth={self.max_queue_depth}, "
                f"flushes={dict(self.flushes)}, "
                f"signatures={dict(self.signatures)}, "
                f"method_fallbacks={dict(self.method_fallbacks)}, "
                f"host_copy_bytes={self.host_copy_bytes})")

    def observe_latency(self, kind: str, signature: Tuple,
                        seconds: float) -> None:
        key = (kind, signature)
        n = self.latency_obs.get(key, 0)
        self.latency_obs[key] = n + 1
        if n == 0:
            # a key's first execution pays plan builds (possibly seconds)
            # that recurring traffic never sees again; adopting it would
            # inflate the deadline-flush estimate and collapse
            # deadline-carrying groups into near-singleton flushes
            return
        prev = self.latency_ewma.get(key)
        self.latency_ewma[key] = (
            seconds if prev is None
            else self.ewma_alpha * seconds + (1.0 - self.ewma_alpha) * prev)

    def estimate_latency(self, kind: Optional[str] = None,
                         default: float = DEFAULT_LATENCY_ESTIMATE) -> float:
        """Expected seconds for one batched call of ``kind``.

        Takes the MAX over that kind's per-signature EWMAs (falling back to
        all kinds, then ``default``): a pending group's pack signature is
        unknown until it is chunked, and averaging in the cheap
        single-corpus path would make the deadline flush fire too late for
        batched groups — overestimating only flushes a little early."""
        vals = [v for (k, _sig), v in self.latency_ewma.items()
                if kind is None or k == kind]
        if not vals:
            vals = list(self.latency_ewma.values())
        if not vals:
            return default
        return max(vals)

    def count_flush(self, reason: str) -> None:
        self.flushes[reason] = self.flushes.get(reason, 0) + 1

    def count_fallback(self, requested: str, resolved: str) -> None:
        key = f"{requested}->{resolved}"
        self.method_fallbacks[key] = self.method_fallbacks.get(key, 0) + 1


def _scalar_property(attr: str) -> property:
    """int-reading, registry-writing property so ``stats.x += 1`` keeps
    working on counter-backed attributes."""
    def _get(self) -> int:
        return int(self._scalars[attr].value)

    def _set(self, v) -> None:
        self._scalars[attr].set(float(v))

    return property(_get, _set)


for _attr in ServerStats._SCALARS:
    setattr(ServerStats, _attr, _scalar_property(_attr))
del _attr


class AnalyticsServer:
    """Groups (corpus, query) requests and runs them as batched calls on
    ``device`` (the card unless the caller passes ``"cpu"``; without a
    card the default raises)."""

    # methods every execution path (single and batched) supports; the
    # *_ell variants run the batched traversal on the dense ELL edge plan
    # (core/batch.py DESIGN note), "frontier_fused" runs the whole frontier
    # loop in one kernel launch (kernels/propagate_fused.py; per-file and
    # search traversals take its per-round ELL base), and "auto" lets the
    # occupancy dispatch in kernels.ops pick the engine per pack.  The same
    # tuple as core.batch.METHODS.
    METHODS = ("frontier", "leveled", "frontier_ell", "leveled_ell",
               "frontier_fused", "auto")
    # per-corpus traversal used when a chunk degenerates to one corpus
    # ("auto" resolves per pack; singles take the plain frontier)
    _SINGLE_METHOD = {"auto": "frontier"}
    # packs kept in the FIFO cache, and root spans kept in the trace ring
    MAX_CACHED_BATCHES = 32
    TRACE_LOG_SIZE = 1024

    def __init__(self, max_batch: int = 16, method: str = "frontier",
                 mesh: object = "auto",
                 shard_min_corpora: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 registry: Optional[MetricsRegistry] = None, device=None):
        # every pack this server builds and every store it reads lives here
        self.device = resolve_device(device)
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = max_batch
        if method not in self.METHODS:
            raise ValueError(f"method must be one of {self.METHODS}, "
                             f"got {method!r}")
        self.method = method
        # "auto" -> the corpus mesh over the visible cards (None on one
        # card; a CPU server never spans cards); None -> never shard; or a
        # caller's mesh
        if isinstance(mesh, str):
            if mesh != "auto":
                raise ValueError(f"mesh must be 'auto', None or a corpus "
                                 f"mesh, got {mesh!r}")
            mesh = corpus_mesh(None if self.device.type == "cuda"
                               else [self.device])
        self.mesh = mesh
        if shard_min_corpora is not None and shard_min_corpora < 1:
            raise ValueError("shard_min_corpora must be >= 1")
        # default: shard once a chunk has at least one corpus per device
        self.shard_min_corpora = (mesh_size(self.mesh)
                                  if shard_min_corpora is None
                                  else shard_min_corpora)
        self._corpora: Dict[str, GrammarArrays] = {}
        self._stores: Dict[str, CompressedCorpus] = {}
        # epoch each corpus's arrays snapshot was taken at (0 for bare
        # GrammarArrays registrations, which are immutable)
        self._epochs: Dict[str, int] = {}
        self._batches: Dict[Tuple, GrammarBatch] = {}
        # one injectable clock for the whole serving stack: chunk timing
        # here, flush policy in the async queue (which defaults to this
        # clock), span timestamps — so latency tests never sleep
        self.clock = clock
        self.registry = registry if registry is not None \
            else MetricsRegistry(clock=clock)
        self.stats = ServerStats(self.registry)
        # bounded ring of completed root spans (query/chunk trees); the
        # drop gauge makes eviction visible, like the queue's flush_log
        self.trace_log = BoundedLog(
            self.TRACE_LOG_SIZE, gauge=self.registry.gauge(
                "repro_server_trace_log_dropped_spans",
                "root spans evicted from the bounded trace ring"))

    # ---------------------------------------------------------- registry --
    def register(self, name: str,
                 corpus: Union[GrammarArrays, CompressedCorpus]) -> None:
        """Register a compressed corpus under ``name``.  A
        :class:`CompressedCorpus` additionally contributes its memoized
        traversal weights to single-corpus execution."""
        if not isinstance(corpus, (CompressedCorpus, GrammarArrays)):
            raise TypeError(f"cannot register {type(corpus).__name__}")
        # drop any previous registration: a stale store would hand its
        # memoized weights to a different grammar
        self._stores.pop(name, None)
        if isinstance(corpus, CompressedCorpus):
            self._stores[name] = corpus
            self._corpora[name] = corpus.ga
            self._epochs[name] = int(corpus.epoch)
        else:
            self._corpora[name] = corpus
            self._epochs[name] = 0
        # packs that contained an older corpus under this name are stale
        # (cache keys are (names_tuple, shards))
        self._batches = {k: v for k, v in self._batches.items()
                         if name not in k[0]}

    def corpora(self) -> Tuple[str, ...]:
        return tuple(self._corpora)

    def refresh(self, name: str) -> bool:
        """Re-snapshot ``name``'s arrays if its registered store mutated
        (``CompressedCorpus.append_files`` bumped the epoch) since the last
        snapshot; purges every cached pack containing the corpus.  Returns
        True when a refresh happened.  Called on every validate and at the
        top of every :meth:`execute_chunk` — an epoch-cheap int compare —
        so neither the sync path nor an async flush whose corpus was
        appended to *between submit and flush* can serve pre-append data
        (the re-registration path: tests/test_ingest.py).
        """
        store = self._stores.get(name)
        if store is None or store.epoch == self._epochs.get(name):
            return False
        self._corpora[name] = store.ga
        self._epochs[name] = int(store.epoch)
        self._batches = {key: gb for key, gb in self._batches.items()
                         if name not in key[0]}
        self.stats.epoch_invalidations += 1
        return True

    def validate(self, q: Query) -> None:
        if q.kind not in SERVED_KINDS:
            raise ValueError(f"unknown analytics kind {q.kind!r}; "
                             f"expected one of {SERVED_KINDS}")
        if q.kind in SEARCH_KINDS:
            normalize_terms(q.terms)         # raises on None/empty/negative
            if q.k is not None and q.k < 1:
                raise ValueError(f"search top-k must be >= 1, got {q.k}")
        if q.kind == "filter_count" and q.predicate is None:
            raise ValueError("filter_count queries need a predicate")
        if q.kind == "agg_terms":
            normalize_terms(q.terms)         # raises on None/empty/negative
            normalize_agg(q.agg)             # raises on unknown ops
        if q.kind == "phrase_count":
            normalize_phrase(q.terms)        # raises unless >= 2 valid ids
        if q.corpus not in self._corpora:
            raise KeyError(f"corpus {q.corpus!r} not registered")
        self.refresh(q.corpus)

    def size_bucket(self, name: str) -> int:
        """Grammar-size bucket of a registered corpus (power-of-two rule
        count, matching the :class:`GrammarBatch` pad bucketing) — the async
        queue groups pending queries by it so a flush packs corpora of
        similar size onto one compiled program."""
        return _round_up_pow2(self._corpora[name].num_rules)

    # ----------------------------------------------------------- serving --
    def plan_groups(self, queries: Sequence[Query]
                    ) -> List[Tuple[Tuple, List[int]]]:
        """Validate ``queries`` and group them by :meth:`Query.group_key`.

        Returns ``[(group_key, idxs)]`` in first-seen order; the key is the
        normalized ``(kind, l, terms, k, predicate, agg)`` tuple — ``l`` is
        None for every kind but sequence_count, ``terms`` is None off the
        search / agg_terms / phrase_count kinds, ``k`` off the search
        kinds, ``predicate`` off filter_count and ``agg`` off agg_terms
        (see the ``effective_*`` normalizers on :class:`Query`).
        """
        for q in queries:
            self.validate(q)
        groups: Dict[Tuple, List[int]] = {}
        for i, q in enumerate(queries):
            groups.setdefault(q.group_key(), []).append(i)
        return list(groups.items())

    def run(self, queries: Sequence[Query]) -> List:
        """Execute all queries; results align with the input order and are
        identical to calling the single-corpus analytics per query.

        With the registry enabled, every query gets a root span on
        ``q.trace``: the group's ``run_group`` span (shared across the
        queries it answered — that sharing IS the batching) hangs under
        each root, with chunk/pack_build/plan/execute children below it.
        """
        plans = self.plan_groups(queries)
        self.stats.queries += len(queries)
        tracing = self.registry.enabled
        roots: List[Optional[_trace.Span]] = []
        if tracing:
            now = self.clock()
            for q in queries:
                root = _trace.Span("query", now,
                                   attrs={"corpus": q.corpus,
                                          "kind": q.kind, "path": "sync"})
                object.__setattr__(q, "trace", root)
                roots.append(root)

        results: List = [None] * len(queries)
        for (kind, l, terms, k, predicate, agg), idxs in plans:
            self.stats.groups += 1
            names: List[str] = []
            for i in idxs:
                if queries[i].corpus not in names:
                    names.append(queries[i].corpus)
            if tracing:
                g = _trace.Span("run_group", self.clock(),
                                attrs={"kind": kind,
                                       "n_queries": len(idxs),
                                       "n_corpora": len(names)})
                with _trace.activate(g, self.clock):
                    by_corpus = self.run_group(kind, names, l=l,
                                               terms=terms, k=k,
                                               predicate=predicate, agg=agg)
                g.finish(self.clock())
                for i in idxs:
                    roots[i].children.append(g)
            else:
                by_corpus = self.run_group(kind, names, l=l, terms=terms,
                                           k=k, predicate=predicate,
                                           agg=agg)
            for i in idxs:
                results[i] = by_corpus[queries[i].corpus]
        if tracing:
            end = self.clock()
            for root in roots:
                root.finish(end)
                self.trace_log.append(root)
        return results

    # ------------------------------------------------------- engine core --
    def shard_count(self, n_corpora: int) -> int:
        """Devices a chunk of ``n_corpora`` would span: the mesh size once
        the chunk reaches ``shard_min_corpora`` (or outgrows a single-card
        pack), else 1."""
        if self.mesh is None:
            return 1
        if n_corpora >= self.shard_min_corpora or n_corpora > self.max_batch:
            return mesh_size(self.mesh)
        return 1

    def chunk_capacity(self, target_shards: int = 1) -> int:
        """Corpora one :meth:`execute_chunk` call may carry:
        ``max_batch`` per device, times ``min(target_shards, devices)`` —
        the async queue's ``target_shards`` knob feeds this, so a large
        flush splits across the mesh instead of running ``max_batch``-sized
        chunks one after another."""
        if target_shards < 1:
            raise ValueError("target_shards must be >= 1")
        return self.max_batch * min(target_shards, mesh_size(self.mesh))

    def run_group(self, kind: str, names: Sequence[str],
                  l: Optional[int] = None,
                  terms: Optional[Tuple[int, ...]] = None,
                  k: Optional[int] = None,
                  predicate: Optional[Tuple] = None,
                  agg: Optional[str] = None,
                  target_shards: int = 1) -> Dict:
        """Execute one normalized-parameter group over deduped ``names``.

        Chunks corpora of similar grammar size together: padding in each
        pack is bounded by the size spread within the chunk.  Name is the
        tie-break so the chunking (and thus the pack-cache key) is canonical
        for a given corpus set regardless of query order.  Both the sync
        :meth:`run` and the async queue flush land here;
        ``target_shards`` > 1 widens each chunk to span that many devices
        (:meth:`chunk_capacity`).
        """
        cap = self.chunk_capacity(target_shards)
        order = sorted(names, key=lambda n: (self._corpora[n].num_rules, n))
        out: Dict = {}
        for s in range(0, len(order), cap):
            out.update(self.execute_chunk(kind, order[s: s + cap], l=l,
                                          terms=terms, k=k,
                                          predicate=predicate, agg=agg))
        return out

    def _check_chunk_params(self, kind: str, l: Optional[int],
                            terms: Optional[Tuple[int, ...]],
                            k: Optional[int],
                            predicate: Optional[Tuple] = None,
                            agg: Optional[str] = None) -> None:
        """Group parameters must arrive normalized (``Query.effective_*``):
        required for the kinds that consume them, ``None`` everywhere else —
        a stray parameter can therefore never split or mis-share a group,
        and a missing one fails loudly instead of silently defaulting."""
        if kind == "sequence_count":
            if l is None:
                raise ValueError("sequence_count chunk needs an explicit l")
        elif l is not None:
            raise ValueError(
                f"l={l!r} is meaningless for kind {kind!r}; group keys "
                f"normalize it to None (Query.effective_l)")
        if kind in SEARCH_KINDS:
            normalize_terms(terms)
            if k is None or k < 1:
                raise ValueError(f"search chunk needs an explicit k >= 1, "
                                 f"got {k!r}")
        elif kind == "agg_terms":
            normalize_terms(terms)
        elif kind == "phrase_count":
            normalize_phrase(terms)
        elif terms is not None:
            raise ValueError(
                f"terms={terms!r} are meaningless for kind {kind!r}; group "
                f"keys normalize them to None (Query.effective_terms)")
        if kind not in SEARCH_KINDS and k is not None:
            raise ValueError(
                f"k={k!r} is meaningless for kind {kind!r}; group keys "
                f"normalize it to None (Query.effective_k)")
        if kind == "filter_count":
            normalize_predicate(predicate)   # raises on None/malformed
        elif predicate is not None:
            raise ValueError(
                f"predicate={predicate!r} is meaningless for kind "
                f"{kind!r}; group keys normalize it to None "
                f"(Query.effective_predicate)")
        if kind == "agg_terms":
            if agg not in ("sum", "max"):
                raise ValueError(f"agg_terms chunk needs an explicit "
                                 f"sum/max op, got {agg!r}")
        elif agg is not None:
            raise ValueError(
                f"agg={agg!r} is meaningless for kind {kind!r}; group "
                f"keys normalize it to None (Query.effective_agg)")

    def _count_fallback(self, kind: str, gb: Optional[GrammarBatch] = None,
                        ga: Optional[GrammarArrays] = None) -> None:
        """Predict the engine's traversal routing for this execution and
        count explicit-ELL requests that degrade to a segment_sum base
        (``stats.method_fallbacks``).  Uses the same resolution the engines
        dispatch on (core.batch.resolve_batch_method / the single-corpus
        analogue), so the counter mirrors what actually runs without the
        engines having to report back."""
        per_file = (kind in PER_FILE_KINDS or kind in SEARCH_KINDS
                    or kind in ("filter_count", "agg_terms"))
        requested = self.method
        if gb is None:
            requested = self._SINGLE_METHOD.get(requested, requested)
        if kind in SEARCH_KINDS or kind in ("filter_count", "agg_terms"):
            # search statistics (and the query tier's filter/agg counts,
            # which share them) run the per-file base of the requested
            # method (search/index.py base_method)
            requested = base_method(requested)
        if gb is not None:
            resolved = resolve_batch_method(gb, requested, per_file=per_file)
        else:
            resolved = resolve_single_method(ga, requested,
                                             per_file=per_file)
        if is_segment_sum_fallback(requested, resolved):
            self.stats.count_fallback(requested, resolved)

    def _device_scope(self):
        """Make the server's card current for one execution (PyTorch's
        current device is per thread: the async queue's serve thread
        starts on card 0)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return nullcontext()

    def _execute_batched(self, gb: GrammarBatch, kind: str,
                         l: Optional[int], terms: Optional[Tuple[int, ...]],
                         k: Optional[int],
                         predicate: Optional[Tuple] = None,
                         agg: Optional[str] = None) -> List:
        """One batched program over a pack: the six analytics via
        ``run_batched``, the search kinds via the retrieval engine (which
        memoizes its tf/df/dl statistics on the same pack), the query
        operators via the query engine (filter/agg share those memoized
        statistics; phrase reuses the pack's sequence plans)."""
        if kind in SEARCH_KINDS:
            return batched_search(gb, terms, k=k, scheme=KIND_SCHEME[kind],
                                  method=self.method)
        if kind in QUERY_KINDS:
            return run_batched_query(gb, kind, predicate=predicate,
                                     terms=terms, agg=agg,
                                     method=self.method)
        return run_batched(gb, kind, method=self.method,
                           l=3 if l is None else l)

    def execute_chunk(self, kind: str, chunk: Sequence[str],
                      l: Optional[int] = None,
                      terms: Optional[Tuple[int, ...]] = None,
                      k: Optional[int] = None,
                      predicate: Optional[Tuple] = None,
                      agg: Optional[str] = None) -> Dict:
        """ONE execution: a batched call for a multi-corpus chunk, or
        the per-corpus path (memoized weights) when the chunk degenerates to
        one corpus.  Records the observed wall latency into the
        per-signature EWMA (``stats.latency_ewma``) that the async flush
        policy uses as its batch-latency estimate.

        ``l``/``terms``/``k``/``predicate``/``agg`` must be the
        group-normalized parameters: real values for the kinds that consume
        them (sequence_count's window length; the search kinds' query terms
        and top-k; filter_count's predicate; agg_terms'/phrase_count's term
        set and op), ``None`` for every other kind (enforced in
        :meth:`_check_chunk_params` so a stray ``Query`` field can never
        split or mis-share a group).

        The execution runs with the server's card current
        (:meth:`_device_scope`), whichever thread calls.  Sharded mode
        (:meth:`shard_count` > 1): the pack splits row-wise across the
        corpus mesh, each shard on its own card and host thread — results
        bit-identical to the single-card pack.
        """
        self._check_chunk_params(kind, l, terms, k, predicate=predicate,
                                 agg=agg)
        # flush-time freshness: a store appended to after its queries were
        # validated/grouped must still be served post-append data
        for name in chunk:
            self.refresh(name)
        shards = self.shard_count(len(chunk))
        if len(chunk) > self.max_batch * shards:
            raise ValueError(f"chunk of {len(chunk)} exceeds "
                             f"max_batch={self.max_batch} x {shards} shards")
        tracing = self.registry.enabled
        top_level = tracing and _trace.current() is None
        t0 = self.clock()
        hits0 = self.stats.batch_cache_hits
        cm = (_trace.span("chunk", clock=self.clock,
                          attrs={"kind": kind, "n_corpora": len(chunk),
                                 "shards": shards})
              if tracing else nullcontext())
        with cm as chunk_span, self._device_scope(), \
                count_host_copies(self.stats.count_host_copy):
            if len(chunk) == 1 and shards == 1:
                name = chunk[0]
                if name in self._stores:
                    # CompressedCorpus: the per-corpus path reuses the
                    # traversal weights (and search index) memoized on the
                    # store
                    sig = SINGLE_SIGNATURE
                    with self._obs_stage("pack_build", tracing,
                                         path="store_memo"):
                        self._count_fallback(kind, ga=self._corpora[name])
                    with self._obs_exec(kind, sig, tracing):
                        out = {name: self._run_single(kind, name, l=l,
                                                      terms=terms, k=k,
                                                      predicate=predicate,
                                                      agg=agg)}
                else:
                    # bare GrammarArrays: a cached size-1 pack keeps its
                    # host plans (ELL plan, sequence_count windows, search
                    # statistics) across calls — repeat single-corpus
                    # traffic costs one dispatch, not one re-plan
                    with self._obs_stage("pack_build", tracing):
                        gb = self._get_batch([name])
                        self._count_fallback(kind, gb=gb)
                    sig = gb.signature
                    with self._obs_exec(kind, sig, tracing):
                        vals = self._execute_batched(gb, kind, l, terms, k,
                                                     predicate=predicate,
                                                     agg=agg)
                    out = {name: vals[0]}
                self.stats.single_calls += 1
            else:
                with self._obs_stage("pack_build", tracing):
                    gb = self._get_batch(list(chunk), shards=shards)
                    self._count_fallback(kind, gb=gb)
                sig = gb.signature
                with self._obs_exec(kind, sig, tracing):
                    vals = self._execute_batched(gb, kind, l, terms, k,
                                                 predicate=predicate,
                                                 agg=agg)
                self.stats.batched_calls += 1
                if shards > 1:
                    self.stats.sharded_calls += 1
                self.stats.signatures[gb.signature] = \
                    self.stats.signatures.get(gb.signature, 0) + 1
                out = dict(zip(chunk, vals))
            if chunk_span is not None:
                chunk_span.attrs["signature"] = _encode_label(sig)
                chunk_span.attrs["cache_hit"] = \
                    self.stats.batch_cache_hits > hits0
        self.stats.observe_latency(kind, sig, self.clock() - t0)
        if top_level:
            # a chunk reached outside any query/flush span (direct
            # execute_chunk / run_group callers): log its tree standalone
            self.trace_log.append(chunk_span)
        return out

    @contextmanager
    def _obs_stage(self, stage: str, tracing: bool, **attrs):
        """One stage span under the ambient chunk span + the per-stage
        histogram; collapses to nothing when the registry is disabled."""
        if not tracing:
            yield None
            return
        with _trace.span(stage, clock=self.clock, attrs=attrs) as s:
            yield s
        self.stats.stage_seconds.labels(stage).observe(s.duration)

    def _obs_exec(self, kind: str, sig: Tuple, tracing: bool):
        """The device-execution stage.  Named ``compile`` on the first
        execution of a (kind, signature) pair — the JAX package's name for
        the call that pays its one-off costs (here plan builds, not a
        compile), the same first call the latency EWMA skips
        (``observe_latency``) — and ``execute`` on every later one."""
        if not tracing:
            return nullcontext()
        first = (kind, sig) not in self.stats.latency_obs
        return self._obs_stage("compile" if first else "execute", True,
                               first_call=first)

    # ---------------------------------------------------------- internals --
    def _get_batch(self, names: Sequence[str],
                   shards: int = 1) -> GrammarBatch:
        key = (tuple(names), shards)
        epochs = tuple(self._epochs.get(n, 0) for n in names)
        gb = self._batches.get(key)
        if gb is not None:
            # belt-and-braces: refresh() already purges packs when a store
            # mutates, but an epoch-stamped hit is re-verified anyway so a
            # stale pack cannot serve even if a future code path forgets
            # the refresh (the raising guard is GrammarBatch.check_epochs;
            # tests monkeypatch refresh away to prove this layer fires).
            # A sharded pack's padding rows repeat real rows' epochs: the
            # real prefix decides
            if gb.epochs[: len(epochs)] == epochs:
                self.stats.batch_cache_hits += 1
                return gb
            del self._batches[key]
            self.stats.epoch_invalidations += 1
        gas = [self._corpora[n] for n in names]
        if shards > 1:
            # shards > 1 implies shards == mesh_size(self.mesh): the pad +
            # build + shard recipe is the library's, in one place
            gb = shard_batch(gas, self.mesh, epochs=epochs)
        else:
            gb = GrammarBatch.build(gas, device=self.device, epochs=epochs)
        while len(self._batches) >= self.MAX_CACHED_BATCHES:
            self._batches.pop(next(iter(self._batches)))   # FIFO eviction
        self._batches[key] = gb
        return gb

    def _run_single(self, kind: str, name: str, l: Optional[int] = None,
                    terms: Optional[Tuple[int, ...]] = None,
                    k: Optional[int] = None,
                    predicate: Optional[Tuple] = None,
                    agg: Optional[str] = None):
        """Per-corpus path: reuses weights memoized on the corpus store."""
        ga = self._corpora[name]
        store = self._stores.get(name)
        m = self._SINGLE_METHOD.get(self.method, self.method)
        dev = self.device
        if kind in QUERY_KINDS:
            # query_corpus duck-types the store: filter/agg reuse the
            # memoized per-file traversal weights, phrase the memoized
            # top-down weights
            return query_corpus(store if store is not None else ga, kind,
                                predicate=predicate, terms=terms, agg=agg,
                                method=m, device=dev)
        if kind in SEARCH_KINDS:
            # search_corpus reuses the SearchIndex memoized on the store
            # (and, through it, the memoized per-file traversal weights)
            return search_corpus(store if store is not None else ga,
                                 terms, k=k, scheme=KIND_SCHEME[kind],
                                 method=m, device=dev)
        # only run (and memoize) the traversal the query actually needs
        w = wf = None
        if store is not None:
            if kind in ("word_count", "sort", "sequence_count"):
                w = store.top_down_weights(m, device=dev)
            elif kind in PER_FILE_KINDS:
                wf = store.per_file_weights(m, device=dev)
        if kind == "word_count":
            return to_host(_analytics.word_count(ga, method=m, weights=w,
                                                 device=dev))
        if kind == "sort":
            return to_host(_analytics.sort_words(ga, method=m, weights=w,
                                                 device=dev))
        if kind == "term_vector":
            return to_host(_analytics.term_vector(
                ga, method=m, file_weights=wf, device=dev))
        if kind == "inverted_index":
            return to_host(_analytics.inverted_index(
                ga, method=m, file_weights=wf, device=dev))
        if kind == "ranked_inverted_index":
            return to_host(_analytics.ranked_inverted_index(
                ga, method=m, file_weights=wf, device=dev))
        if kind == "sequence_count":
            return _analytics.sequence_count(ga, l=l, method=m, weights=w,
                                             device=dev)
        raise ValueError(f"unknown analytics kind {kind!r}")

