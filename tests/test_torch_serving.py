"""The port's analytics server and async queue against the JAX package's.

* A mixed run of all 11 served kinds, with ``max_batch`` small enough to
  split each group into several chunks and to send one chunk down the
  store's single-corpus path, gives the reference server's results bit
  for bit, and the same counters (``queries``, ``groups``,
  ``batched_calls``, ``single_calls``, ``method_fallbacks``,
  ``batch_cache_hits``, ``epoch_invalidations``, pack signatures), under
  every traversal method; both registries expose the same metric families,
  and the port's one more (``repro_server_host_copy_bytes_total``).
* Answers: every analytics kind, through ``run_batched`` and the server,
  comes back in its true shape and dtype (a pack whose vocabularies are
  not powers of two), each call's arrays its own: an answer held from one
  call keeps its values through the next; no host copy is counted on the
  CPU.
* Ingest: an append between submit and flush is served fresh; a stale
  pack is refused (``check_epochs``) and a stale pack planted back into the
  cache is re-verified away.
* The async queue: one scripted run of submits and ticks on a simulated
  clock gives the same ``FlushEvent`` log (reason, size, ``n_shed``) in
  both packages; the flush fuzz of the JAX package's queue tests holds;
  submits from several threads against the background serve loop equal
  the sync answers.
* Devices: ``AnalyticsServer()`` without a device raises with no card;
  two visible cards give a two-shard corpus mesh (sharded serving is
  tested in test_torch_shard.py).

The JAX server is built with ``mesh=None`` throughout (its sharded path
is a known fault of the reference on this JAX).  Everything runs on the
CPU.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro.core import compress_files as jcompress, flatten as jflatten
from repro.data import CompressedCorpus as JCorpus
import repro.serving as js
from repro_torch.core import GrammarArrays, GrammarBatch, StaleGrammarError
from repro_torch.core import batch as tbatch
from repro_torch.core.batch import (ANALYTICS_KINDS, METHODS,
                                    PER_FILE_KINDS, run_batched)
from repro_torch.data import CompressedCorpus
from repro_torch.distributed import corpus_mesh, mesh_size
from repro_torch.obs import MetricsRegistry, global_registry, span_problems
import repro_torch.serving as ts

from _hypothesis_compat import given, settings, st
from _oracle import assert_result_equal, oracle, oracle_search
from _torch_inputs import ragged_corpora
from conftest import make_repetitive_files

torch.set_num_threads(1)

FIELDS = [f.name for f in dataclasses.fields(GrammarArrays)]
COUNTERS = ("queries", "groups", "batched_calls", "sharded_calls",
            "single_calls", "batch_cache_hits", "epoch_invalidations",
            "submitted", "rejected", "shed")
PRED = ("or", (("term", 1, 1), ("and", (("term", 2, 2), ("term", 3, 1)))))


class SimClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _files(seed: int, n: int):
    """(files, vocab) of ``n`` small corpora; the last is the largest, so
    it sorts last in every group and takes the single-corpus path."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        vocab = int(rng.integers(10, 40))
        out.append((make_repetitive_files(
            rng, vocab, n_files=int(rng.integers(2, 4)) + (i == n - 1)),
            vocab))
    big = out[-1]
    out[-1] = (big[0] + [np.tile(f, 3) for f in big[0]], big[1])
    return out


def _servers(corpora, method="frontier", max_batch=2, clock=None):
    """(JAX server, port server) with the first corpora registered as
    ``GrammarArrays`` (``c0``...) and the last as a store (``store``)."""
    kw = {} if clock is None else dict(clock=clock)
    jsrv = js.AnalyticsServer(max_batch=max_batch, method=method, mesh=None,
                              **kw)
    tsrv = ts.AnalyticsServer(max_batch=max_batch, method=method,
                              device="cpu", **kw)
    for i, (files, v) in enumerate(corpora[:-1]):
        g, nf = jcompress(files, v)
        jga = jflatten(g, v, nf)
        jsrv.register(f"c{i}", jga)
        tsrv.register(f"c{i}", GrammarArrays.from_numpy(
            {n: getattr(jga, n) for n in FIELDS}))
    files, v = corpora[-1]
    jsrv.register("store", JCorpus.build(files, v))
    tsrv.register("store", CompressedCorpus.build(files, v))
    return jsrv, tsrv


def _mixed(Q, names):
    """Every served kind on every corpus, plus groups that reach one
    corpus only: a search on the store (its single-corpus path) and a
    filter on ``c0`` (a cached size-1 pack)."""
    out = []
    for c in names:
        out += [Q(c, "word_count"), Q(c, "sort"), Q(c, "term_vector"),
                Q(c, "inverted_index"), Q(c, "ranked_inverted_index"),
                Q(c, "sequence_count", l=3),
                Q(c, "search_bm25", terms=(1, 2, 10_000, 1), k=3),
                Q(c, "search_tfidf", terms=(0, 5)),
                Q(c, "filter_count", predicate=PRED),
                Q(c, "agg_terms", terms=(1, 2, 77), agg="sum"),
                Q(c, "agg_terms", terms=(1, 2), agg="max"),
                Q(c, "phrase_count", terms=(1, 2))]
    out += [Q("store", "search_bm25", terms=(3, 4), k=50),
            Q("store", "phrase_count", terms=(2, 3, 4)),
            Q("c0", "filter_count", predicate=("term", 4, 2)),
            Q("c0", "word_count", l=5)]         # l is inert off sequences
    return out


def _same(got, want, what):
    if isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{what}[{i}]")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (what, g.dtype,
                                                       w.dtype, g.shape,
                                                       w.shape)
    assert np.array_equal(g, w), (what, g, w)


def _stats(srv):
    st_ = srv.stats
    return ({a: getattr(st_, a) for a in COUNTERS},
            dict(st_.method_fallbacks), dict(st_.signatures),
            dict(st_.flushes))


@pytest.fixture(scope="module")
def corpora():
    return _files(31, 4)


# ------------------------------------------------------------- sync run --
@pytest.mark.parametrize("method", METHODS)
def test_mixed_run_matches_the_reference_server(corpora, method):
    jsrv, tsrv = _servers(corpora, method=method)
    names = tsrv.corpora()
    assert names == jsrv.corpora()
    for rnd in range(2):                 # the second run hits the caches
        want = jsrv.run(_mixed(js.Query, names))
        got = tsrv.run(_mixed(ts.Query, names))
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{method} round {rnd} query {i}")
        assert _stats(tsrv) == _stats(jsrv)
    st_ = tsrv.stats
    assert st_.single_calls > 0 and st_.batched_calls > 0
    assert st_.batch_cache_hits > 0
    # the same metric families, so a dashboard reads either package, and
    # the port's one more: the bytes of answers copied off the device
    tsnap, jsnap = tsrv.registry.snapshot(), jsrv.registry.snapshot()
    assert {n: v["type"] for n, v in tsnap.items()} == \
        {n: v["type"] for n, v in jsnap.items()} | \
        {"repro_server_host_copy_bytes_total": "counter"}
    text = tsrv.registry.render_prometheus()
    assert "# TYPE repro_server_queries_total counter" in text


#: each analytics kind's answer parts and their dtypes
ANSWER_DTYPES = {"word_count": (np.float32,), "sort": (np.int32, np.float32),
                 "term_vector": (np.float32,), "inverted_index": (np.bool_,),
                 "ranked_inverted_index": (np.int32, np.float32),
                 "sequence_count": (np.int32, np.float32)}


def _parts(answers):
    return [p for a in answers for p in (a if isinstance(a, tuple) else (a,))]


def _check_own_answers(kind, jgas, first, second_call):
    """``first`` (a call's answers, one a corpus) equals the oracle in
    true shapes and dtypes; ``second_call()`` repeats the call; neither
    call's arrays share memory with the other's, and ``first`` keeps its
    values (the benchmark's check holds early answers this way)."""
    for i, (jga, got) in enumerate(zip(jgas, first)):
        want = oracle(jga, kind)
        assert_result_equal(got, want, kind, f"corpus {i}")
        gots = got if isinstance(got, tuple) else (got,)
        wants = want if isinstance(want, tuple) else (want,)
        assert [g.dtype for g in gots] == \
            [np.dtype(d) for d in ANSWER_DTYPES[kind]], (kind, i)
        assert [g.shape for g in gots] == [np.shape(w) for w in wants]
    held = [p.copy() for p in _parts(first)]
    second = second_call()
    for a in _parts(first):
        for b in _parts(second):
            assert not np.shares_memory(a, b), kind
    for a, h in zip(_parts(first), held):
        np.testing.assert_array_equal(a, h, err_msg=kind)
    for a, b in zip(_parts(first), _parts(second)):
        np.testing.assert_array_equal(a, b, err_msg=kind)


@pytest.mark.parametrize("kind", ANALYTICS_KINDS)
def test_answers_are_true_shapes_and_the_callers_own(kind):
    jgas = []
    for files, v in ragged_corpora():
        g, nf = jcompress(files, v)
        jgas.append(jflatten(g, v, nf))
    tgas = [GrammarArrays.from_numpy({n: getattr(ga, n) for n in FIELDS})
            for ga in jgas]
    gb = GrammarBatch.build(tgas, device="cpu")
    assert gb.V_pad not in [ga.vocab_size for ga in tgas]
    _check_own_answers(kind, jgas, run_batched(gb, kind),
                       lambda: run_batched(gb, kind))
    srv = ts.AnalyticsServer(max_batch=len(tgas), device="cpu")
    names = [f"c{i}" for i in range(len(tgas))]
    for name, ga in zip(names, tgas):
        srv.register(name, ga)

    def served():
        return srv.run([ts.Query(c, kind) for c in names])

    _check_own_answers(kind, jgas, served(), served)
    assert srv.stats.batched_calls == 2
    assert srv.stats.host_copy_bytes == {"pinned": 0, "pageable": 0}
    samples = srv.registry.snapshot()[
        "repro_server_host_copy_bytes_total"]["samples"]
    assert {r["labels"]["path"]: r["value"] for r in samples} == \
        {"pinned": 0, "pageable": 0}


def test_search_answers_equal_the_oracle(corpora):
    """A direct oracle check of the served scores (the reference is itself
    held to the oracle by its own suite)."""
    _, tsrv = _servers(corpora)
    jgas = []
    for files, v in corpora:
        g, nf = jcompress(files, v)
        jgas.append(jflatten(g, v, nf))
    names = ["c0", "c1", "c2", "store"]
    for kind, scheme in (("search_bm25", "bm25"), ("search_tfidf", "tfidf")):
        got = tsrv.run([ts.Query(c, kind, terms=(1, 2, 99), k=4)
                        for c in names])
        for jga, (ids, sc) in zip(jgas, got):
            o_ids, o_sc = oracle_search(jga, (1, 2, 99), k=4, scheme=scheme)
            _same(ids, o_ids, kind)
            _same(sc, o_sc, kind)


def test_query_keys_and_validation_match_the_reference():
    assert ts.SERVED_KINDS == js.SERVED_KINDS
    pairs = [dict(corpus="a", kind="word_count", l=7, terms=(1,), k=3),
             dict(corpus="a", kind="search_bm25", terms=[1, 2]),
             dict(corpus="a", kind="search_tfidf", terms=(1,), k=10),
             dict(corpus="a", kind="filter_count", predicate=["term", 1, 1]),
             dict(corpus="a", kind="agg_terms", terms=(1,)),
             dict(corpus="a", kind="phrase_count", terms=(1, 2), l=4),
             dict(corpus="a", kind="sequence_count", l=4)]
    for kw in pairs:
        assert ts.Query(**kw).group_key() == js.Query(**kw).group_key()
    srv = ts.AnalyticsServer(device="cpu")
    for bad in (ts.Query("nope", "word_count"),
                ts.Query("nope", "grep"),
                ts.Query("nope", "search_bm25"),
                ts.Query("nope", "search_bm25", terms=(1,), k=0),
                ts.Query("nope", "filter_count"),
                ts.Query("nope", "agg_terms", terms=(1,), agg="mean"),
                ts.Query("nope", "phrase_count", terms=(1,))):
        with pytest.raises((KeyError, ValueError)):
            srv.validate(bad)
    with pytest.raises(ValueError, match="meaningless"):
        srv.execute_chunk("word_count", ["nope"], l=3)
    with pytest.raises(ValueError, match="max_batch"):
        ts.AnalyticsServer(max_batch=0, device="cpu")
    with pytest.raises(ValueError, match="method"):
        ts.AnalyticsServer(method="fastest", device="cpu")


def test_spans_cover_every_stage(corpora):
    _, tsrv = _servers(corpora[:2] + corpora[-1:])
    qs = [ts.Query("c0", "search_bm25", terms=(1, 2)),
          ts.Query("c1", "search_bm25", terms=(1, 2)),
          ts.Query("store", "phrase_count", terms=(1, 2))]
    tsrv.run(qs)
    for q in qs:
        assert span_problems(q.trace, require=(
            "query", "run_group", "chunk", "pack_build")) == []
    stages = tsrv.stats.stage_seconds
    assert stages.labels("compile").count >= 2
    tsrv.run(qs)
    assert stages.labels("execute").count >= 2


# --------------------------------------------------------------- ingest --
def test_append_between_submit_and_flush_is_served_fresh(corpora):
    files, v = corpora[0]
    tail = corpora[1][0]
    out = {}
    for pkg, Corpus, kw in ((ts, CompressedCorpus, dict(device="cpu")),
                            (js, JCorpus, dict(mesh=None))):
        store = Corpus.build(list(files), v)
        srv = pkg.AnalyticsServer(**kw)
        srv.register("c", store)
        qs = [pkg.Query("c", "word_count"),
              pkg.Query("c", "search_bm25", terms=(1, 2, 3)),
              pkg.Query("c", "filter_count", predicate=PRED),
              pkg.Query("c", "phrase_count", terms=(1, 2))]
        srv.run(qs)                      # warm every memo and pack layer
        aq = pkg.AsyncAnalyticsServer(srv, idle_timeout=100.0,
                                      clock=SimClock())
        futs = [aq.submit(q) for q in qs]
        store.append_files([np.asarray(f) % v for f in tail])
        aq.drain()
        out[pkg] = ([f.result(timeout=30) for f in futs],
                    srv.stats.epoch_invalidations)
    fresh = ts.AnalyticsServer(device="cpu")
    fresh.register("c", CompressedCorpus.build(
        list(files) + [np.asarray(f) % v for f in tail], v))
    want = fresh.run([ts.Query("c", "word_count"),
                      ts.Query("c", "search_bm25", terms=(1, 2, 3)),
                      ts.Query("c", "filter_count", predicate=PRED),
                      ts.Query("c", "phrase_count", terms=(1, 2))])
    _same(out[ts][0], want, "post-append answers")
    _same(out[ts][0], out[js][0], "post-append answers vs jax")
    assert out[ts][1] == out[js][1] >= 1


def test_check_epochs_raises_on_a_stale_pack(corpora):
    gas = [CompressedCorpus.build(files, v).ga for files, v in corpora[:2]]
    gb = GrammarBatch.build(gas, device="cpu", epochs=(0, 3))
    assert gb.epochs == (0, 3) and gb.real_gas == gb.gas
    assert gb.shards == 1 and gb.signature[-1] == 1
    gb.check_epochs((0, 3))
    with pytest.raises(StaleGrammarError, match="row 1"):
        gb.check_epochs((0, 4))
    gb.check_epochs((0,))
    with pytest.raises(StaleGrammarError, match="stamped with"):
        gb.check_epochs((0, 3, 0))
    GrammarBatch.build(gas, device="cpu").check_epochs((7, 7))
    with pytest.raises(ValueError, match="epochs"):
        GrammarBatch.build(gas, device="cpu", epochs=(0,))


def test_stale_pack_planted_in_the_cache_is_refused(corpora):
    (fa, va), (fb, vb) = corpora[0], corpora[1]
    store = CompressedCorpus.build(list(fa), va)
    srv = ts.AnalyticsServer(device="cpu")
    srv.register("a", store)
    srv.register("b", CompressedCorpus.build(fb, vb))
    qs = [ts.Query("a", "filter_count", predicate=PRED),
          ts.Query("b", "filter_count", predicate=PRED)]
    srv.run(qs)
    stale = next(iter(srv._batches.values()))
    assert stale.epochs == (0, 0)
    store.append_files([fa[0]])
    srv.run(qs)                          # refresh purges and rebuilds
    key = next(k for k in srv._batches if "a" in k[0])   # (names, shards)
    srv._batches[key] = stale            # a lost purge
    before = srv.stats.epoch_invalidations
    got = srv.run(qs)
    assert srv.stats.epoch_invalidations > before
    assert srv._batches[key] is not stale
    fresh = ts.AnalyticsServer(device="cpu")
    fresh.register("a", CompressedCorpus.build(list(fa) + [fa[0]], va))
    _same(got[0], fresh.run(qs[:1])[0], "post-append filter")


# ---------------------------------------------------------- async queue --
def _script(pkg, corpora):
    """Submits and ticks on a simulated clock shared by engine and queue:
    a max_batch fill, deadline flushes (one of them sheds an expired
    query), an idle flush, a max_wait flush under a steady stream, and a
    drain."""
    clk = SimClock()
    jsrv, tsrv = _servers(corpora, max_batch=2, clock=clk)
    srv = tsrv if pkg is ts else jsrv
    aq = pkg.AsyncAnalyticsServer(srv, idle_timeout=0.05, max_wait=0.2,
                                  default_latency=0.01)
    Q = pkg.Query
    futs = []

    def at(t, q, deadline=None):
        clk.t = t
        futs.append(aq.submit(q, deadline=deadline))

    def tick(t):
        clk.t = t
        aq.poll()

    at(0.0, Q("c0", "word_count"))
    at(0.001, Q("c1", "word_count"))                # fills: max_batch
    at(0.002, Q("c0", "search_bm25", terms=(1, 2)), deadline=0.03)
    at(0.003, Q("c2", "filter_count", predicate=PRED), deadline=0.001)
    tick(0.01)
    tick(0.025)                                     # deadline flush
    at(0.03, Q("c1", "inverted_index"))
    tick(0.06)
    tick(0.09)                                      # idle flush
    for j in range(8):                              # steady stream
        at(0.1 + 0.03 * j, Q("c0", "agg_terms", terms=(1, 2), agg="max"))
        tick(0.1 + 0.03 * j + 0.001)                # max_wait at 0.311
    tick(0.4)
    at(0.41, Q("store", "phrase_count", terms=(1, 2)))
    at(0.42, Q("c1", "sequence_count", l=2))
    aq.drain()
    log = [(e.reason, e.kind, e.l, e.n_queries, e.n_corpora, e.at,
            e.n_shed, e.terms, e.k, e.predicate, e.agg)
           for e in aq.flush_log]
    results = []
    for f in futs:
        exc = f.exception(timeout=30)
        results.append(type(exc).__name__ if exc is not None
                       else f.result())
    return log, results, dict(srv.stats.flushes), srv.stats.shed


def test_simulated_clock_script_gives_the_reference_flush_log(corpora):
    tlog, tres, tflush, tshed = _script(ts, corpora)
    jlog, jres, jflush, jshed = _script(js, corpora)
    assert tlog == jlog
    assert tflush == jflush and tshed == jshed == 1
    assert {e[0] for e in tlog} == {"max_batch", "deadline", "idle",
                                    "max_wait", "drain"}
    assert len(tres) == len(jres)
    for i, (g, w) in enumerate(zip(tres, jres)):
        if isinstance(w, str):
            assert g == w == "DeadlineExceeded"
        else:
            _same(g, w, f"scripted query {i}")


POLL_DT = 0.005
FUZZ_KINDS = ("word_count", "sort", "term_vector", "inverted_index",
              "ranked_inverted_index", "sequence_count", "search_bm25",
              "search_tfidf", "filter_count", "agg_terms", "phrase_count")


def _fuzz_query(rng, names):
    kind = FUZZ_KINDS[int(rng.integers(len(FUZZ_KINDS)))]
    c = names[int(rng.integers(len(names)))]
    terms = tuple(int(t) for t in rng.integers(0, 12, int(rng.integers(2,
                                                                      4))))
    return ts.Query(c, kind, l=int(rng.integers(2, 5)), terms=terms,
                    k=int(rng.integers(1, 5)),
                    predicate=("term", terms[0], 1),
                    agg=("sum", "max")[int(rng.integers(2))])


@settings(max_examples=3, deadline=None)
@given(st.integers(0, 100_000))
def test_flush_fuzz_never_starves_and_matches_sync(seed):
    """The queue fuzz of the JAX package's tests over all 11 kinds: every
    future resolves, an on-time result meets its deadline within a tick,
    expired queries are shed and counted once, no flush packs more than
    ``max_batch`` corpora, and every result equals the sync run's."""
    rng = np.random.default_rng(seed)
    _, eng = _servers(_files(5, 4), max_batch=3)
    clk = SimClock()
    aq = ts.AsyncAnalyticsServer(eng, idle_timeout=4 * POLL_DT,
                                 default_latency=POLL_DT, clock=clk)
    names = eng.corpora()
    queries = [_fuzz_query(rng, names) for _ in range(int(rng.integers(6,
                                                                       16)))]
    arrivals = np.cumsum(rng.exponential(POLL_DT, len(queries)))
    deadlines = []
    for at in arrivals:
        r = rng.random()
        if r < 0.4:
            deadlines.append(None)
        elif r < 0.8:
            deadlines.append(float(at) + float(rng.uniform(POLL_DT,
                                                           10 * POLL_DT)))
        else:
            deadlines.append(float(at) - float(rng.uniform(0.1 * POLL_DT,
                                                           5 * POLL_DT)))
    futs = [None] * len(queries)
    done_at = {}
    i, tick = 0, 0.0
    horizon = float(arrivals[-1]) + 100 * POLL_DT
    while len(done_at) < len(queries):
        next_tick = tick + POLL_DT
        if i < len(queries) and arrivals[i] <= next_tick:
            clk.t = float(arrivals[i])
            futs[i] = aq.submit(queries[i], deadline=deadlines[i])
            i += 1
        else:
            tick = next_tick
            clk.t = tick
            aq.poll()
        for j, f in enumerate(futs):
            if f is not None and j not in done_at and f.done():
                done_at[j] = clk.t
        assert clk.t <= horizon, "queries starved past the horizon"
    shed = [j for j, f in enumerate(futs) if f.exception() is not None]
    for j, dl in enumerate(deadlines):
        if dl is not None and j not in shed:
            assert done_at[j] <= dl + POLL_DT + 1e-9
    for j in shed:
        assert deadlines[j] is not None
        assert isinstance(futs[j].exception(), ts.DeadlineExceeded)
    for j, (at, dl) in enumerate(zip(arrivals, deadlines)):
        if dl is not None and dl < float(at):
            assert j in shed
    assert eng.stats.shed == len(shed)
    assert sum(ev.n_shed for ev in aq.flush_log) == len(shed)
    for ev in aq.flush_log:
        assert ev.n_corpora <= eng.max_batch
    want = eng.run(queries)
    for j, f in enumerate(futs):
        if j not in shed:
            _same(f.result(), want[j], f"fuzz query {j}")


def test_threaded_submits_match_sync(corpora):
    """Four threads submit with deadlines against the background serve
    loop; after drain every answer equals the sync run's, nothing shed."""
    _, srv = _servers(corpora, max_batch=3)
    queries = _mixed(ts.Query, srv.corpora())
    want = srv.run(queries)
    aq = ts.AsyncAnalyticsServer(srv, idle_timeout=0.002).start()
    futs = [None] * len(queries)

    def worker(w):
        for j in range(w, len(queries), 4):
            futs[j] = aq.submit(queries[j], deadline=srv.clock() + 60.0)

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    aq.drain()
    aq.close()
    for j, f in enumerate(futs):
        _same(f.result(timeout=60), want[j], f"threaded query {j}")
    assert srv.stats.shed == 0
    assert sum(srv.stats.flushes.values()) >= 1


# -------------------------------------------------------------- devices --
def test_server_without_device_raises_with_no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.AnalyticsServer()
    assert ts.AnalyticsServer(device="cpu").device.type == "cpu"


def test_more_than_one_card_raises_until_sharding_is_ported(monkeypatch):
    """Sharding is ported: two visible cards give a two-shard corpus mesh
    (nothing raises any more), and a server takes a caller's mesh."""
    assert corpus_mesh(devices=[torch.device("cpu")]) is None
    assert mesh_size(None) == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert mesh_size(corpus_mesh()) == 2
    mesh = corpus_mesh(("cpu",) * 2)
    assert ts.AnalyticsServer(device="cpu", mesh=mesh).mesh is mesh
    with pytest.raises(ValueError, match="mesh must be"):
        ts.AnalyticsServer(device="cpu", mesh="everywhere")
    # a CPU server never spans cards, whatever the machine holds
    assert ts.AnalyticsServer(device="cpu").mesh is None


@pytest.mark.parametrize("method", ["frontier_ell", "leveled_ell",
                                    "frontier_fused"])
def test_method_fallbacks_match_the_reference(corpora, method, monkeypatch):
    """With the dense-plan budget cut so that the per-file rounds of the
    larger packs no longer fit, explicit ELL requests degrade to their
    segment_sum base: both servers count the same fallbacks and still
    answer alike."""
    import repro.kernels.ops as jops
    import repro_torch.kernels.ops as tops
    for mod in (jops, tops):
        monkeypatch.setattr(mod, "ELL_PLAN_MAX_ENTRIES", 1 << 8)
    jsrv, tsrv = _servers(corpora, method=method)
    names = tsrv.corpora()
    want = jsrv.run(_mixed(js.Query, names))
    got = tsrv.run(_mixed(ts.Query, names))
    for i, (g, w) in enumerate(zip(got, want)):
        _same(g, w, f"{method} query {i}")
    assert _stats(tsrv) == _stats(jsrv)
    assert sum(tsrv.stats.method_fallbacks.values()) > 0


# ------------------------------------------------------- traversal spans --
def _traversal_counts(method: str, per_file: bool):
    """(traversals, host rounds) the process registry has counted."""
    reg = global_registry()
    labels = (method, "true" if per_file else "false")
    return tuple(reg.counter(name, "", ("method", "per_file"))
                 .labels(*labels).value
                 for name in ("repro_engine_traversals_total",
                              "repro_engine_host_rounds_total"))


@pytest.mark.parametrize("method", ["frontier", "frontier_fused"])
def test_traverse_spans_and_counters(corpora, method):
    """A traced run records one ``traverse`` span a traversal, under the
    chunk's execution stage, naming the resolved method, the payload and
    the rounds that ended in a host sync (those ``_frontier_weights`` and
    its per-file twin ran on the same pack, one a level of the deepest
    DAG; 0 for the fused loop, which runs on the device); an untraced
    server records no span; the process registry counts both."""
    gas = [CompressedCorpus.build(files, v).ga for files, v in corpora[:3]]
    gb = GrammarBatch.build(gas, device="cpu")
    coo = (gb.edge_parent, gb.edge_child, gb.edge_freq, gb.edge_valid,
           gb.in_deg)
    roots = (gb.root_seen, gb.fedge_child, gb.fedge_file, gb.fedge_freq,
             gb.F_pad)
    if method == "frontier":
        want = {False: ("frontier", tbatch._frontier_weights(*coo)[1]),
                True: ("frontier",
                       tbatch._per_file_frontier_weights(*coo, *roots)[1])}
    else:                       # the fused kernel is scalar
        src, freq, _, _ = gb.ell_plan()
        want = {False: ("frontier_fused", 0),
                True: ("frontier_ell", tbatch._per_file_frontier_ell_weights(
                    src, freq, gb.in_deg, *roots)[1])}
    depth = max(ga.num_levels for ga in gas)
    for per_file, (m, rounds) in want.items():
        assert tbatch.resolve_batch_method(gb, method, per_file) == m
        # a round a level of the deepest DAG; the per-file init takes
        # the root's
        assert rounds == (0 if m == "frontier_fused" else depth - per_file)
    traced = ts.AnalyticsServer(max_batch=4, method=method, device="cpu")
    quiet = ts.AnalyticsServer(max_batch=4, method=method, device="cpu",
                               registry=MetricsRegistry(enabled=False))
    for srv in (traced, quiet):
        for i, ga in enumerate(gas):
            srv.register(f"c{i}", ga)
    for kind in ("word_count", "term_vector", "sequence_count"):
        per_file = kind in PER_FILE_KINDS
        m, rounds = want[per_file]
        for srv in (traced, quiet):
            before = _traversal_counts(m, per_file)
            qs = [ts.Query(f"c{i}", kind) for i in range(len(gas))]
            srv.run(qs)
            assert _traversal_counts(m, per_file) == (before[0] + 1,
                                                      before[1] + rounds)
            if srv is quiet:
                assert all(q.trace is None for q in qs)
                continue
            for q in qs:
                assert span_problems(q.trace, require=("traverse",)) == []
                spans = q.trace.find("traverse")
                assert [(s.attrs["method"], s.attrs["per_file"],
                         s.attrs["host_rounds"]) for s in spans] == [
                    (m, per_file, rounds)], kind
                stage = [s for s in q.trace.walk()
                         if spans[0] in s.children]
                assert [s.name for s in stage] in (["compile"],
                                                   ["execute"])
