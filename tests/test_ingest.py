"""Streaming ingestion tier (data/store.py ``append_files``).

Three claims, each with its own enforcement:

* **incremental == from-scratch** — appending files to a live corpus
  yields grammar arrays BIT-identical to rebuilding from the concatenated
  file list (Sequitur is online; both paths run the same op sequence).
  Held to exhaustive field equality here and to full analytics/search
  equality in tests/test_differential.py.
* **invariants survive every append** — the property suite checks the
  full Sequitur invariant set (tests/_invariants.py) after EVERY single
  append, over random and adversarial streams.
* **a stale epoch can never serve** — every memo layer (store weight
  cache, server pack cache, the pack's own epoch stamp) is attacked
  directly: poisoned stale entries must be detected, not returned.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest

from _hypothesis_compat import example, given, settings, st
from _invariants import check_all, expected_stream
from conftest import make_repetitive_files

from repro.core import GrammarBatch, IncrementalSequitur, StaleGrammarError
from repro.core.sequitur import Grammar
from repro.data import CompressedCorpus
from repro.serving import AnalyticsServer, AsyncAnalyticsServer, Query

VOCAB = 30


def _ga_fields_equal(a, b) -> None:
    """Exhaustive GrammarArrays equality: every dataclass field, arrays
    bit-exact — a new field can never silently escape the comparison."""
    for f in dataclasses.fields(type(a)):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray) or hasattr(va, "shape"):
            np.testing.assert_array_equal(
                np.asarray(va), np.asarray(vb),
                err_msg=f"GrammarArrays.{f.name} differs")
        else:
            assert va == vb, f"GrammarArrays.{f.name}: {va} != {vb}"


def _corpora_equal(a: CompressedCorpus, b: CompressedCorpus) -> None:
    _ga_fields_equal(a.ga, b.ga)
    np.testing.assert_array_equal(a.file_starts, b.file_starts)
    np.testing.assert_array_equal(a.file_lens, b.file_lens)


# ------------------------------------------------------------------ core --
def test_append_matches_rebuild_bit_exact(seeded_rng):
    base = make_repetitive_files(seeded_rng, VOCAB, n_files=3)
    tail = make_repetitive_files(seeded_rng, VOCAB, n_files=2)
    appended = CompressedCorpus.build(base, VOCAB).append_files(tail)
    rebuilt = CompressedCorpus.build(base + tail, VOCAB)
    _corpora_equal(appended, rebuilt)
    assert appended.epoch == 1 and rebuilt.epoch == 0


def test_repeated_appends_match_rebuild(seeded_rng):
    files = make_repetitive_files(seeded_rng, VOCAB, n_files=6)
    corpus = CompressedCorpus.build(files[:1], VOCAB)
    for i in range(1, len(files)):
        corpus.append_files([files[i]])
        _corpora_equal(corpus, CompressedCorpus.build(files[:i + 1], VOCAB))
    assert corpus.epoch == len(files) - 1


def test_windows_after_append(seeded_rng):
    """Per-file and global windows address the appended files correctly."""
    base = make_repetitive_files(seeded_rng, VOCAB, n_files=2)
    tail = make_repetitive_files(seeded_rng, VOCAB, n_files=2)
    corpus = CompressedCorpus.build(base, VOCAB).append_files(tail)
    for fid, f in enumerate(base + tail):
        np.testing.assert_array_equal(corpus.window(fid, 0, len(f)), f)
    stream = expected_stream(base + tail, VOCAB)
    np.testing.assert_array_equal(
        corpus.global_window(0, len(stream)), stream)


def test_empty_append_is_noop(seeded_rng):
    files = make_repetitive_files(seeded_rng, VOCAB, n_files=2)
    corpus = CompressedCorpus.build(files, VOCAB)
    corpus.top_down_weights()
    keys = corpus.cached_weight_keys()
    assert corpus.append_files([]) is corpus
    assert corpus.epoch == 0 and corpus.cached_weight_keys() == keys


def test_word_token_validation():
    inc = IncrementalSequitur(vocab_size=5)
    with pytest.raises(ValueError, match="outside word range"):
        inc.append_file(np.array([0, 5]))        # splitter-range collision
    with pytest.raises(ValueError, match="outside word range"):
        inc.append_file(np.array([-1]))
    with pytest.raises(ValueError, match="1-D"):
        inc.append_file(np.zeros((2, 2), np.int64))


# -------------------------------------------------------- property suite --
@given(st.lists(st.lists(st.integers(0, 7), min_size=0, max_size=14),
                min_size=1, max_size=6))
@example(files=[[1, 0, 0, 0, 1, 0]])
def test_invariants_after_every_append(files):
    """Full invariant set after EVERY append of a random stream (tiny
    vocab forces heavy rule formation)."""
    inc = IncrementalSequitur(vocab_size=8)
    so_far = []
    for f in files:
        arr = np.asarray(f, np.int64)
        inc.append_file(arr)
        so_far.append(arr)
        check_all(inc, so_far)


def _adversarial_streams(kind: str, rng):
    if kind == "repetitive":            # one motif tiled: maximal reuse
        phrase = rng.integers(0, 6, 4)
        return [np.tile(phrase, int(rng.integers(2, 6)))
                for _ in range(4)], 6
    if kind == "all_unique":            # no digram ever repeats
        return [np.arange(i * 20, i * 20 + 20, dtype=np.int64)
                for i in range(3)], 60
    if kind == "single_token":          # overlap chains ("aaaa...")
        return [np.zeros(int(rng.integers(1, 12)), np.int64)
                for _ in range(4)], 3
    if kind == "empty":                 # splitter-only files
        return [np.zeros(0, np.int64) for _ in range(3)], 5
    # mixed: empties interleaved with repetitive content
    phrase = rng.integers(0, 5, 5)
    return [np.zeros(0, np.int64), np.tile(phrase, 3),
            np.zeros(0, np.int64), np.tile(phrase, 4),
            phrase], 5


@pytest.mark.parametrize(
    "kind", ["repetitive", "all_unique", "single_token", "empty", "mixed"])
def test_adversarial_streams(kind, seeded_rng):
    files, vocab = _adversarial_streams(kind, seeded_rng)
    inc = IncrementalSequitur(vocab)
    for i, f in enumerate(files):
        inc.append_file(f)
        check_all(inc, files[:i + 1])
    # and the corpus-level append path stays bit-exact on these too
    appended = CompressedCorpus.build(files[:2], vocab).append_files(
        files[2:])
    _corpora_equal(appended, CompressedCorpus.build(files, vocab))


# ------------------------------------------------------------ epoch guard --
def test_append_bumps_epoch_and_invalidates_memos(seeded_rng):
    files = make_repetitive_files(seeded_rng, VOCAB, n_files=2)
    tail = make_repetitive_files(seeded_rng, VOCAB, n_files=1)
    corpus = CompressedCorpus.build(files, VOCAB)
    w0 = corpus.top_down_weights()
    assert corpus.cached_weight_keys() == (("top_down", "frontier"),)
    corpus.append_files(tail)
    assert corpus.epoch == 1 and corpus.stats()["epoch"] == 1
    assert corpus.cached_weight_keys() == ()
    w1 = corpus.top_down_weights()
    fresh = CompressedCorpus.build(files + tail, VOCAB).top_down_weights()
    np.testing.assert_array_equal(np.asarray(w1), np.asarray(fresh))
    assert np.asarray(w0).shape != np.asarray(w1).shape or \
        not np.array_equal(np.asarray(w0), np.asarray(w1))


def test_poisoned_stale_memo_is_never_returned(seeded_rng):
    """The memo check happens on READ: even if invalidation-on-append were
    lost, a stale-stamped entry must be recomputed, not served."""
    files = make_repetitive_files(seeded_rng, VOCAB, n_files=2)
    corpus = CompressedCorpus.build(files, VOCAB)
    poison = object()
    for key in (("top_down", "frontier"), ("per_file", "frontier")):
        corpus._weights_cache[key] = (corpus.epoch - 1, poison)
    assert corpus.top_down_weights() is not poison
    assert corpus.per_file_weights() is not poison
    # current-epoch entries DO serve (the memo still memoizes)
    w = corpus.top_down_weights()
    assert corpus.top_down_weights() is w


def test_check_epoch_raises_on_stale(seeded_rng):
    files = make_repetitive_files(seeded_rng, VOCAB, n_files=2)
    corpus = CompressedCorpus.build(files, VOCAB)
    corpus.check_epoch(0)
    corpus.append_files(make_repetitive_files(seeded_rng, VOCAB, n_files=1))
    with pytest.raises(StaleGrammarError, match="epoch"):
        corpus.check_epoch(0)
    corpus.check_epoch(1)


def test_grammar_batch_epoch_stamp(seeded_rng):
    gas = [CompressedCorpus.build(
        make_repetitive_files(seeded_rng, VOCAB, n_files=2), VOCAB).ga
        for _ in range(2)]
    gb = GrammarBatch.build(gas, epochs=(0, 3))
    gb.check_epochs((0, 3))
    with pytest.raises(StaleGrammarError, match="row 1"):
        gb.check_epochs((0, 4))
    # padded pack: current may be shorter (prefix = the real rows)
    gb.check_epochs((0,))
    with pytest.raises(StaleGrammarError, match="stamped with"):
        gb.check_epochs((0, 3, 0))
    # unstamped packs (no ingest tier in play) never raise
    GrammarBatch.build(gas).check_epochs((7, 7))
    with pytest.raises(ValueError, match="epochs"):
        GrammarBatch.build(gas, epochs=(0,))


# --------------------------------------------------------------- serving --
#: Per-kind query parameters for the mid-ingest serving tests: one
#: representative of each parameter family (plain analytics, search, and
#: the three query operators — every pack-cache flavor must refresh).
_INGEST_QUERY_PARAMS = {
    "word_count": {},
    "search_bm25": dict(terms=(1, 2, 3)),
    "filter_count": dict(predicate=("or", (("and", (("term", 1, 1),
                                                    ("term", 2, 1))),
                                           ("term", 3, 2)))),
    "agg_terms": dict(terms=(1, 2, 2, 50), agg="max"),
    "phrase_count": dict(terms=(1, 2)),
}


def _ingest_query(corpus: str, kind: str) -> Query:
    return Query(corpus=corpus, kind=kind, **_INGEST_QUERY_PARAMS[kind])


def _expected_single(files, vocab, q: Query):
    srv = AnalyticsServer()
    srv.register(q.corpus, CompressedCorpus.build(files, vocab))
    return srv.run([q])[0]


def _assert_results_equal(got, want):
    """Bit-exact result equality over whatever shape a kind returns
    (arrays, or tuples/lists of arrays for the search kinds)."""
    if isinstance(got, (tuple, list)):
        assert isinstance(want, (tuple, list)) and len(got) == len(want)
        for x, y in zip(got, want):
            _assert_results_equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("kind", list(_INGEST_QUERY_PARAMS))
def test_server_serves_post_append_data(kind, seeded_rng):
    files = make_repetitive_files(seeded_rng, VOCAB, n_files=2)
    tail = make_repetitive_files(seeded_rng, VOCAB, n_files=2)
    store = CompressedCorpus.build(list(files), VOCAB)
    srv = AnalyticsServer()
    srv.register("c", store)
    q = _ingest_query("c", kind)
    srv.run([q])                         # warm every memo/pack layer
    store.append_files(tail)
    got = srv.run([q])[0]
    _assert_results_equal(got, _expected_single(files + tail, VOCAB, q))
    assert srv.stats.epoch_invalidations >= 1


def test_server_batched_path_refreshes(seeded_rng):
    files_a = make_repetitive_files(seeded_rng, VOCAB, n_files=2)
    files_b = make_repetitive_files(seeded_rng, VOCAB, n_files=2)
    tail = make_repetitive_files(seeded_rng, VOCAB, n_files=1)
    store_a = CompressedCorpus.build(list(files_a), VOCAB)
    srv = AnalyticsServer()
    srv.register("a", store_a)
    srv.register("b", CompressedCorpus.build(files_b, VOCAB))
    qs = [Query(corpus="a", kind="word_count"),
          Query(corpus="b", kind="word_count")]
    srv.run(qs)                          # populates the pack cache
    assert srv._batches
    store_a.append_files(tail)
    got = srv.run(qs)
    _assert_results_equal(
        got[0],
        _expected_single(files_a + tail, VOCAB,
                         Query(corpus="a", kind="word_count")))
    _assert_results_equal(
        got[1], _expected_single(files_b, VOCAB,
                                 Query(corpus="b", kind="word_count")))


@pytest.mark.parametrize("kind", ["word_count", "filter_count"])
def test_stale_pack_reinserted_into_cache_is_detected(kind, seeded_rng):
    """Attack the pack-cache layer directly: plant a pre-append pack back
    into the cache (simulating a lost purge).  The epoch stamp on the
    cached pack must flag it as a miss — the stale pack cannot serve.
    Query-kind packs ride the same cache, so the attack covers them."""
    files_a = make_repetitive_files(seeded_rng, VOCAB, n_files=2)
    files_b = make_repetitive_files(seeded_rng, VOCAB, n_files=2)
    store_a = CompressedCorpus.build(list(files_a), VOCAB)
    srv = AnalyticsServer()
    srv.register("a", store_a)
    srv.register("b", CompressedCorpus.build(files_b, VOCAB))
    qs = [_ingest_query("a", kind), _ingest_query("b", kind)]
    srv.run(qs)
    stale_pack = next(iter(srv._batches.values()))
    assert stale_pack.epochs is not None
    tail = make_repetitive_files(seeded_rng, VOCAB, n_files=1)
    store_a.append_files(tail)
    srv.run(qs)                          # refresh purges + rebuilds
    # the lost-purge scenario: overwrite the fresh pack (under whatever
    # key the post-append chunking uses) with the pre-append pack
    key = next(k for k in srv._batches if "a" in k[0])
    srv._batches[key] = stale_pack
    before = srv.stats.epoch_invalidations
    got = srv.run(qs)
    assert srv.stats.epoch_invalidations > before
    assert srv._batches[key] is not stale_pack
    _assert_results_equal(
        got[0], _expected_single(files_a + tail, VOCAB,
                                 _ingest_query("a", kind)))


@pytest.mark.parametrize(
    "kind", ["word_count", "filter_count", "agg_terms", "phrase_count"])
def test_queue_submit_append_drain_serves_fresh(kind, seeded_rng):
    """A query queued BEFORE an append must serve post-append data at
    flush time (the flush-time refresh in execute_chunk) — for the plain
    analytics and every query-operator kind."""
    files = make_repetitive_files(seeded_rng, VOCAB, n_files=2)
    tail = make_repetitive_files(seeded_rng, VOCAB, n_files=1)
    store = CompressedCorpus.build(list(files), VOCAB)
    srv = AnalyticsServer()
    srv.register("c", store)
    aq = AsyncAnalyticsServer(srv, max_wait=60.0)
    fut = aq.submit(_ingest_query("c", kind))
    store.append_files(tail)             # mutation lands while queued
    aq.drain()
    _assert_results_equal(
        fut.result(timeout=30),
        _expected_single(files + tail, VOCAB, _ingest_query("c", kind)))


# ------------------------------------------------------------ save / load --
def test_save_load_append_resumes_bit_exact(tmp_path, seeded_rng):
    """A corpus restored from disk (no live compressor state) replays its
    stream on the first append and continues bit-identically."""
    base = make_repetitive_files(seeded_rng, VOCAB, n_files=2)
    t1 = make_repetitive_files(seeded_rng, VOCAB, n_files=1)
    t2 = make_repetitive_files(seeded_rng, VOCAB, n_files=2)
    corpus = CompressedCorpus.build(base, VOCAB).append_files(t1)
    path = str(tmp_path / "c.npz")
    corpus.save(path)
    loaded = CompressedCorpus.load(path)
    assert loaded.epoch == 1 and loaded._sq is None
    _corpora_equal(loaded, corpus)
    loaded.append_files(t2)              # replay, then true append
    corpus.append_files(t2)              # live state, no replay
    assert loaded.epoch == corpus.epoch == 2
    _corpora_equal(loaded, corpus)
    _corpora_equal(loaded, CompressedCorpus.build(base + t1 + t2, VOCAB))


# ------------------------------------------------- deep-grammar regression --
def test_expand_survives_deep_chain_grammar():
    """Sequitur-built grammars are log-deep, but expand() must not assume
    that: a 3000-deep chain killed the old recursive form (RecursionError)
    long before Python's default limit in frames-per-level terms."""
    depth = 3000
    nt = 2
    rules = [np.array([0, nt + i + 1, 1], np.int64) for i in range(depth)]
    rules.append(np.array([0, 1], np.int64))
    g = Grammar(num_terminals=nt, rules=rules)
    out = g.expand(0)
    want = np.concatenate([np.zeros(depth + 1, np.int64),
                           np.ones(depth + 1, np.int64)])
    np.testing.assert_array_equal(out, want)


# ------------------------------------------------------- nightly fuzz lane --
@pytest.mark.slow
@pytest.mark.ingest_fuzz
@settings(max_examples=int(os.environ.get("INGEST_FUZZ_EXAMPLES", "200")),
          deadline=None)
@given(st.lists(st.lists(st.integers(0, 5), min_size=0, max_size=40),
                min_size=1, max_size=10))
@example(files=[[0, 1, 1, 1, 0, 1]])
def test_ingest_fuzz(files):
    """Nightly lane: many more examples (INGEST_FUZZ_EXAMPLES), invariants
    after every append AND corpus-level bit-exactness per stream."""
    vocab = 6
    inc = IncrementalSequitur(vocab)
    so_far = []
    for f in files:
        arr = np.asarray(f, np.int64)
        inc.append_file(arr)
        so_far.append(arr)
        check_all(inc, so_far)
    if len(so_far) >= 2:
        appended = CompressedCorpus.build(so_far[:1], vocab).append_files(
            so_far[1:])
        _corpora_equal(appended, CompressedCorpus.build(so_far, vocab))
