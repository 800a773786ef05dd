"""Composable query operators (repro/query): algebra, frontend, serving.

Four enforcement layers on top of the differential suite's bit-equality
checks (test_differential.py):

* **operator algebra** — property-fuzzed invariants any correct filter /
  aggregate / phrase implementation must satisfy, checked on the ENGINE's
  outputs (so an engine bug cannot hide behind a matching oracle bug):
  AND == set intersection of its conjuncts, OR == set union, sequential
  filter refinement == the combined AND filter, aggregation is linear
  (sum) / idempotent-monotone (max) over term-set concatenation, and a
  phrase can never occur more often than its rarest unigram;
* **predicate IR** — canonicalization, validation errors, leaf/structure
  split (the jit-static sharing contract);
* **text frontend** — parsing, AND-over-OR precedence, and the
  never-mutate-the-vocab rule for unknown words;
* **serving normalization** — the regression family from the PR 5
  ``effective_l`` bug, extended to the query tier: inert parameters can
  neither split a group nor mis-share one, and ``execute_chunk`` rejects
  non-normalized parameter combinations loudly.

Runs without hypothesis via tests/_hypothesis_compat.  ``test_query_fuzz``
rescales the algebra suite with QUERY_FUZZ_EXAMPLES: 16 examples in an
unfiltered run, 500 in the nightly ``query_fuzz`` lane.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from _hypothesis_compat import given, settings, st
from _oracle import (assert_result_equal, full_stream, oracle_query,
                     oracle_term_vector, oracle_word_count, stream_segments)
from conftest import make_repetitive_files

from repro.core import GrammarBatch, compress_files, flatten
from repro.data.tokenizer import UNK, Tokenizer
from repro.query import (agg_corpus, and_, filter_corpus, lookup_term,
                         normalize_agg, normalize_phrase,
                         normalize_predicate, or_, phrase_corpus,
                         phrase_from_text, predicate_from_text,
                         predicate_leaves, predicate_mask,
                         predicate_structure, query_corpus,
                         run_batched_query, term_pred, terms_from_text)
from repro.serving import AnalyticsServer, Query


# ----------------------------------------------------------- generators --
def _grammar(rng, scale: int = 1):
    vocab = int(rng.integers(8, 30 * scale + 10))
    n_files = int(rng.integers(1, 4 + scale))
    files = make_repetitive_files(rng, vocab, n_files=n_files)
    g, nf = compress_files(files, vocab)
    return flatten(g, vocab, nf)


def _rand_pred(rng, vocab, depth: int = 0):
    """Random AND/OR tree; leaves may be out-of-vocab (zero column)."""
    if depth >= 2 or rng.random() < 0.5:
        return ("term", int(rng.integers(0, vocab + 4)),
                int(rng.integers(0, 4)))
    op = "and" if rng.random() < 0.5 else "or"
    return (op, tuple(_rand_pred(rng, vocab, depth + 1)
                      for _ in range(int(rng.integers(1, 4)))))


def _rand_terms(rng, vocab):
    nt = int(rng.integers(1, 6))
    return tuple(int(t) for t in rng.integers(0, vocab + 3, nt))


def _present_phrase(rng, ga, stream):
    """A window actually present in the corpus when one exists, else a
    random (usually absent) tuple."""
    l = int(rng.integers(2, 5))
    segs = [s for s in stream_segments(ga, stream) if len(s) >= l]
    if segs:
        seg = segs[int(rng.integers(0, len(segs)))]
        start = int(rng.integers(0, len(seg) - l + 1))
        return tuple(int(x) for x in seg[start: start + l])
    return tuple(int(t) for t in rng.integers(0, ga.vocab_size, l))


def _check_algebra(rng, ga, stream):
    """The full algebra suite on one corpus — shared by the fast property
    lane and the nightly query_fuzz lane."""
    vocab = ga.vocab_size
    a = _rand_pred(rng, vocab)
    b = _rand_pred(rng, vocab)
    fa = filter_corpus(ga, a)
    fb = filter_corpus(ga, b)
    # AND == intersection, OR == union (engine output set algebra)
    np.testing.assert_array_equal(
        filter_corpus(ga, and_(a, b)), np.intersect1d(fa, fb))
    np.testing.assert_array_equal(
        filter_corpus(ga, or_(a, b)),
        np.union1d(fa, fb).astype(np.int32))
    # sequential refinement (filter b applied to filter a's survivors)
    # == the combined AND filter
    tv = oracle_term_vector(ga, stream)
    refined = fa[predicate_mask(b, tv)[fa]] if len(fa) else fa
    np.testing.assert_array_equal(filter_corpus(ga, and_(a, b)), refined)
    # aggregation: sum is linear over term-set concatenation, max is the
    # elementwise max — totals follow (exact: integer-valued float32)
    t1, t2 = _rand_terms(rng, vocab), _rand_terms(rng, vocab)
    pf1, tot1 = agg_corpus(ga, t1, "sum")
    pf2, tot2 = agg_corpus(ga, t2, "sum")
    pf12, tot12 = agg_corpus(ga, t1 + t2, "sum")
    np.testing.assert_array_equal(pf12, pf1 + pf2)
    assert tot12 == np.float32(tot1 + tot2)
    mf1, mt1 = agg_corpus(ga, t1, "max")
    mf2, mt2 = agg_corpus(ga, t2, "max")
    mf12, mt12 = agg_corpus(ga, t1 + t2, "max")
    np.testing.assert_array_equal(mf12, np.maximum(mf1, mf2))
    assert mt12 == max(mt1, mt2)
    # a phrase occurs at most as often as its rarest unigram
    phrase = _present_phrase(rng, ga, stream)
    count = phrase_corpus(ga, phrase)
    wc = oracle_word_count(ga, stream)
    unigram_min = min(
        float(wc[t]) if t < vocab else 0.0 for t in phrase)
    assert float(count) <= unigram_min, (phrase, count, unigram_min)
    # and every engine result above is the oracle's result
    for kind, kw in (("filter_count", dict(predicate=and_(a, b))),
                     ("agg_terms", dict(terms=t1 + t2, agg="max")),
                     ("phrase_count", dict(terms=phrase))):
        assert_result_equal(query_corpus(ga, kind, **kw),
                            oracle_query(ga, kind, stream=stream, **kw),
                            kind, "(algebra suite)")


# ------------------------------------------------------ operator algebra --
@settings(max_examples=6, deadline=None)
@given(st.integers(0, 100_000))
def test_operator_algebra(seed):
    rng = np.random.default_rng(seed)
    ga = _grammar(rng)
    _check_algebra(rng, ga, full_stream(ga))


@settings(max_examples=4, deadline=None)
@given(st.integers(0, 100_000))
def test_batched_operator_algebra(seed):
    """The same set-algebra identities hold row-wise on a batched pack
    (AND/OR composition must not leak across corpus rows)."""
    rng = np.random.default_rng(seed)
    gas = [_grammar(rng) for _ in range(3)]
    gb = GrammarBatch.build(gas)
    vocab = max(ga.vocab_size for ga in gas)
    a, b = _rand_pred(rng, vocab), _rand_pred(rng, vocab)
    fa = run_batched_query(gb, "filter_count", predicate=a)
    fb = run_batched_query(gb, "filter_count", predicate=b)
    fand = run_batched_query(gb, "filter_count", predicate=and_(a, b))
    f_or = run_batched_query(gb, "filter_count", predicate=or_(a, b))
    for i in range(len(gas)):
        np.testing.assert_array_equal(fand[i], np.intersect1d(fa[i], fb[i]))
        np.testing.assert_array_equal(
            f_or[i], np.union1d(fa[i], fb[i]).astype(np.int32))


# ----------------------------------------------------------- predicate IR --
def test_normalize_predicate_canonicalizes():
    raw = ["or", (["term", np.int64(3), 2.0], ("and", [["term", 1, 1]]))]
    want = ("or", (("term", 3, 2), ("and", (("term", 1, 1),))))
    assert normalize_predicate(raw) == want
    assert normalize_predicate(want) == want          # idempotent
    assert term_pred(5) == ("term", 5, 1)
    assert and_(term_pred(1), term_pred(2, 3)) == \
        ("and", (("term", 1, 1), ("term", 2, 3)))
    assert or_(term_pred(1)) == ("or", (("term", 1, 1),))


@pytest.mark.parametrize("bad", [
    None, (), ("term", 1), ("term", -1, 1), ("term", 1, -1),
    ("and", ()), ("or", ()), ("and", 3), ("xor", (("term", 1, 1),)),
    ("term", 1, 1, 1), 7,
])
def test_normalize_predicate_rejects(bad):
    with pytest.raises(ValueError):
        normalize_predicate(bad)


def test_predicate_leaf_structure_split():
    pred = or_(and_(term_pred(4, 2), term_pred(9)), term_pred(0, 5))
    assert predicate_leaves(pred) == [(4, 2), (9, 1), (0, 5)]
    structure = predicate_structure(pred)
    assert structure == ("or", (("and", (("leaf", 0), ("leaf", 1))),
                                ("leaf", 2)))
    # different terms/thresholds, same shape -> same structure (the jit
    # static): one compiled filter program serves both
    other = or_(and_(term_pred(1, 7), term_pred(2)), term_pred(3))
    assert predicate_structure(other) == structure
    assert hash(structure) == hash(predicate_structure(other))


def test_normalize_agg_and_phrase():
    assert normalize_agg(None) == "sum"
    assert normalize_agg("max") == "max"
    with pytest.raises(ValueError, match="aggregation"):
        normalize_agg("avg")
    assert normalize_phrase([np.int64(3), 4]) == (3, 4)
    for bad in (None, (7,), (3, -1)):
        with pytest.raises(ValueError):
            normalize_phrase(bad)


# ----------------------------------------------------------- text frontend --
def _tok():
    return Tokenizer.build(["the cat sat on the mat",
                            "the dog sat on the cat"])


def test_frontend_lookup_never_mutates():
    tok = _tok()
    before = dict(tok.word_to_id)
    assert lookup_term(tok, "cat") == tok.word_to_id["cat"]
    assert lookup_term(tok, "zebra") == UNK
    # even on an UNFROZEN tokenizer a query lookup must not grow the vocab
    tok.frozen = False
    assert lookup_term(tok, "zebra") == UNK
    assert phrase_from_text(tok, "zebra crossing") == (UNK, UNK)
    assert tok.word_to_id == before and tok.vocab_size == len(before)


def test_frontend_terms_and_phrase():
    tok = _tok()
    cat, dog, sat = (tok.word_to_id[w] for w in ("cat", "dog", "sat"))
    assert terms_from_text(tok, "cat dog cat") == (cat, dog, cat)
    assert phrase_from_text(tok, "dog sat") == (dog, sat)
    with pytest.raises(ValueError, match="no words"):
        terms_from_text(tok, "  ")
    with pytest.raises(ValueError, match="at least 2"):
        phrase_from_text(tok, "cat")


def test_frontend_predicate_parsing():
    tok = _tok()
    cat, dog, mat = (tok.word_to_id[w] for w in ("cat", "dog", "mat"))
    assert predicate_from_text(tok, "cat") == ("term", cat, 1)
    assert predicate_from_text(tok, "cat >= 3") == ("term", cat, 3)
    # AND binds tighter than OR
    assert predicate_from_text(tok, "cat AND dog >= 2 OR mat") == \
        ("or", (("and", (("term", cat, 1), ("term", dog, 2))),
                ("term", mat, 1)))
    # parens override precedence
    assert predicate_from_text(tok, "cat AND (dog OR mat)") == \
        ("and", (("term", cat, 1),
                 ("or", (("term", dog, 1), ("term", mat, 1)))))
    assert predicate_from_text(tok, "zebra") == ("term", UNK, 1)
    for bad in ("(cat", "cat)", "cat >= dog", "cat AND", "AND cat",
                "cat dog", ""):
        with pytest.raises(ValueError):
            predicate_from_text(tok, bad)


def test_frontend_to_engine_roundtrip(seeded_rng):
    """Text in, correct files out: encode a tiny text corpus, query it
    through the frontend, check against a plain python scan."""
    texts = ["the cat sat on the mat", "the dog ate the cat food",
             "mat mat mat", "the dog sat"]
    tok = Tokenizer.build(texts)
    files = [tok.encode(t) for t in texts]
    g, nf = compress_files(files, tok.vocab_size)
    ga = flatten(g, tok.vocab_size, nf)
    pred = predicate_from_text(tok, "cat AND the >= 2 OR mat >= 3")
    want = [i for i, t in enumerate(texts)
            if ("cat" in t.split() and t.split().count("the") >= 2)
            or t.split().count("mat") >= 3]
    np.testing.assert_array_equal(filter_corpus(ga, pred), want)
    phrase = phrase_from_text(tok, "the cat")
    want_n = sum(" ".join(t.split()).count("the cat") for t in texts)
    assert float(phrase_corpus(ga, phrase)) == float(want_n)


# -------------------------------------------------- serving normalization --
def test_group_key_nulls_inert_fields():
    """The PR 5 ``effective_l`` regression family, extended to the query
    tier: parameters a kind does not consume are normalized out of its
    group key — a stray value can neither split a group nor mis-share
    one."""
    plain = Query("c", "word_count")
    noisy = Query("c", "word_count", l=7, terms=(1, 2), k=5,
                  predicate=term_pred(1), agg="max")
    assert noisy.group_key() == plain.group_key()
    # kinds that DO consume a field always keep it
    p1, p2 = term_pred(1), term_pred(2)
    assert Query("c", "filter_count", predicate=p1).group_key() != \
        Query("c", "filter_count", predicate=p2).group_key()
    assert Query("c", "agg_terms", terms=(1, 2), agg="sum").group_key() != \
        Query("c", "agg_terms", terms=(1, 2), agg="max").group_key()
    # canonical defaults merge: omitted agg == explicit "sum"; predicate
    # lists canonicalize to the same tuples at construction
    assert Query("c", "agg_terms", terms=(1, 2)).group_key() == \
        Query("c", "agg_terms", terms=(1, 2), agg="sum").group_key()
    assert Query("c", "filter_count",
                 predicate=["and", [["term", 1, 1], ["term", 2, 2]]]
                 ).group_key() == \
        Query("c", "filter_count",
              predicate=and_(term_pred(1), term_pred(2, 2))).group_key()
    # inert-field nulling cannot leak ACROSS query kinds either
    assert Query("c", "filter_count", predicate=p1, agg="max").group_key() \
        == Query("c", "filter_count", predicate=p1).group_key()
    assert Query("c", "phrase_count", terms=(1, 2), k=9).group_key() == \
        Query("c", "phrase_count", terms=(1, 2)).group_key()


def test_server_validates_query_kinds(seeded_rng):
    srv = AnalyticsServer()
    srv.register("c", _grammar(seeded_rng))
    for bad in (Query("c", "filter_count"),                    # no predicate
                Query("c", "agg_terms"),                       # no terms
                Query("c", "agg_terms", terms=(1,), agg="avg"),
                Query("c", "phrase_count", terms=(1,))):       # 1-gram
        with pytest.raises(ValueError):
            srv.run([bad])
    with pytest.raises(ValueError):
        Query("c", "filter_count", predicate=("xor", ()))      # at __init__


def test_execute_chunk_rejects_unnormalized_params(seeded_rng):
    """``execute_chunk`` is the enforcement backstop below ``group_key``:
    a caller that bypasses ``Query.effective_*`` normalization (the PR 5
    bug shape) must fail loudly, not silently serve."""
    srv = AnalyticsServer()
    srv.register("c", _grammar(seeded_rng))
    bad_calls = [
        ("word_count", dict(terms=(1,))),
        ("word_count", dict(k=3)),
        ("word_count", dict(predicate=term_pred(1))),
        ("word_count", dict(agg="sum")),
        ("filter_count", dict()),                       # predicate required
        ("filter_count", dict(predicate=term_pred(1), agg="sum")),
        ("agg_terms", dict(terms=(1, 2), k=3)),
        ("agg_terms", dict(terms=(1, 2), agg="avg")),
        ("phrase_count", dict(terms=(7,))),
        ("phrase_count", dict(terms=(1, 2), predicate=term_pred(1))),
    ]
    for kind, kw in bad_calls:
        with pytest.raises(ValueError):
            srv.execute_chunk(kind, ["c"], **kw)


def test_server_serves_query_kinds(seeded_rng):
    """A mixed batch of query kinds through the real grouping path equals
    the single-corpus engine per query."""
    gas = {f"c{i}": _grammar(seeded_rng) for i in range(4)}
    srv = AnalyticsServer(max_batch=4)
    for name, ga in gas.items():
        srv.register(name, ga)
    pred = or_(and_(term_pred(1), term_pred(2)), term_pred(4, 2))
    qs = [Query(name, kind, **kw)
          for name in gas
          for kind, kw in (("filter_count", dict(predicate=pred)),
                           ("agg_terms", dict(terms=(1, 3, 3), agg="max")),
                           ("phrase_count", dict(terms=(1, 2))),
                           ("word_count", dict()))]
    for got, q in zip(srv.run(qs), qs):
        if q.kind == "word_count":
            continue
        want = query_corpus(gas[q.corpus], q.kind,
                            predicate=q.effective_predicate(),
                            terms=q.effective_terms(),
                            agg=q.effective_agg())
        assert_result_equal(got, want, q.kind, f"(server, {q.corpus})")
    assert srv.stats.batched_calls > 0


# ------------------------------------------------------- nightly fuzz lane --
@pytest.mark.slow
@pytest.mark.query_fuzz
@settings(max_examples=int(os.environ.get("QUERY_FUZZ_EXAMPLES", "16")),
          deadline=None)
@given(st.integers(0, 10_000_000))
def test_query_fuzz(seed):
    """Nightly lane: many more random grammars/predicates/phrases through
    the full algebra suite.  QUERY_FUZZ_EXAMPLES scales it: 16 examples in
    an unfiltered run, 500 in the nightly ``query_fuzz`` lane."""
    rng = np.random.default_rng(seed)
    ga = _grammar(rng)
    _check_algebra(rng, ga, full_stream(ga))
