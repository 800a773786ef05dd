"""The port's query operators against the JAX package and the oracle.

``filter_count``, ``agg_terms`` (sum and max) and ``phrase_count``,
batched over one pack and single-corpus on a ``GrammarArrays`` and on the
port's ``CompressedCorpus``, under every traversal method, in the shapes
of ``tests/test_query.py``: random AND/OR predicates with out-of-vocabulary
leaves, term sets with repeats, phrases present in the corpus and absent
from it.  Every result is compared with ``np.array_equal`` (equal dtypes)
against ``repro.query`` and against ``tests/_oracle.py``.  The predicate IR
and the text frontend must parse and canonicalize exactly as the JAX
package's do.  Everything runs on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import GrammarBatch as JBatch
from repro.core import compress_files as jcompress, flatten as jflatten
from repro.data import CompressedCorpus as JCorpus
from repro.data.tokenizer import Tokenizer as JTokenizer
import repro.query as jq
from repro_torch.core import GrammarArrays, GrammarBatch
from repro_torch.core.batch import METHODS
from repro_torch.data import CompressedCorpus, Tokenizer
from repro_torch.data.tokenizer import UNK
import repro_torch.query as tq

from _oracle import full_stream, oracle_query, stream_segments
from _torch_inputs import files_agg, files_filter, files_phrase
from conftest import make_repetitive_files

torch.set_num_threads(1)

FIELDS = [f.name for f in dataclasses.fields(GrammarArrays)]


def _corpora(seed: int = 77, n: int = 3):
    """(files, vocab) of ``n`` small corpora (vocab <= 48, 1-4 files)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        vocab = int(rng.integers(8, 48))
        files = make_repetitive_files(rng, vocab,
                                      n_files=int(rng.integers(1, 5)))
        out.append((files, vocab))
    return out


def _rand_pred(rng, vocab, depth: int = 0):
    """Random AND/OR tree; leaves may be out-of-vocab (zero column)."""
    if depth >= 2 or rng.random() < 0.5:
        return ("term", int(rng.integers(0, vocab + 4)),
                int(rng.integers(0, 4)))
    op = "and" if rng.random() < 0.5 else "or"
    return (op, tuple(_rand_pred(rng, vocab, depth + 1)
                      for _ in range(int(rng.integers(1, 4)))))


def _rand_terms(rng, vocab):
    return tuple(int(t) for t in rng.integers(0, vocab + 3,
                                              int(rng.integers(1, 6))))


def _present_phrase(rng, ga, l):
    """A window present in corpus ``ga`` (one of its longest segments)."""
    segs = [s for s in stream_segments(ga) if len(s) >= l]
    seg = segs[int(rng.integers(0, len(segs)))]
    start = int(rng.integers(0, len(seg) - l + 1))
    return tuple(int(x) for x in seg[start: start + l])


@pytest.fixture(scope="module")
def world():
    """(corpora, JAX grammars, port grammars, JAX pack, port pack, the
    queries): predicates, agg term sets and phrases (two present, one
    absent) drawn from a fixed seed."""
    corpora = _corpora()
    jgas = []
    for files, v in corpora:
        g, nf = jcompress(files, v)
        jgas.append(jflatten(g, v, nf))
    tgas = [GrammarArrays.from_numpy({n: getattr(ga, n) for n in FIELDS})
            for ga in jgas]
    rng = np.random.default_rng(5)
    vocab = max(v for _, v in corpora)
    preds = [_rand_pred(rng, vocab) for _ in range(4)]
    preds.append(("or", (("term", 1, 1), ("and", (("term", 2, 2),
                                                  ("term", 3, 1))))))
    aggs = [_rand_terms(rng, vocab) for _ in range(3)]
    phrases = [_present_phrase(rng, jgas[0], 2),
               _present_phrase(rng, jgas[1], 3),
               (vocab + 1, 0, 1)]
    return (corpora, jgas, tgas, JBatch.build(jgas),
            GrammarBatch.build(tgas, device="cpu"),
            dict(preds=preds, aggs=aggs, phrases=phrases))


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


def _runs(q):
    """(kind, kwargs) of every query in the world."""
    out = [("filter_count", dict(predicate=p)) for p in q["preds"]]
    out += [("agg_terms", dict(terms=t, agg=op)) for t in q["aggs"]
            for op in ("sum", "max")]
    out += [("phrase_count", dict(terms=p)) for p in q["phrases"]]
    return out


# -------------------------------------------------------------- batched --
@pytest.mark.parametrize("method", METHODS)
def test_batched_queries_match_jax_and_oracle(world, method):
    _, jgas, _, jgb, tgb, q = world
    streams = [full_stream(ga) for ga in jgas]
    for kind, kw in _runs(q):
        got = tq.run_batched_query(tgb, kind, method=method, **kw)
        want = jq.run_batched_query(jgb, kind, method=method, **kw)
        assert len(got) == len(want) == len(jgas)
        for i, jga in enumerate(jgas):
            what = f"{kind}/{method} {kw} corpus {i}"
            _same(got[i], want[i], what + " vs jax")
            ow = oracle_query(jga, kind, stream=streams[i], **kw)
            _same(got[i], ow, what + " vs oracle")


def test_batched_entry_points(world):
    """The per-operator entry points give what the dispatcher gives."""
    _, _, _, _, tgb, q = world
    p, t, ph = q["preds"][-1], q["aggs"][0], q["phrases"][0]
    _same(tq.batched_filter(tgb, p),
          tq.run_batched_query(tgb, "filter_count", predicate=p), "filter")
    _same(tq.batched_agg(tgb, t, "max"),
          tq.run_batched_query(tgb, "agg_terms", terms=t, agg="max"), "agg")
    _same(tq.batched_phrase(tgb, ph),
          tq.run_batched_query(tgb, "phrase_count", terms=ph), "phrase")
    with pytest.raises(ValueError, match="unknown query kind"):
        tq.run_batched_query(tgb, "grep", terms=(1,))


# -------------------------------------------------------- single corpus --
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("source", ["arrays", "store"])
def test_single_queries_match_jax_and_oracle(world, source, method):
    corpora, jgas, tgas, _, _, q = world
    # two of the three corpora: the JAX package's single-corpus path
    # compiles anew for every corpus shape, and that is most of the time
    for i, (files, v) in enumerate(corpora[:2]):
        if source == "store":
            t_src = CompressedCorpus.build(files, v)
            j_src = JCorpus.build(files, v)
        else:
            t_src, j_src = tgas[i], jgas[i]
        stream = full_stream(jgas[i])
        for kind, kw in _runs(q):
            if source == "store" and kind == "phrase_count" and \
                    method == "auto":
                # a store memoizes weights per named traversal, and "auto"
                # names none: both packages refuse (the server maps "auto"
                # to "frontier" before it reaches a store)
                with pytest.raises(ValueError, match="auto"):
                    jq.query_corpus(j_src, kind, method=method, **kw)
                with pytest.raises(ValueError, match="auto"):
                    tq.query_corpus(t_src, kind, method=method,
                                    device="cpu", **kw)
                continue
            got = tq.query_corpus(t_src, kind, method=method, device="cpu",
                                  **kw)
            want = jq.query_corpus(j_src, kind, method=method, **kw)
            what = f"{source}/{kind}/{method} {kw} corpus {i}"
            _same(got, want, what + " vs jax")
            _same(got, oracle_query(jgas[i], kind, stream=stream, **kw),
                  what + " vs oracle")


def test_store_queries_reuse_the_memoized_weights(world):
    files, v = world[0][0]
    cc = CompressedCorpus.build(files, v)
    tq.filter_corpus(cc, ("term", 1, 1), device="cpu")
    tq.phrase_corpus(cc, (1, 2), device="cpu")
    keys = cc.cached_weight_keys()
    assert ("per_file", "frontier", "cpu") in keys
    assert ("top_down", "frontier", "cpu") in keys


# ----------------------------------------------------------- predicate IR --
def test_predicate_ir_matches_the_reference(world):
    q = world[5]
    for p in q["preds"]:
        assert tq.normalize_predicate(p) == jq.normalize_predicate(p)
        assert tq.predicate_leaves(p) == jq.predicate_leaves(p)
        assert tq.predicate_structure(p) == jq.predicate_structure(p)
    assert tq.and_(tq.term_pred(1), tq.term_pred(2, 3)) == \
        jq.and_(jq.term_pred(1), jq.term_pred(2, 3))
    assert tq.normalize_predicate(["or", [["term", 1.0, 2]]]) == \
        ("or", (("term", 1, 2),))
    assert tq.normalize_agg(None) == "sum"
    assert tq.normalize_phrase([4, 5]) == (4, 5)
    assert tq.QUERY_KINDS == jq.QUERY_KINDS and tq.AGG_OPS == jq.AGG_OPS


@pytest.mark.parametrize("bad", [
    ("term", -1, 1), ("term", 1, -1), ("and", ()), ("xor", (("term", 1,
                                                              1),)),
    ("term", 1), (), "term"])
def test_normalize_predicate_rejects(bad):
    with pytest.raises(ValueError):
        jq.normalize_predicate(bad)
    with pytest.raises(ValueError):
        tq.normalize_predicate(bad)


def test_query_validation():
    for bad in (None, (3,), (1, -2)):
        with pytest.raises(ValueError):
            tq.normalize_phrase(bad)
    with pytest.raises(ValueError):
        tq.normalize_agg("mean")
    g, nf = jcompress([np.array([1, 2, 1, 2, 3])], 4)
    ga = GrammarArrays.from_numpy({n: getattr(jflatten(g, 4, nf), n)
                                   for n in FIELDS})
    with pytest.raises(ValueError, match="non-empty"):
        tq.agg_corpus(ga, (), device="cpu")
    with pytest.raises(ValueError, match="negative"):
        tq.agg_corpus(ga, (1, -1), device="cpu")
    with pytest.raises(ValueError, match="unknown query kind"):
        tq.query_corpus(ga, "grep", terms=(1,), device="cpu")


# ----------------------------------------------------------- text frontend --
TEXTS = ["the cat sat on the mat", "the dog sat on the cat"]


def test_frontend_parses_like_the_reference():
    ttok, jtok = Tokenizer.build(TEXTS), JTokenizer.build(TEXTS)
    assert ttok.word_to_id == jtok.word_to_id
    for text in ("cat", "cat >= 3", "cat AND dog >= 2 OR mat",
                 "cat AND (dog OR mat)", "zebra", "(cat OR dog) AND the"):
        assert tq.predicate_from_text(ttok, text) == \
            jq.predicate_from_text(jtok, text)
    for text in ("cat dog cat", "zebra crossing", "the mat"):
        assert tq.terms_from_text(ttok, text) == \
            jq.terms_from_text(jtok, text)
        assert tq.phrase_from_text(ttok, text) == \
            jq.phrase_from_text(jtok, text)
    for bad in ("(cat", "cat)", "cat >= dog", "cat AND", "AND cat",
                "cat dog", ""):
        with pytest.raises(ValueError):
            jq.predicate_from_text(jtok, bad)
        with pytest.raises(ValueError):
            tq.predicate_from_text(ttok, bad)


def test_frontend_lookup_never_mutates():
    tok = Tokenizer.build(TEXTS)
    before = dict(tok.word_to_id)
    assert tq.lookup_term(tok, "cat") == tok.word_to_id["cat"]
    tok.frozen = False
    assert tq.lookup_term(tok, "zebra") == UNK
    assert tq.phrase_from_text(tok, "zebra crossing") == (UNK, UNK)
    assert tok.word_to_id == before


def test_frontend_to_engine_roundtrip():
    """Text in, files out, through the port's engine on a text corpus."""
    texts = ["the cat sat on the mat", "the dog ate the cat food",
             "mat mat mat", "the dog sat"]
    tok = Tokenizer.build(texts)
    cc = CompressedCorpus.build([tok.encode(t) for t in texts],
                                tok.vocab_size)
    pred = tq.predicate_from_text(tok, "cat AND the >= 2 OR mat >= 3")
    want = [i for i, t in enumerate(texts)
            if ("cat" in t.split() and t.split().count("the") >= 2)
            or t.split().count("mat") >= 3]
    np.testing.assert_array_equal(tq.filter_corpus(cc, pred, device="cpu"),
                                  want)
    phrase = tq.phrase_from_text(tok, "the cat")
    assert float(tq.phrase_corpus(cc, phrase, device="cpu")) == \
        float(sum(t.count("the cat") for t in texts))


def test_raw_file_oracle_of_the_card_suite_agrees(world):
    """The card suite's numpy oracle over the raw files (it imports no JAX)
    gives ``tests/_oracle.py``'s answers."""
    corpora, jgas, q = world[0], world[1], world[5]
    for (files, v), jga in zip(corpora, jgas):
        for p in q["preds"]:
            _same(files_filter(files, v, tq.normalize_predicate(p)),
                  oracle_query(jga, "filter_count", predicate=p), "filter")
        for t in q["aggs"]:
            for op in ("sum", "max"):
                _same(files_agg(files, v, t, op),
                      oracle_query(jga, "agg_terms", terms=t, agg=op),
                      "agg")
        for ph in q["phrases"]:
            _same(files_phrase(files, ph),
                  oracle_query(jga, "phrase_count", terms=ph), "phrase")
