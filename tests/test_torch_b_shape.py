"""Table II's dataset B shape through the port's server, on the CPU.

Dataset B (G-TADOC, Table II) is four long files compressed into one
grammar.  At a few tens of thousands of tokens this module builds such a
corpus with a skewed in-degree: one motif inside a thousand distinct
repeated phrases, so that one rule has about a thousand parents while the
median rule has one, and the dense in-edge plan is filled to about 0.1%.
``auto`` then sends every traversal to the COO ``frontier`` loop, as it
does the benchmark's ``b-wiki.analytics`` on the card.  The corpus is
compressed by the port's ``CompressedCorpus.build``, registered as a bare
``GrammarArrays`` on ``AnalyticsServer(method="auto")`` and served one
query at a time, which is the server's single-corpus branch (a cached
size-1 pack).  Every answer must be bit-equal to the decompress-then-scan
oracle (``tests/_oracle.py``) and to the JAX package's server, and the
explicit ``frontier_ell`` and ``frontier_fused`` give the same answers on
their own paths.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import compress_files as jcompress, flatten as jflatten
import repro.serving as js
import repro_torch.serving as ts
from repro_torch.core import GrammarArrays
from repro_torch.core.batch import ANALYTICS_KINDS, PER_FILE_KINDS
from repro_torch.data import CompressedCorpus

from _oracle import assert_result_equal, oracle

torch.set_num_threads(1)

FIELDS = [f.name for f in dataclasses.fields(GrammarArrays)]
PARAMS = {"sequence_count": {"l": 3}}


def b_shape_files(seed: int = 1, n_files: int = 4, n_phrases: int = 1000,
                  vocab: int = 6000):
    """Four long files (about 6,000 tokens each): every phrase holds the
    motif ``[0, 1]`` and appears twice; between phrases, Zipfian words and
    now and then two phrases back to back (nested repetition)."""
    rng = np.random.default_rng(seed)
    phrases = []
    for _ in range(n_phrases):
        body = rng.integers(2, vocab, int(rng.integers(4, 9)))
        at = int(rng.integers(1, len(body)))
        phrases.append(np.concatenate([body[:at], [0, 1], body[at:]]))
    files = [[] for _ in range(n_files)]
    uses = rng.permutation(np.repeat(np.arange(n_phrases), 2))
    for i, j in enumerate(uses):
        part = phrases[j]
        if rng.random() < 0.2:
            part = np.concatenate([part, phrases[uses[i - 1]]])
        files[i % n_files] += [part, np.minimum(
            rng.zipf(1.3, int(rng.integers(2, 8))) + 1, vocab - 1)]
    return [np.concatenate(f).astype(np.int64) for f in files], vocab


@pytest.fixture(scope="module")
def corpus():
    files, vocab = b_shape_files()
    ga = CompressedCorpus.build(files, vocab).ga
    grammar, n_files = jcompress(files, vocab)
    jga = jflatten(grammar, vocab, n_files)
    for name in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ga, name)),
                                      np.asarray(getattr(jga, name)),
                                      err_msg=name)
    return ga, jga


def _serve(srv, Q, kind):
    """One query of ``kind`` on the one corpus: (answer, query)."""
    q = Q("b", kind, **PARAMS.get(kind, {}))
    return srv.run([q])[0], q


def _traversals(q):
    return [(s.attrs["method"], s.attrs["per_file"])
            for s in q.trace.walk() if s.name == "traverse"]


def test_the_corpus_has_b_shape(corpus):
    ga, _ = corpus
    assert ga.num_files == 4
    indeg = np.asarray(ga.in_deg)[1:]
    assert indeg.max() >= 512 and np.median(indeg) == 1
    assert ga.num_levels >= 5


@pytest.mark.parametrize("kind", ANALYTICS_KINDS)
def test_single_corpus_path_equals_oracle_and_jax(corpus, kind):
    ga, jga = corpus
    srv = ts.AnalyticsServer(max_batch=16, method="auto", device="cpu")
    srv.register("b", ga)
    got, q = _serve(srv, ts.Query, kind)
    assert srv.stats.single_calls == 1 and srv.stats.batched_calls == 0
    # the skewed in-degree leaves the dense plan 0.1% full: auto takes
    # the COO frontier loop, scalar or per file
    assert _traversals(q) == [("frontier", kind in PER_FILE_KINDS)]
    assert_result_equal(got, oracle(jga, kind, l=3), kind)
    jsrv = js.AnalyticsServer(max_batch=16, method="auto", mesh=None)
    jsrv.register("b", jga)
    assert_result_equal(got, _serve(jsrv, js.Query, kind)[0], kind,
                        "against the JAX package's server")


@pytest.mark.parametrize("method", ["frontier_ell", "frontier_fused"])
def test_explicit_ell_methods_give_the_same_answers(corpus, method):
    ga, jga = corpus
    srv = ts.AnalyticsServer(max_batch=16, method=method, device="cpu")
    srv.register("b", ga)
    for kind in ANALYTICS_KINDS:
        got, q = _serve(srv, ts.Query, kind)
        per_file = kind in PER_FILE_KINDS
        # the fused kernel is scalar: per-file traversals take its
        # per-round ELL base
        want = "frontier_ell" if per_file else method
        assert _traversals(q) == [(want, per_file)], kind
        assert_result_equal(got, oracle(jga, kind, l=3), kind, method)
