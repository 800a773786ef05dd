"""The port's ranked retrieval against the JAX package and the oracle.

BM25 / TF-IDF scores are float32 and not integers, so the port is held to
the reference bit for bit, scores and tie orders included: the ranking
primitive ``masked_top_k`` against ``jax.lax.top_k``, ``batched_search``
on one pack and ``search_corpus`` on a ``GrammarArrays`` and on the port's
``CompressedCorpus``, under both schemes and every traversal method, with
k of 1, 3 and more than the file count, out-of-vocabulary and repeated
query terms, and duplicated files whose scores tie.  Grammars are carried
across with ``GrammarArrays.from_numpy``; every comparison is
``np.array_equal`` with equal dtypes.  Everything runs on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import GrammarBatch as JBatch
from repro.core import compress_files as jcompress, flatten as jflatten
from repro.data import CompressedCorpus as JCorpus
from repro.kernels.ops import masked_top_k as jmasked_top_k
from repro.search import batched_search as jbatched_search
from repro.search import search_corpus as jsearch_corpus
from repro_torch.core import GrammarArrays, GrammarBatch
from repro_torch.core import compress_files, flatten
from repro_torch.core.batch import METHODS
from repro_torch.data import CompressedCorpus
from repro_torch.kernels.ops import masked_top_k
from repro_torch.search import (SEARCH_KINDS, SCHEMES, batch_search_stats,
                                batched_search, build_search_index,
                                normalize_terms, search_corpus,
                                search_index_topk)

from _oracle import oracle_search, oracle_term_vector
from _torch_inputs import files_search
from conftest import make_repetitive_files

torch.set_num_threads(1)

FIELDS = [f.name for f in dataclasses.fields(GrammarArrays)]
VOCAB = (23, 40, 31)
N_FILES = (3, 4, 2)


def _corpora():
    """Three corpora's raw files; corpus 0 repeats a file and corpus 1 has
    two copies of one file, so some documents score exactly alike."""
    rng = np.random.default_rng(2024)
    out = []
    for v, nf in zip(VOCAB, N_FILES):
        files = make_repetitive_files(rng, v, n_files=nf)
        out.append(files)
    out[0] = out[0] + [out[0][1]]
    out[1] = out[1][:2] + [out[1][0]] + out[1][2:]
    return out


def _port(jga) -> GrammarArrays:
    return GrammarArrays.from_numpy({n: getattr(jga, n) for n in FIELDS})


@pytest.fixture(scope="module")
def world():
    """(raw files, JAX grammars, port grammars, JAX pack, port pack)."""
    files = _corpora()
    jgas = []
    for fs, v in zip(files, VOCAB):
        g, nf = jcompress(fs, v)
        jgas.append(jflatten(g, v, nf))
    tgas = [_port(ga) for ga in jgas]
    return (files, jgas, tgas, JBatch.build(jgas),
            GrammarBatch.build(tgas, device="cpu"))


def _queries(jgas):
    """Term lists: a common term, a rare one (a single file holds it, so
    zero-score ties fill the rest of the ranking), one out of every
    vocabulary, and a repeat."""
    df = (oracle_term_vector(jgas[0]) > 0).sum(axis=0)
    common = int(np.argmax(df))
    rare = int(np.flatnonzero(df == df[df > 0].min())[0])
    return [(common, rare, 10_000, common), (rare,), (common, 2, 3)]


def _same(got, want, what):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{what}[{i}]")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (what, g.dtype,
                                                       w.dtype, g.shape,
                                                       w.shape)
    assert np.array_equal(g, w), (what, g, w)


# ---------------------------------------------------------------- top-k --
@pytest.mark.parametrize("k", [1, 3, 8, 16])
def test_masked_top_k_matches_lax_top_k(k, seeded_rng):
    """Rows of many ties (values 0-3), masked slots, a row with every slot
    masked and one with none: values and indices equal ``lax.top_k``'s,
    ties toward the lower index."""
    scores = seeded_rng.integers(0, 4, (6, 16)).astype(np.float32)
    scores[1] *= np.float32(0.25)
    valid = seeded_rng.random((6, 16)) < 0.6
    valid[2] = False
    valid[3] = True
    got = masked_top_k(torch.from_numpy(scores), torch.from_numpy(valid), k)
    want = jmasked_top_k(jnp.asarray(scores), jnp.asarray(valid), k)
    _same(got[0].numpy(), np.asarray(want[0]), "values")
    _same(got[1].numpy(), np.asarray(want[1]), "indices")


def test_masked_top_k_rejects_bad_k():
    s = torch.zeros((2, 4))
    v = torch.ones((2, 4), dtype=torch.bool)
    with pytest.raises(ValueError, match="k >= 1"):
        masked_top_k(s, v, 0)
    with pytest.raises(ValueError, match="exceeds"):
        masked_top_k(s, v, 5)


# -------------------------------------------------------------- batched --
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_batched_search_matches_jax_and_oracle(world, scheme, method):
    files, jgas, _, jgb, tgb = world
    for terms in _queries(jgas):
        for k in (1, 3, max(N_FILES) + 3):
            got = batched_search(tgb, terms, k=k, scheme=scheme,
                                 method=method)
            want = jbatched_search(jgb, terms, k=k, scheme=scheme,
                                   method=method)
            assert len(got) == len(want) == len(jgas)
            for i, jga in enumerate(jgas):
                o_ids, o_sc = oracle_search(jga, terms, k=k, scheme=scheme)
                what = f"{scheme}/{method} corpus {i} terms {terms} k {k}"
                _same(got[i][0], want[i][0], what + " ids vs jax")
                _same(got[i][1], want[i][1], what + " scores vs jax")
                _same(got[i][0], o_ids, what + " ids vs oracle")
                _same(got[i][1], o_sc, what + " scores vs oracle")


def test_duplicated_files_tie_toward_the_lower_file_id(world):
    """Corpus 0's files 1 and 3 are copies: they score alike under any
    query, and the lower id ranks first."""
    _, _, _, _, tgb = world
    ids, sc = batched_search(tgb, (1, 2, 3), k=10, scheme="bm25")[0]
    pos = {int(f): j for j, f in enumerate(ids)}
    assert sc[pos[1]] == sc[pos[3]] and pos[1] < pos[3]


def test_batch_search_stats_memoized_on_pack(world):
    _, _, tgas, _, _ = world
    gb = GrammarBatch.build(tgas, device="cpu")
    st = batch_search_stats(gb, "frontier")
    assert batch_search_stats(gb, "auto") is st          # same base
    assert batch_search_stats(gb, "frontier_fused") is \
        batch_search_stats(gb, "frontier_ell")
    assert st.tv.shape == (gb.n, gb.F_pad, gb.V_pad)
    assert st.fvalid.sum(dim=1).tolist() == list(gb.num_files)


# -------------------------------------------------------- single corpus --
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("source", ["arrays", "store"])
def test_search_corpus_matches_jax_and_oracle(world, source, method):
    files, jgas, tgas, _, _ = world
    for i, (fs, v) in enumerate(zip(files, VOCAB)):
        if source == "store":
            t_src = CompressedCorpus.build(fs, v)
            j_src = JCorpus.build(fs, v)
        else:
            t_src, j_src = tgas[i], jgas[i]
        for terms in _queries(jgas):
            for scheme in SCHEMES:
                for k in (1, 3, len(fs) + 2):
                    got = search_corpus(t_src, terms, k=k, scheme=scheme,
                                        method=method, device="cpu")
                    want = jsearch_corpus(j_src, terms, k=k, scheme=scheme,
                                          method=method)
                    o_ids, o_sc = oracle_search(jgas[i], terms, k=k,
                                                scheme=scheme)
                    what = (f"{source}/{scheme}/{method} corpus {i} terms "
                            f"{terms} k {k}")
                    _same(got[0], want[0], what + " ids vs jax")
                    _same(got[1], want[1], what + " scores vs jax")
                    _same(got[0], o_ids, what + " ids vs oracle")
                    _same(got[1], o_sc, what + " scores vs oracle")


def test_store_memoizes_the_index_per_base_and_epoch(world):
    files = world[0][0]
    cc = CompressedCorpus.build(files, VOCAB[0])
    si = cc.search_index(device="cpu")
    assert cc.search_index("auto", device="cpu") is si
    assert ("search_index", "frontier", "cpu") in cc.cached_weight_keys()
    assert ("per_file", "frontier", "cpu") in cc.cached_weight_keys()
    si_ell = cc.search_index("frontier_ell", device="cpu")
    assert si_ell is not si
    assert cc.search_index("frontier_fused", device="cpu") is si_ell
    np.testing.assert_array_equal(si_ell.tf, si.tf)
    # the device copies of the index are memoized on it, per device
    search_index_topk(si, (1, 2), device="cpu")
    arrays = si._device_cache["cpu"]
    search_index_topk(si, (3,), device="cpu")
    assert si._device_cache["cpu"] is arrays
    # an append bumps the epoch: the next lookup rebuilds the index
    cc.append_files([files[0]])
    si2 = cc.search_index(device="cpu")
    assert si2 is not si and si2.n_docs == si.n_docs + 1
    jcc = JCorpus.build(files + [files[0]], VOCAB[0])
    for scheme in SCHEMES:
        got = search_corpus(cc, (1, 2, 5), k=10, scheme=scheme,
                            device="cpu")
        want = jsearch_corpus(jcc, (1, 2, 5), k=10, scheme=scheme)
        _same(got[0], want[0], f"{scheme} ids after append")
        _same(got[1], want[1], f"{scheme} scores after append")


def test_index_statistics_match_the_reference(world):
    _, jgas, tgas, _, _ = world
    from repro.search import build_search_index as jbuild
    for jga, tga in zip(jgas, tgas):
        got = build_search_index(tga, device="cpu")
        want = jbuild(jga)
        for name in ("tf", "dl", "df", "norm"):
            _same(getattr(got, name), getattr(want, name), name)
        assert got.avgdl == want.avgdl and got.n_docs == want.n_docs
        _same(got.idf_for_terms((1, 99, 2), "bm25"),
              want.idf_for_terms((1, 99, 2), "bm25"), "idf")


def test_zero_file_corpus_ranks_empty():
    g, nf = compress_files([], 10)
    ga = flatten(g, 10, nf)
    ids, sc = search_corpus(ga, (1, 2), k=3, device="cpu")
    assert ids.shape == (0,) and sc.shape == (0,)
    got = batched_search(GrammarBatch.build([ga], device="cpu"), (1, 2), k=3)
    assert got[0][0].shape == (0,) and got[0][1].shape == (0,)


def test_search_validation():
    assert SEARCH_KINDS == ("search_bm25", "search_tfidf")
    assert normalize_terms([3, 1, 3]) == (3, 1, 3)
    for bad in (None, [], [-1]):
        with pytest.raises(ValueError):
            normalize_terms(bad)
    g, nf = compress_files([np.array([1, 2, 1, 2, 3])], 4)
    ga = flatten(g, 4, nf)
    with pytest.raises(ValueError, match="k >= 1"):
        search_corpus(ga, (1,), k=0, device="cpu")
    with pytest.raises(ValueError, match="scheme"):
        search_corpus(ga, (1,), scheme="bm42", device="cpu")


def test_raw_file_oracle_of_the_card_suite_agrees(world):
    """The card suite's numpy oracle over the raw files (it imports no JAX)
    gives ``tests/_oracle.py``'s rankings and scores bit for bit."""
    files, jgas = world[0], world[1]
    for fs, v, jga in zip(files, VOCAB, jgas):
        for terms in _queries(jgas):
            for scheme in SCHEMES:
                for k in (1, 4, 10):
                    _same(files_search(fs, v, terms, k, scheme),
                          oracle_search(jga, terms, k=k, scheme=scheme),
                          f"{scheme} {terms} {k}")
