"""The port's host layer and packed engine against the JAX package.

* Host layer: the port's Sequitur and ``flatten`` produce every
  ``GrammarArrays`` field of the JAX package's for the same files —
  including the two inputs pinned in ``.hypothesis/patches/`` on which the
  live digram index drops an overlapping run; the single-stream
  ``compress`` gives the JAX package's grammar rule for rule on the same
  inputs as one stream, and the symbol predicates agree.
* The slice as a whole: grammars carried across with
  ``GrammarArrays.from_numpy`` give, for all six analytics under all six
  traversal methods (and both word-count backends), results bit-equal to
  ``repro.core.batch.run_batched`` and to the decompress-then-scan oracle.

Everything runs on the CPU, so every kernel call takes its plain version.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import batch as jbatch
from repro.core.grammar import flatten as jflatten
from repro.core.sequitur import IncrementalSequitur as JIncremental
from repro.core.sequitur import compress as jcompress
from repro.core.sequitur import compress_files as jcompress_files
from repro_torch.core import batch as tbatch
from repro_torch.core import (GrammarArrays, GrammarBatch,
                              IncrementalSequitur, compress, compress_files,
                              flatten)

from _oracle import assert_result_equal, oracle
from _torch_inputs import corpus_files, ragged_corpora

torch.set_num_threads(1)

KINDS = jbatch.ANALYTICS_KINDS
METHODS = tbatch.METHODS
# the JAX package's backend name -> the port's
BACKENDS = {"jnp": "torch", "pallas": "kernel"}
FIELDS = [f.name for f in dataclasses.fields(GrammarArrays)]


def _fields(ga) -> dict:
    return {name: getattr(ga, name) for name in FIELDS}


def _assert_same(got, want, path=""):
    """Bit-equal, same dtypes and shapes, through lists and tuples."""
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype, (path, g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w, err_msg=path)


def _port_grammar(files, vocab):
    g, nf = compress_files(files, vocab)
    return flatten(g, vocab, nf)


def _jax_grammar(files, vocab):
    g, nf = jcompress_files(files, vocab)
    return jflatten(g, vocab, nf)


@pytest.fixture(scope="module")
def packs():
    """(JAX pack, port pack, JAX grammars) over one ragged corpus list."""
    jgas = [_jax_grammar(files, v) for files, v in ragged_corpora()]
    tgas = [GrammarArrays.from_numpy(_fields(ga)) for ga in jgas]
    return (jbatch.GrammarBatch.build(jgas),
            GrammarBatch.build(tgas, device="cpu"), jgas)


# ------------------------------------------------------------ host layer --
PINNED = [([[1, 0, 0, 0, 1, 0]], 8), ([[0, 1, 1, 1, 0, 1]], 6)]


def _host_cases():
    cases = [(files, v) for files, v in ragged_corpora(7)]
    rng = np.random.default_rng(11)
    phrase = rng.integers(0, 5, 4)
    cases.append(([np.tile(phrase, 6), np.tile(phrase, 3)[:-1]], 5))
    cases.append(([rng.integers(0, 3, 200) for _ in range(3)], 3))
    return [([np.asarray(f, np.int64) for f in files], v)
            for files, v in PINNED + cases]


@pytest.mark.parametrize("case", range(len(_host_cases())))
def test_sequitur_and_flatten_match_jax(case):
    files, vocab = _host_cases()[case]
    got, want = _port_grammar(files, vocab), _jax_grammar(files, vocab)
    for name in FIELDS:
        _assert_same(getattr(got, name), getattr(want, name), name)
    for k in (None, 64):
        _assert_same(got.in_edges_ell_dense(k), want.in_edges_ell_dense(k))
    _assert_same(got.level_edge_slices()[1], want.level_edge_slices()[1])
    assert got.level_edge_slices()[0] == want.level_edge_slices()[0]


def test_incremental_append_matches_jax(seeded_rng):
    """Appending file by file exports the JAX package's grammar after
    every append, and equals a from-scratch build."""
    files = corpus_files(seeded_rng, 12, 5, 60)
    inc, jinc = IncrementalSequitur(12), JIncremental(12)
    for f in files:
        inc.append_file(f)
        jinc.append_file(f)
        got, want = inc.export(), jinc.export()
        assert got.num_terminals == want.num_terminals
        _assert_same(got.rules, want.rules)
    g, _ = compress_files(files, 12)
    _assert_same(g.rules, inc.export().rules)


@pytest.mark.parametrize("case", range(len(_host_cases())))
def test_compress_matches_jax(case):
    """Each host case's files as one stream (the pinned inputs among
    them): the port's single-stream ``compress`` gives the JAX package's
    grammar rule for rule, bit for bit."""
    files, vocab = _host_cases()[case]
    stream = np.concatenate(files)
    got, want = compress(stream, vocab), jcompress(stream, vocab)
    assert got.num_terminals == want.num_terminals == vocab
    _assert_same(got.rules, want.rules)
    np.testing.assert_array_equal(got.expand(), stream)


@pytest.mark.parametrize("bad", [5, -1])
def test_compress_raises_on_an_out_of_range_token(bad):
    stream = np.array([0, 1, bad, 2])
    with pytest.raises(ValueError) as want:
        jcompress(stream, 5)
    with pytest.raises(ValueError) as got:
        compress(stream, 5)
    assert str(got.value) == str(want.value) == f"token {bad} outside [0, 5)"


@pytest.mark.parametrize("case", range(len(PINNED) + 2))
def test_symbol_predicates_match_jax(case):
    """``is_word``, ``is_splitter``, ``is_rule_sym`` and ``sym_rule`` of a
    flattened grammar on every symbol of its bodies and the range around
    them equal the JAX package's."""
    files, vocab = _host_cases()[case]
    want = _jax_grammar(files, vocab)
    got = GrammarArrays.from_numpy(_fields(want))
    top = want.num_terminals + want.num_rules
    for sym in (want.body, np.arange(-1, top + 2)):
        for name in ("is_word", "is_splitter", "is_rule_sym", "sym_rule"):
            _assert_same(getattr(got, name)(sym), getattr(want, name)(sym),
                         name)


def test_from_numpy_round_trip_and_validation(packs):
    _, _, jgas = packs
    ga = GrammarArrays.from_numpy(_fields(jgas[2]))
    for name in FIELDS:
        _assert_same(getattr(ga, name), getattr(jgas[2], name), name)
    with pytest.raises(ValueError, match="missing"):
        GrammarArrays.from_numpy({"vocab_size": 3})


# ------------------------------------------------------------------ pack --
def test_pack_matches_jax(packs):
    gb, tgb, _ = packs
    for name in ("R_pad", "E_pad", "T_pad", "F_pad", "V_pad", "Tf_pad",
                 "lv_slices"):
        assert getattr(tgb, name) == getattr(gb, name), name
    for name in ("edge_parent", "edge_child", "edge_freq", "edge_valid",
                 "in_deg", "root_seen", "tw_rule", "tw_word", "tw_cnt",
                 "fedge_file", "fedge_child", "fedge_freq", "fword_file",
                 "fword_word", "fword_cnt", "lv_parent", "lv_child",
                 "lv_freq"):
        np.testing.assert_array_equal(getattr(tgb, name).numpy(),
                                      np.asarray(getattr(gb, name)), name)
    src, freq, level, nl = tgb.ell_plan()
    jsrc, jfreq, jlevel, jnl = gb.ell_plan()
    _assert_same([src.numpy(), freq.numpy(), level.numpy()],
                 [np.asarray(jsrc), np.asarray(jfreq), np.asarray(jlevel)])
    assert nl == jnl


@pytest.mark.parametrize("per_file", [False, True])
def test_method_resolution_matches_jax(packs, per_file):
    gb, tgb, _ = packs
    resolved = [tbatch.resolve_batch_method(tgb, m, per_file=per_file)
                for m in METHODS]
    assert resolved == [jbatch.resolve_batch_method(gb, m, per_file=per_file)
                        for m in METHODS]
    # the pack is small enough that every explicit ELL method runs on the
    # plan (so the slice test below reaches the kernel modules)
    assert resolved[2:4] == ["frontier_ell", "leveled_ell"]


# ----------------------------------------------------------------- slice --
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kind", KINDS)
def test_run_batched_matches_jax_and_oracle(packs, kind, method):
    gb, tgb, jgas = packs
    got = tbatch.run_batched(tgb, kind, method)
    _assert_same(got, jbatch.run_batched(gb, kind, method), kind)
    for i, ga in enumerate(jgas):
        assert_result_equal(got[i], oracle(ga, kind), kind,
                            f"corpus {i} / {method}")


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kind", ["word_count", "sort"])
def test_kernel_backend_matches_jax(packs, kind, method):
    gb, tgb, _ = packs
    _assert_same(tbatch.run_batched(tgb, kind, method,
                                    backend=BACKENDS["pallas"]),
                 jbatch.run_batched(gb, kind, method, backend="pallas"))


@pytest.mark.parametrize("l", [2, 4])
def test_sequence_count_window_lengths(packs, l):
    gb, tgb, _ = packs
    _assert_same(tbatch.batched_sequence_count(tgb, l=l, method="leveled"),
                 jbatch.batched_sequence_count(gb, l=l, method="leveled"))


def test_bad_requests_raise(packs):
    _, tgb, _ = packs
    with pytest.raises(ValueError, match="backend"):
        tbatch.run_batched(tgb, "word_count", backend="pallas")
    with pytest.raises(ValueError, match="kind"):
        tbatch.run_batched(tgb, "nope")
    with pytest.raises(ValueError, match="method"):
        tbatch.batched_top_down_weights(tgb, "nope")
    with pytest.raises(ValueError, match="l >= 2"):
        tbatch.batched_sequence_count(tgb, l=1)
