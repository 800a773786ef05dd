"""The port's single-corpus engine against the JAX package, on the CPU.

The same numpy-seeded files go through both packages' Sequitur and
``flatten`` (field-equal, checked here again), then through every
single-corpus entry point: ``top_down_weights``, ``per_file_weights`` and
``traversal_rounds`` under every method name, the six analytics under every
method (and both word-count backends), ``bottom_up_tables`` /
``bottom_up_bounds``, ``resolve_single_method``, the selector, the memory
plans, the head/tail resolution and ``term_vector_sparse``.  Every count is
integer-valued float32 below 2**24, so the tolerance is zero: results must
be bit-equal to ``repro.core`` and to the decompress-then-scan oracle
(``tests/_oracle.py``).  The cases include the two inputs pinned in
``.hypothesis/patches/``.  Everything runs on the CPU, so every kernel call
takes its plain version; the card suite is tests/test_torch_gpu.py.
"""

import dataclasses
import gc

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import sequence as jsequence
from repro.kernels import ops as jops
from repro_torch.core import sequence as tsequence
from repro_torch.core import traversal as ttraversal
from repro_torch.kernels import ops as tops

from _oracle import assert_result_equal, oracle
from conftest import make_repetitive_files

torch.set_num_threads(1)

METHODS = ttraversal.TOP_DOWN_METHODS
ANALYTIC_METHODS = METHODS + ("auto",)
# the port's entry point per analytics kind (the oracle's names)
APPS = {"word_count": "word_count", "sort": "sort_words",
        "term_vector": "term_vector", "inverted_index": "inverted_index",
        "ranked_inverted_index": "ranked_inverted_index",
        "sequence_count": "sequence_count"}
PINNED = [([[1, 0, 0, 0, 1, 0]], 8), ([[0, 1, 1, 1, 0, 1]], 6)]
FIELDS = [f.name for f in dataclasses.fields(tcore.GrammarArrays)]


def _cases():
    """(files, vocab): a repetitive corpus with nested rules, one whose
    files share a phrase, and the two pinned inputs."""
    rng = np.random.default_rng(3)
    cases = [(make_repetitive_files(rng, 12, n_files=4), 12)]
    base = rng.integers(0, 30, 25)
    cases.append(([np.concatenate([base] * int(rng.integers(2, 4))
                                  + [rng.integers(0, 30, 40)])
                   for _ in range(3)], 30))
    cases += PINNED
    return [([np.asarray(f, np.int64) for f in files], v)
            for files, v in cases]


CASES = _cases()


@pytest.fixture(scope="module")
def grammars():
    """Per case: (JAX grammar, port grammar), each from its own package's
    Sequitur + flatten."""
    out = []
    for files, vocab in CASES:
        jg, jnf = jcore.compress_files(files, vocab)
        tg, tnf = tcore.compress_files(files, vocab)
        out.append((jcore.flatten(jg, vocab, jnf),
                    tcore.flatten(tg, vocab, tnf)))
    return out


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want, what=""):
    """Bit-equal with the same dtype and shape, through tuples."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{what}[{i}]")
        return
    g, w = _np(got), _np(want)
    assert g.dtype == w.dtype, (what, g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w, err_msg=what)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_grammars_match(grammars, case):
    jga, tga = grammars[case]
    for name in FIELDS:
        _same(getattr(tga, name), getattr(jga, name), name)


# ------------------------------------------------------------ traversals --
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_weights_match_jax(grammars, case, method):
    jga, tga = grammars[case]
    w = tcore.top_down_weights(tga, method, device="cpu")
    assert w.device.type == "cpu"
    _same(w, jcore.top_down_weights(jga, method), f"top_down {method}")
    _same(tcore.per_file_weights(tga, method, device="cpu"),
          jcore.per_file_weights(jga, method), f"per_file {method}")


@pytest.mark.parametrize("case", range(len(CASES)))
def test_rounds_bottom_up_and_bounds_match_jax(grammars, case):
    jga, tga = grammars[case]
    assert (tcore.traversal_rounds(tga, device="cpu")
            == jcore.traversal_rounds(jga) == tga.num_levels)
    C, result = tcore.bottom_up_tables(tga, device="cpu")
    jC, jresult = jcore.bottom_up_tables(jga)
    _same(C, jC, "C")
    _same(result, jresult, "result")
    assert_result_equal(result, oracle(jga, "word_count"), "word_count")
    _same(tcore.bottom_up_bounds(tga, device="cpu"),
          jcore.bottom_up_bounds(jga), "bounds")


@pytest.mark.parametrize("per_file", [False, True])
def test_resolve_single_method_matches_jax(grammars, per_file):
    from repro.core.traversal import resolve_single_method
    for jga, tga in grammars:
        for m in ANALYTIC_METHODS:
            assert (tcore.resolve_single_method(tga, m, per_file)
                    == resolve_single_method(jga, m, per_file)), m


@pytest.mark.parametrize("gate", ["width", "fused"])
def test_gated_plans_degrade_like_jax(grammars, gate, monkeypatch):
    """A plan the width gate refuses takes the COO frontier, a rule count
    the fused gate refuses takes the per-round ELL path — in both packages
    alike, with the same weights."""
    jga, tga = grammars[0]
    name, value = (("ELL_BATCH_MAX_WIDTH", 0) if gate == "width"
                   else ("ELL_FUSED_MAX_RULES", 1))
    monkeypatch.setattr(tops, name, value)
    monkeypatch.setattr(jops, name, value)
    from repro.core.traversal import resolve_single_method
    for m in ("frontier_ell", "frontier_fused"):
        got = tcore.resolve_single_method(tga, m)
        assert got == resolve_single_method(jga, m)
        assert got == ("frontier" if gate == "width" else "frontier_ell")
        _same(tcore.top_down_weights(tga, m, device="cpu"),
              jcore.top_down_weights(jga, m), m)


# ------------------------------------------------------------- analytics --
@pytest.mark.parametrize("method", ANALYTIC_METHODS)
@pytest.mark.parametrize("kind", list(APPS))
def test_analytics_match_jax_and_oracle(grammars, kind, method):
    for case, (jga, tga) in enumerate(grammars):
        got = getattr(tcore, APPS[kind])(tga, method=method, device="cpu")
        _same(got, getattr(jcore, APPS[kind])(jga, method=method),
              f"{kind} {method} case {case}")
        assert_result_equal(got, oracle(jga, kind), kind,
                            f"{method} case {case}")


@pytest.mark.parametrize("method", ANALYTIC_METHODS)
@pytest.mark.parametrize("kind", ["word_count", "sort"])
def test_kernel_backend_matches_jax(grammars, kind, method):
    for jga, tga in grammars:
        _same(getattr(tcore, APPS[kind])(tga, method=method,
                                         backend="kernel", device="cpu"),
              getattr(jcore, APPS[kind])(jga, method=method,
                                         backend="pallas"))


def test_memoized_weights_are_reused(grammars):
    """``weights`` / ``file_weights`` from a memo give the same results as
    the traversal the analytics would run themselves."""
    jga, tga = grammars[0]
    w = tcore.top_down_weights(tga, device="cpu")
    wf = tcore.per_file_weights(tga, device="cpu")
    _same(tcore.word_count(tga, weights=w, device="cpu"),
          jcore.word_count(jga))
    _same(tcore.sequence_count(tga, weights=w, device="cpu"),
          jcore.sequence_count(jga))
    _same(tcore.ranked_inverted_index(tga, file_weights=wf, device="cpu"),
          jcore.ranked_inverted_index(jga))


@pytest.mark.parametrize("l", [2, 4, 5])
def test_sequence_count_window_lengths(grammars, l):
    for jga, tga in grammars:
        got = tcore.sequence_count(tga, l=l, method="leveled", device="cpu")
        _same(got, jcore.sequence_count(jga, l=l, method="leveled"))
        assert_result_equal(got, oracle(jga, "sequence_count", l=l),
                            "sequence_count", f"l={l}")


def test_head_tail_buffers_match_jax(grammars):
    for jga, tga in grammars:
        for l in (2, 3, 5):
            got = tsequence.resolve_head_tail(
                tga, tsequence.plan_head_tail(tga, l), device="cpu")
            want = jsequence.resolve_head_tail(
                jga, jsequence.plan_head_tail(jga, l))
            _same(got, tuple(want), f"l={l}")


def test_term_vector_sparse_matches_jax_and_dense(grammars):
    for jga, tga in grammars:
        ff, ww, cc = got = tcore.term_vector_sparse(tga)
        _same(got, jcore.term_vector_sparse(jga))
        dense = np.zeros((tga.num_files, tga.vocab_size), np.float32)
        np.add.at(dense, (ff, ww), cc)
        _same(dense, oracle(jga, "term_vector"))


# ---------------------------------------------------- selector, memory --
def test_selector_and_memory_plans_match_jax(grammars):
    from repro.core.selector import select_traversal
    for jga, tga in grammars:
        assert tcore.estimate_costs(tga) == jcore.estimate_costs(jga)
        for calibrate in (False, True):
            assert (tcore.select_direction(tga, calibrate=calibrate)
                    == jcore.select_direction(jga, calibrate=calibrate))
        assert (tcore.selector.select_traversal(tga)
                == select_traversal(jga))
        for l in (2, 3, 4):
            _same(tcore.head_tail_upper_limit(tga, l),
                  jcore.head_tail_upper_limit(jga, l))
            _same(tcore.stream_upper_limit(tga, l),
                  jcore.stream_upper_limit(jga, l))
        plans = [(tcore.plan_local_tables(tga, device="cpu"),
                  jcore.plan_local_tables(jga)),
                 (tcore.plan_streams(tga, 3), jcore.plan_streams(jga, 3))]
        for got, want in plans:
            _same(got.sizes, want.sizes)
            _same(got.offsets, want.offsets)
            assert got.total == want.total
            r = tga.num_rules - 1
            assert got.slice_of(r) == want.slice_of(r)


def test_selector_directions_on_shaped_corpora():
    """Many small files favour bottom-up, few large files top-down — the
    JAX package's selector cases, through the port's grammar."""
    rng = np.random.default_rng(1)
    files = [rng.integers(0, 40, 30) for _ in range(64)]
    g, nf = tcore.compress_files(files, 40)
    assert tcore.select_direction(tcore.flatten(g, 40, nf)) == "bottom_up"
    rng = np.random.default_rng(2)
    files = [np.tile(rng.integers(0, 500, 200), 10) for _ in range(2)]
    g, nf = tcore.compress_files(files, 500)
    assert tcore.select_direction(tcore.flatten(g, 500, nf)) == "top_down"


# ------------------------------------------------------- memo, requests --
def test_plan_memo_is_keyed_by_device_and_evicted(grammars):
    """Memoized device tensors carry the device in their key, and die with
    their grammar (a recycled id must never serve another grammar)."""
    files, vocab = CASES[0]
    g, nf = tcore.compress_files(files, vocab)
    ga = tcore.flatten(g, vocab, nf)
    tcore.top_down_weights(ga, "frontier_ell", device="cpu")
    keys = [k for k in ttraversal._ENGINE_CACHE if k[1] == id(ga)]
    assert keys and all(k[2] == "cpu" for k in keys)
    del ga
    gc.collect()
    assert not [k for k in ttraversal._ENGINE_CACHE if k in keys]


def test_bad_requests_raise(grammars):
    _, tga = grammars[0]
    with pytest.raises(ValueError, match="method"):
        tcore.top_down_weights(tga, "nope", device="cpu")
    with pytest.raises(ValueError, match="method"):
        tcore.per_file_weights(tga, "auto", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        tcore.word_count(tga, backend="pallas", device="cpu")
    with pytest.raises(ValueError, match="l >= 2"):
        tcore.sequence_count(tga, l=1, device="cpu")
    elsewhere = torch.zeros(tga.num_rules, device="meta")
    with pytest.raises(ValueError, match="meta"):
        tcore.word_count(tga, weights=elsewhere, device="cpu")
    with pytest.raises(ValueError, match="meta"):
        tcore.sequence_count(tga, weights=elsewhere, device="cpu")
    with pytest.raises(ValueError, match="meta"):
        tcore.term_vector(tga, file_weights=elsewhere[:, None],
                          device="cpu")
