"""The CUDA kernels on the card, against their plain torch versions.

Every test here needs a CUDA device (Hopper, sm_90) and the CUDA toolkit;
without one each test skips with the reason.  Run them on the card with

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py

This file imports no JAX, so it runs where only PyTorch is installed.
Integer-valued inputs (every value on the engine path) must match exactly.
Arbitrary floats are summed in another order (atomics in any order, for the
histogram), so each output is held to the float32 error bound of an
m-term sum in any order: |kernel - plain| <= 2 * m * eps * sum(|terms|),
with m and sum(|terms|) taken per output from the plain version itself.
"""

import numpy as np
import pytest
import torch

import repro_torch.core as tcore
from repro_torch.core import (ANALYTICS_KINDS, METHODS, GrammarBatch,
                              compress_files, flatten, run_batched)
from repro_torch.data import CompressedCorpus
from repro_torch.kernels import _common, ops, propagate_fused, ref
from repro_torch.kernels.bincount import weighted_bincount_cuda
from repro_torch.kernels.propagate import ell_row_sums_cuda
from repro_torch.kernels.propagate_batched import ell_propagate_batched_cuda

from _torch_inputs import (FUSED_CASES, batch_dags, bincount_inputs,
                           fused_case, plan_inputs, ragged_corpora,
                           vector_inputs)

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run this file on the card)")
    return torch.device("cuda")


def _on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


EPS = torch.finfo(torch.float32).eps


def _same(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _within_sum_bound(got, want, terms, abs_sum):
    """Elementwise |got - want| <= 2 * terms * eps * abs_sum."""
    err = (got.double() - want.double()).abs()
    assert bool((err <= 2 * terms.double() * EPS * abs_sum.double()).all()), \
        float(err.max())


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("n,rows,k,R", [(1, 64, 1, 10), (3, 100, 4, 50),
                                        (2, 300, 48, 333), (2, 70, 512, 90)])
def test_propagate_batched_on_card(cuda, n, rows, k, R, integer,
                                   seeded_rng):
    w, a, src, freq = args = _on(cuda, *plan_inputs(seeded_rng, n, rows, k,
                                                    R, integer))
    got = ops.ell_propagate_batched(*args)
    want = ref.ell_propagate_batched_ref(*args)
    if integer:
        _same(got, want)
    else:
        abs_sum, _ = ref.ell_propagate_batched_ref(w.abs(), a, src,
                                                    freq.abs())
        _within_sum_bound(got[0], want[0], torch.full_like(abs_sum, k),
                          abs_sum)
        _same(got[1:], want[1:])                # seen: 0/1 sums, exact


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("R,k,F,n", [(64, 3, 4, 1), (130, 5, 17, 2),
                                     (300, 2, 300, 1)])
def test_propagate_vector_on_card(cuda, R, k, F, n, integer, seeded_rng):
    W, a, src, freq = args = _on(cuda, *vector_inputs(seeded_rng, n, R, k,
                                                      F, integer))
    got = ops.ell_propagate_vector(*args)
    want = ref.ell_propagate_vector_ref(*args)
    if integer:
        _same(got, want)
    else:
        abs_sum, _ = ref.ell_propagate_vector_ref(W.abs(), a, src,
                                                   freq.abs())
        _within_sum_bound(got[0], want[0], torch.full_like(abs_sum, k),
                          abs_sum)
        _same(got[1:], want[1:])


@pytest.mark.parametrize("R,max_deg,n", [(40, 3, 1), (1300, 40, 3),
                                         (257, 2, 4)])
def test_frontier_fused_on_card(cuda, R, max_deg, n, seeded_rng):
    w0, ind, src, freq, want, depth = batch_dags(seeded_rng, R, max_deg, n)
    args = _on(cuda, w0, ind, src, freq)
    w, rounds = ops.ell_frontier_fused(*args, depth + 2, with_rounds=True)
    pw, pr = ref.ell_frontier_fused_ref(*args, depth + 2)
    _same((w, rounds), (pw, pr))
    np.testing.assert_array_equal(w.cpu().numpy(), want)


def _fused_on_card(args, max_rounds):
    """The kernel (synchronised, so a fault shows here) and the plain
    version on the same card inputs."""
    got = ops.ell_frontier_fused(*args, max_rounds, with_rounds=True)
    torch.cuda.synchronize()
    return got, ref.ell_frontier_fused_ref(*args, max_rounds)


@pytest.mark.parametrize("n,R,k", [(1, 2000, 1024), (16, 777, 1024)])
@pytest.mark.parametrize("case", FUSED_CASES)
def test_frontier_fused_cases_on_card(cuda, case, n, R, k, seeded_rng):
    """Padding interleaved within rows, skewed rows of 600-700 entries
    among rows of 1-3 (the long-row path), a cut round loop, and rules
    that never become ready, at N=1 and N=16 (R=777 is no multiple of a
    block's rows)."""
    w0, ind, src, freq, max_rounds = fused_case(seeded_rng, case, n, R, k)
    got, want = _fused_on_card(_on(cuda, w0, ind, src, freq), max_rounds)
    _same(got, want)
    if case == "cut_max_rounds":
        assert int(got[1].max()) == max_rounds


@pytest.mark.parametrize("n", [1, 16])
def test_frontier_fused_single_rule_on_card(cuda, n, seeded_rng):
    """R=1: the root alone, with a self-edge on some corpora and in_deg 0,
    1 or 2 (only in_deg 0 starts a frontier)."""
    w0 = seeded_rng.integers(1, 5, (n, 1)).astype(np.float32)
    ind = seeded_rng.integers(0, 3, (n, 1)).astype(np.float32)
    src = np.zeros((n, 1, 3), np.int32)
    freq = seeded_rng.integers(0, 3, (n, 1, 3)).astype(np.float32)
    got, want = _fused_on_card(_on(cuda, w0, ind, src, freq), 3)
    _same(got, want)


def test_frontier_fused_back_to_back_on_card(cuda, seeded_rng):
    """Calls in a row on one stream carry nothing over (flags, live
    lengths, the long-row list, the weight buffers): each equals the plain
    version, and the first input gives the same result again."""
    a = fused_case(seeded_rng, "skewed_rows", 4, 1500, 1024)
    b = fused_case(seeded_rng, "interleaved_padding", 2, 600, 64)
    a_args, b_args = _on(cuda, *a[:4]), _on(cuda, *b[:4])
    first = ops.ell_frontier_fused(*a_args, a[4], with_rounds=True)
    second = ops.ell_frontier_fused(*b_args, b[4], with_rounds=True)
    again = ops.ell_frontier_fused(*a_args, a[4], with_rounds=True)
    torch.cuda.synchronize()
    _same(first, ref.ell_frontier_fused_ref(*a_args, a[4]))
    _same(second, ref.ell_frontier_fused_ref(*b_args, b[4]))
    _same(again, first)


def test_frontier_fused_grid_covers_every_sm(cuda, seeded_rng):
    """A plan with more lane groups of rows than the card holds threads
    launches the full co-resident grid: every SM, as many blocks a SM as
    the occupancy allows."""
    w0, ind, src, freq, max_rounds = fused_case(
        seeded_rng, "cut_max_rounds", 16, 4000, 64)
    _fused_on_card(_on(cuda, w0, ind, src, freq), max_rounds)
    blocks, per_sm, sms = propagate_fused.last_grid
    props = torch.cuda.get_device_properties(cuda)
    assert sms == props.multi_processor_count
    assert per_sm >= 1 and blocks == per_sm * sms


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("n,nbins", [(700, 300), (5, 3), (100000, 1030)])
def test_bincount_on_card(cuda, n, nbins, integer, seeded_rng):
    ids, vals = _on(cuda, *bincount_inputs(seeded_rng, n, nbins, integer))
    got = ops.weighted_bincount(ids, vals, nbins)
    want = ref.weighted_bincount_ref(ids, vals, nbins)
    if integer:
        _same([got], [want])
    else:
        terms = ref.weighted_bincount_ref(ids, torch.ones_like(vals), nbins)
        _within_sum_bound(got, want, terms,
                          ref.weighted_bincount_ref(ids, vals.abs(), nbins))


def _row_sums_inputs(rng, rows, k, R, integer):
    """(weights [R], src [rows, k], freq): ~1/3 padding entries, and the
    last source rule R-1 always referenced."""
    src = rng.integers(0, R, (rows, k)).astype(np.int32)
    src[-1, -1] = R - 1
    freq = rng.integers(0, 3, (rows, k)).astype(np.float32)
    freq[-1, -1] = 1.0
    if integer:
        w = rng.integers(0, 1000, R).astype(np.float32)
    else:
        w = rng.normal(size=R).astype(np.float32)
    return w, src, freq


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("rows,k,R", [(64, 1, 10), (257, 3, 129),
                                      (1001, 5, 77), (300, 16, 333),
                                      (9, 1024, 5000)])
def test_row_sums_on_card(cuda, rows, k, R, integer, seeded_rng):
    """Kernel 5 at W in {1, 3, 5, 16, 1024}, row counts that are not a
    multiple of a block's rows, and src at R-1."""
    w, src, freq = args = _on(cuda, *_row_sums_inputs(seeded_rng, rows, k,
                                                      R, integer))
    before = _common.launch_counts().get("ell_row_sums", 0)
    got = ops.ell_row_sums(*args)
    assert _common.launch_counts()["ell_row_sums"] == before + 1
    want = ref.ell_row_sums_ref(*args)
    if integer:
        _same([got], [want])
    else:
        abs_sum = ref.ell_row_sums_ref(w.abs(), src, freq.abs())
        _within_sum_bound(got, want, torch.full_like(abs_sum, k), abs_sum)


def test_row_sums_empty_and_bad_inputs_on_card(cuda):
    w = torch.ones(5, device=cuda)
    got = ops.ell_row_sums(w, torch.zeros((0, 3), dtype=torch.int32,
                                          device=cuda),
                           torch.zeros((0, 3), device=cuda))
    assert got.shape == (0,) and got.device.type == "cuda"
    src = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    freq = torch.zeros((4, 2), device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        ell_row_sums_cuda(w, src.long(), freq)
    with pytest.raises(ValueError, match="contiguous"):
        ell_row_sums_cuda(w, src, freq.T.contiguous().T)
    with pytest.raises(ValueError, match="expected cuda"):
        ell_row_sums_cuda(w.cpu(), src, freq)


def test_wrappers_reject_bad_inputs_on_card(cuda):
    w = torch.zeros((1, 4), device=cuda)
    src = torch.zeros((1, 4, 2), dtype=torch.int32, device=cuda)
    freq = torch.zeros((1, 4, 2), device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        ell_propagate_batched_cuda(w, w, src.long(), freq)
    with pytest.raises(ValueError, match="contiguous"):
        ell_propagate_batched_cuda(w, w, src, freq.transpose(1, 2)
                                   .contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="expected cuda"):
        weighted_bincount_cuda(torch.zeros(3, dtype=torch.int32, device=cuda),
                               torch.zeros(3), 4)


def test_engine_on_card_matches_cpu(cuda):
    """All six analytics under all six methods (and the kernel backend) on
    the card equal the CPU path bit for bit, and the run went through all
    four kernels."""
    gas = []
    for files, vocab in ragged_corpora():
        g, nf = compress_files(files, vocab)
        gas.append(flatten(g, vocab, nf))
    gpu = GrammarBatch.build(gas)
    assert gpu.device.type == "cuda"
    cpu = GrammarBatch.build(gas, device="cpu")
    _common.reset_launch_counts()
    runs = [(k, m, "torch") for k in ANALYTICS_KINDS for m in METHODS]
    runs += [(k, m, "kernel") for k in ("word_count", "sort")
             for m in METHODS]
    for kind, method, backend in runs:
        got = run_batched(gpu, kind, method, backend=backend)
        want = run_batched(cpu, kind, method, backend=backend)
        for g, w in zip(got, want):
            for a, b in zip(g if isinstance(g, tuple) else (g,),
                            w if isinstance(w, tuple) else (w,)):
                np.testing.assert_array_equal(a, b, err_msg=f"{kind} "
                                              f"{method} {backend}")
    counts = _common.launch_counts()
    assert all(counts[name] > 0 for name in (
        "ell_propagate_batched", "ell_frontier_fused",
        "ell_propagate_vector", "weighted_bincount")), counts


def _single_corpus():
    rng = np.random.default_rng(5)
    base = rng.integers(0, 40, 30)
    files = [np.concatenate([base] * int(rng.integers(2, 5))
                            + [rng.integers(0, 40, 60)]) for _ in range(5)]
    return files, 40


def _equal(a, b, what):
    for x, y in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else x
        y = y.cpu().numpy() if isinstance(y, torch.Tensor) else y
        assert x.dtype == y.dtype, what
        np.testing.assert_array_equal(x, y, err_msg=what)


def test_single_corpus_on_card_matches_cpu(cuda):
    """Every single-corpus traversal and analytic, under every method and
    both word-count backends, gives on the card the CPU path's tensors bit
    for bit; the ELL methods and the kernel backend went through kernels 1,
    2 and 4, and the flow check through kernel 5."""
    files, vocab = _single_corpus()
    g, nf = compress_files(files, vocab)
    ga = flatten(g, vocab, nf)
    _common.reset_launch_counts()
    for m in tcore.traversal.TOP_DOWN_METHODS:
        for fn in (tcore.top_down_weights, tcore.per_file_weights):
            got = fn(ga, m)
            assert got.device.type == "cuda"
            _equal(got, fn(ga, m, device="cpu"), f"{fn.__name__} {m}")
    apps = ("word_count", "sort_words", "term_vector", "inverted_index",
            "ranked_inverted_index", "sequence_count")
    for m in tcore.traversal.TOP_DOWN_METHODS + ("auto",):
        for app in apps:
            fn = getattr(tcore, app)
            _equal(fn(ga, method=m), fn(ga, method=m, device="cpu"),
                   f"{app} {m}")
        for app in ("word_count", "sort_words"):
            fn = getattr(tcore, app)
            _equal(fn(ga, method=m, backend="kernel"),
                   fn(ga, method=m, device="cpu"), f"{app} {m} kernel")
    _equal(tcore.bottom_up_tables(ga), tcore.bottom_up_tables(ga, "cpu"),
           "bottom_up_tables")
    _equal(tcore.bottom_up_bounds(ga), tcore.bottom_up_bounds(ga, "cpu"),
           "bottom_up_bounds")
    assert tcore.traversal_rounds(ga) == tcore.traversal_rounds(ga, "cpu")
    w = tcore.top_down_weights(ga)
    src, freq = (torch.as_tensor(a, device=cuda)
                 for a in ga.in_edges_ell_dense())
    flow = ops.ell_row_sums(w, src, freq)
    assert float(flow[0]) == 0.0 and torch.equal(flow[1:], w[1:])
    counts = _common.launch_counts()
    assert all(counts[name] > 0 for name in (
        "ell_propagate_batched", "ell_frontier_fused",
        "ell_propagate_vector", "weighted_bincount", "ell_row_sums")), counts


def test_store_on_card(cuda, tmp_path):
    """The store's memo serves each device its own tensors, and an append
    recomputes them on the card."""
    files, vocab = _single_corpus()
    cc = CompressedCorpus.build(files[:3], vocab)
    w_gpu = cc.top_down_weights()
    w_cpu = cc.top_down_weights(device="cpu")
    assert w_gpu.device.type == "cuda" and w_cpu.device.type == "cpu"
    assert cc.top_down_weights() is w_gpu
    cc.append_files(files[3:])
    fresh = CompressedCorpus.build(files, vocab)
    _equal(cc.top_down_weights(), fresh.top_down_weights(device="cpu"),
           "weights after append")
    _equal(cc.per_file_weights("leveled"),
           fresh.per_file_weights("leveled", device="cpu"),
           "per-file weights after append")


def test_explicit_cuda_device_shares_the_memo(cuda):
    """``device="cuda"`` names the current card: weights memoized there
    serve the analytics asked for on ``"cuda"``, and the store and the
    engine hold one entry per card, whichever way it was named."""
    files, vocab = _single_corpus()
    cc = CompressedCorpus.build(files, vocab)
    ga = cc.ga
    card = f"cuda:{torch.cuda.current_device()}"
    w = cc.top_down_weights(device="cuda")
    assert cc.top_down_weights() is w
    assert cc.top_down_weights(device=card) is w
    wf = cc.per_file_weights(device="cuda")
    _equal(tcore.word_count(ga, weights=w, device="cuda"),
           tcore.word_count(ga, device="cpu"), "word_count")
    _equal(tcore.sort_words(ga, weights=w, device="cuda"),
           tcore.sort_words(ga, device="cpu"), "sort_words")
    _equal(tcore.sequence_count(ga, weights=w, device="cuda"),
           tcore.sequence_count(ga, device="cpu"), "sequence_count")
    _equal(tcore.term_vector(ga, file_weights=wf, device="cuda"),
           tcore.term_vector(ga, device="cpu"), "term_vector")
    tcore.top_down_weights(ga, device="cuda")
    tcore.top_down_weights(ga)
    tcore.top_down_weights(ga, device=card)
    engine = [k for k in tcore.traversal._ENGINE_CACHE
              if k[1] == id(ga) and k[2].startswith("cuda")]
    assert engine == [("pack", id(ga), card)]
    store = [k for k in cc.cached_weight_keys() if k[0] == "top_down"]
    assert store == [("top_down", "frontier", card)]
