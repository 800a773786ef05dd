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
                           files_agg, files_filter, files_phrase,
                           files_search, fused_case, lm_inputs, plan_inputs,
                           ragged_corpora, vector_case, vector_inputs)

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


def _misaligned(dev, *arrays):
    """The arrays on ``dev`` as contiguous views that start one element
    into their storage, so no 16-byte load fits their rows."""
    out = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        buf = torch.empty(a.size + 1, dtype=torch.from_numpy(a).dtype,
                          device=dev)
        view = buf[1:].view(a.shape)
        view.copy_(torch.from_numpy(a))
        assert view.storage_offset() == 1 and view.is_contiguous()
        out.append(view)
    return out


def _vector_check(got, args, integer):
    want = ref.ell_propagate_vector_ref(*args)
    if integer:
        _same(got, want)
    else:
        W, a, src, freq = args
        abs_sum, _ = ref.ell_propagate_vector_ref(W.abs(), a, src,
                                                   freq.abs())
        terms = (freq != 0).sum(-1, keepdim=True).expand_as(abs_sum)
        _within_sum_bound(got[0], want[0], terms, abs_sum)
        _same(got[1:], want[1:])       # dyadic active: exact in any order


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("case,n,R,k,F", [
    ("wide_interleaved", 4, 4096, 128, 16), ("long_rows", 2, 1500, 512, 4),
    ("hot_sources", 3, 2000, 128, 17), ("all_inactive", 2, 900, 128, 33),
    ("wide_interleaved", 1, 600, 512, 300), ("long_rows", 2, 700, 128, 1),
    ("hot_sources", 2, 333, 12, 64), ("wide_interleaved", 5, 777, 4, 16)])
def test_propagate_vector_cases_on_card(cuda, case, n, R, k, F, integer,
                                        seeded_rng):
    """Wide plans with the real entries among the padding (K=128, 512),
    rows of more than 32 real entries, hot sources, an all-inactive round,
    narrow plans that share a warp between rows (K=4, 12), and F in {1, 4,
    16, 17, 33, 64, 300}."""
    args = _on(cuda, *vector_case(seeded_rng, case, n, R, k, F, integer))
    _vector_check(ops.ell_propagate_vector(*args), args, integer)


@pytest.mark.parametrize("k,F", [(128, 16), (12, 4), (5, 17)])
def test_propagate_vector_misaligned_views_on_card(cuda, k, F, seeded_rng):
    """Inputs that are views one element into their storage take the
    scalar loads, and give what aligned inputs give."""
    inputs = vector_case(seeded_rng, "long_rows", 2, 500, k, F)
    aligned = _on(cuda, *inputs)
    shifted = _misaligned(cuda, *inputs)
    got = ops.ell_propagate_vector(*shifted)
    _vector_check(got, shifted, True)
    _same(got, ops.ell_propagate_vector(*aligned))


def test_propagate_vector_back_to_back_on_card(cuda, seeded_rng):
    """A call whose outputs land in memory that held NaNs writes every
    element (rows without a live, active entry too), and calls in a row on
    one stream carry nothing over."""
    a = _on(cuda, *vector_case(seeded_rng, "wide_interleaved", 4, 2048,
                               128, 16))
    b = _on(cuda, *vector_case(seeded_rng, "all_inactive", 4, 2048, 128,
                               16))
    numel = 4 * 2048 * 17
    stale = torch.full((numel,), float("nan"), device=cuda)
    ptr = stale.data_ptr()
    del stale
    first = ops.ell_propagate_vector(*a)
    assert first[0].data_ptr() == ptr          # the NaN block, reused
    second = ops.ell_propagate_vector(*b)
    again = ops.ell_propagate_vector(*a)
    torch.cuda.synchronize()
    _vector_check(first, a, True)
    _vector_check(second, b, True)
    _same(again, first)


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
@pytest.mark.parametrize("n,nbins,case", [
    (700, 300, "uniform"), (5, 3, "uniform"), (100000, 1030, "uniform"),
    (100001, 300, "zipf"), (4099, 2000, "padding_rows"),
    (37, 8, "out_of_range")])
def test_bincount_on_card(cuda, n, nbins, case, integer, seeded_rng):
    ids, vals = _on(cuda, *bincount_inputs(seeded_rng, n, nbins, integer,
                                           case))
    got = ops.weighted_bincount(ids, vals, nbins)
    _bincount_check(got, ids, vals, nbins, integer)


def _bincount_check(got, ids, vals, nbins, integer):
    want = ref.weighted_bincount_ref(ids, vals, nbins)
    if integer:
        _same([got], [want])
    else:
        terms = ref.weighted_bincount_ref(ids, torch.ones_like(vals), nbins)
        _within_sum_bound(got, want, terms,
                          ref.weighted_bincount_ref(ids, vals.abs(), nbins))


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("rows,t,nbins,case", [
    (16, 16384, 32768, "zipf"), (6, 1001, 300, "padding_rows"),
    (9, 1001, 1 << 19, "zipf"), (7, 203, 61, "out_of_range"),
    (3, 50, 40, "uniform")])
def test_bincount_batched_on_card(cuda, rows, t, nbins, case, id_dtype,
                                  integer, seeded_rng):
    """ops.weighted_bincount_batched on the card equals the plain version
    row by row, for int32 and the engine's int64 ids, across the row-chunk
    crossover (9 x 2^19 bins is two chunks)."""
    ids, vals = _on(cuda, *bincount_inputs(seeded_rng, t, nbins, integer,
                                           case, rows=rows))
    ids = ids.to(id_dtype)
    got = ops.weighted_bincount_batched(ids, vals, nbins)
    assert got.shape == (rows, nbins)
    for i in range(rows):
        _bincount_check(got[i], ids[i], vals[i], nbins, integer)


@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_bincount_misaligned_views_on_card(cuda, id_dtype, seeded_rng):
    """Ids and values one element into their storage (no 16-byte loads)
    give what aligned inputs give, in 1-D and batched."""
    ids, vals = bincount_inputs(seeded_rng, 1000, 700, True, "zipf", rows=5)
    ids = ids.astype(np.int64 if id_dtype == torch.int64 else np.int32)
    aligned = _on(cuda, ids, vals)
    shifted = _misaligned(cuda, ids, vals)
    _same([ops.weighted_bincount_batched(*shifted, 700)],
          [ops.weighted_bincount_batched(*aligned, 700)])
    flat = [x.reshape(-1) for x in shifted]
    _bincount_check(ops.weighted_bincount(*flat, 700), *flat, 700, True)


def test_bincount_reuses_one_output_on_card(cuda, seeded_rng):
    """Back-to-back calls into one output allocation: each call zeroes it
    on the stream before adding, so nothing of the previous call stays."""
    a = _on(cuda, *bincount_inputs(seeded_rng, 5000, 900, True, "zipf",
                                   rows=4))
    b = _on(cuda, *bincount_inputs(seeded_rng, 5000, 900, True,
                                   "padding_rows", rows=4))
    out = torch.full((4, 900), float("nan"), device=cuda)
    for ids, vals in (a, b, a):
        got = weighted_bincount_cuda(ids, vals, 900, out=out)
        assert got is out
        torch.cuda.synchronize()
        for i in range(4):
            _bincount_check(out[i], ids[i], vals[i], 900, True)


def test_bincount_batched_is_one_kernel_a_chunk_on_card(cuda, seeded_rng):
    """The batched word count's call on the card: one histogram kernel and
    one memset a row chunk, and no other device work (no id offsets, no
    fill, no copy) — counted with the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ids, vals = _on(cuda, *bincount_inputs(seeded_rng, 1001, 1 << 19, True,
                                           "zipf", rows=9))
    ids = ids.long()                         # the engine's word tables
    chunks = -(-9 // ops.bincount_batch_rows(9, 1 << 19))
    assert chunks == 2
    ops.weighted_bincount_batched(ids, vals, 1 << 19)    # build, warm up
    torch.cuda.synchronize()
    before = _common.launch_counts()["weighted_bincount"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ops.weighted_bincount_batched(ids, vals, 1 << 19)
        torch.cuda.synchronize()
    assert _common.launch_counts()["weighted_bincount"] == before + chunks
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    kernels = [x for x in names if "memset" not in x.lower()]
    memsets = [x for x in names if "memset" in x.lower()]
    assert len(kernels) == chunks, names
    assert all("weighted_bincount_kernel" in x for x in kernels), names
    assert len(memsets) == chunks, names


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
    with pytest.raises(TypeError, match="dtype"):
        weighted_bincount_cuda(torch.zeros(3, dtype=torch.int16, device=cuda),
                               torch.zeros(3, device=cuda), 4)
    with pytest.raises(ValueError, match="shape"):
        weighted_bincount_cuda(torch.zeros((2, 3), dtype=torch.int32,
                                           device=cuda),
                               torch.zeros((2, 3), device=cuda), 4,
                               out=torch.zeros((2, 5), device=cuda))


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
        "ell_propagate_vector", "weighted_bincount", "rank_files")), counts


def _single_corpus():
    rng = np.random.default_rng(5)
    base = rng.integers(0, 40, 30)
    files = [np.concatenate([base] * int(rng.integers(2, 5))
                            + [rng.integers(0, 40, 60)]) for _ in range(5)]
    return files, 40


def _equal(a, b, what):
    if isinstance(b, (tuple, list)):
        assert isinstance(a, (tuple, list)) and len(a) == len(b), what
        for x, y in zip(a, b):
            _equal(x, y, what)
        return
    x = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    y = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert x.dtype == y.dtype, (what, x.dtype, y.dtype)
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
        "ell_propagate_vector", "weighted_bincount", "ell_row_sums",
        "rank_files")), counts


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


# ------------------------------------- search, query operators, serving --
SERVE_METHODS = ("frontier", "frontier_ell", "frontier_fused")
PRED = ("or", (("term", 1, 1), ("and", (("term", 2, 2), ("term", 3, 1)))))


def _serve_corpora():
    """(files, vocab) of three corpora; corpus 0 holds two copies of one
    file, so their scores tie under every query."""
    rng = np.random.default_rng(11)
    out = []
    for v, nf in ((30, 4), (45, 3), (25, 5)):
        base = rng.integers(0, v, 20)
        files = [np.concatenate([base] * int(rng.integers(1, 4))
                                + [rng.integers(0, v, 40)])
                 for _ in range(nf)]
        out.append((files, v))
    out[0][0].append(out[0][0][1])
    return out


def _grammar(files, vocab):
    g, nf = compress_files(files, vocab)
    return flatten(g, vocab, nf)


def _rare_term(files, vocab):
    """A term that only one file holds: the rest of a top-k over it is
    zero-score ties."""
    df = (np.stack([np.bincount(f, minlength=vocab) for f in files]) > 0
          ).sum(axis=0)
    return int(np.flatnonzero(df == df[df > 0].min())[0])


def test_masked_top_k_ties_on_card(cuda, seeded_rng):
    scores = seeded_rng.integers(0, 3, (5, 300)).astype(np.float32)
    valid = seeded_rng.random((5, 300)) < 0.7
    s_, v_ = _on(cuda, scores, valid)
    vals, idx = ops.masked_top_k(s_, v_, 40)
    masked = np.where(valid, scores, -np.inf)
    order = np.argsort(-masked, axis=1, kind="stable")[:, :40]
    np.testing.assert_array_equal(idx.cpu().numpy(), order)
    np.testing.assert_array_equal(vals.cpu().numpy(),
                                  np.take_along_axis(masked, order, 1))


def _rank_inputs(rng, f_pad, num_files, v_pad=300):
    """[N, V_pad, F_pad] integer-valued counts with heavy ties and many
    zeros, one word per corpus that no file holds, unequal vocabularies,
    and junk past each corpus's files and words."""
    n = len(num_files)
    vocab = [int(v_pad - 37 * i) for i in range(n)]
    tv = rng.integers(0, 4, (n, v_pad, f_pad)).astype(np.float32)
    tv[rng.random(tv.shape) < 0.5] = 0.0
    for i, (nf, v) in enumerate(zip(num_files, vocab)):
        tv[i, v // 2, :nf] = 0.0
        tv[i, :, nf:] = 99.0
        tv[i, v:, :] = 77.0
    return tv, vocab


def _rank_dispatch(path):
    from repro_torch.obs import global_registry
    return global_registry().counter(
        "repro_kernel_dispatch_total", "",
        ("decision", "path")).labels("rank_files", path)


def _held_to_plain(got, tv, num_files, vocab, on_card=True):
    """The kernel's rankings and counts are the plain version's (the
    torch argsort path, on the CPU and, with ``on_card``, on the card) bit
    for bit: int32 and float32, contiguous."""
    plains = [ref.rank_files_ref(tv.cpu(), num_files, vocab)]
    if on_card:
        plains.append(ref.rank_files_ref(tv, num_files, vocab))
    for plain in plains:
        assert len(got) == len(plain) == len(num_files)
        for (ids, counts), (wi, wc), nf, v in zip(got, plain, num_files,
                                                  vocab):
            assert ids.dtype == torch.int32
            assert counts.dtype == torch.float32
            assert ids.is_contiguous() and counts.is_contiguous()
            assert ids.shape == counts.shape == (v, nf)
            assert torch.equal(ids.cpu(), wi.cpu())
            assert torch.equal(counts.cpu().view(torch.int32),
                               wc.cpu().contiguous().view(torch.int32))


RANK_CASES = [(1, (1, 1, 1)), (2, (2, 1, 2)), (4, (3, 4, 1)),
              (8, (5, 3, 8)), (16, (16, 5, 9)), (32, (31, 17, 3, 5, 32)),
              (33, (33, 1, 20)), (64, (64, 40, 32, 0)),
              (256, (256, 200, 65))]


@pytest.mark.parametrize("f_pad,num_files", RANK_CASES,
                         ids=[f"F{f}" for f, _ in RANK_CASES])
def test_rank_files_on_card(cuda, f_pad, num_files, seeded_rng):
    """One kernel launch ranks every corpus of the pack, bit-equal to the
    plain version, a warp a word past 32 files; the dispatch counter and
    the launch counter each move by one."""
    tv_np, vocab = _rank_inputs(seeded_rng, f_pad, num_files)
    tv = torch.from_numpy(tv_np).to(cuda)
    kernel = _rank_dispatch("kernel")
    before = (kernel.value, _common.launch_counts().get("rank_files", 0))
    got = ops.rank_files(tv, num_files, vocab)
    torch.cuda.synchronize()
    assert kernel.value == before[0] + 1
    assert _common.launch_counts()["rank_files"] == before[1] + 1
    _held_to_plain(got, tv, num_files, vocab)
    for (ids, _), v in zip(got, vocab):          # the word no file holds
        assert torch.equal(ids[v // 2].cpu(),
                           torch.arange(ids.shape[1], dtype=torch.int32))


def test_rank_files_any_float_order_on_card(cuda, seeded_rng):
    """Negative counts, -0.0 beside +0.0, infinities and NaN rank as the
    plain version's stable argsort ranks them."""
    tv_np, vocab = _rank_inputs(seeded_rng, 8, (8, 7))
    special = np.array([-0.0, 0.0, np.nan, -np.inf, np.inf, -2.5, 0.0,
                        np.nan], np.float32)
    tv_np[:, :40] = seeded_rng.choice(special, (2, 40, 8))
    tv_np[:, 40:80] = seeded_rng.normal(size=(2, 40, 8))
    tv = torch.from_numpy(tv_np).to(cuda)
    _held_to_plain(ops.rank_files(tv, [8, 7], vocab), tv, [8, 7], vocab,
                   on_card=False)


def test_rank_files_at_scale_on_card(cuda, seeded_rng):
    """Many blocks a corpus (the grid stride, a group of lanes a word and
    a warp a word), and more corpora than one launch's table (two
    launches under one call)."""
    for f_pad, v_pad in ((32, 70001), (64, 20001)):
        nf = [f_pad, 19, 30]
        tv_np, vocab = _rank_inputs(seeded_rng, f_pad, nf, v_pad=v_pad)
        tv = torch.from_numpy(tv_np).to(cuda)
        _held_to_plain(ops.rank_files(tv, nf, vocab), tv, nf, vocab)
    nf = [int(x) for x in seeded_rng.integers(0, 5, 130)]
    tv_np = seeded_rng.integers(0, 3, (130, 9, 4)).astype(np.float32)
    vocab = [int(x) for x in seeded_rng.integers(0, 10, 130)]
    tv = torch.from_numpy(tv_np).to(cuda)
    _held_to_plain(ops.rank_files(tv, nf, vocab), tv, nf, vocab)


def test_rank_files_with_no_files_on_card(cuda):
    """A pack with no real file (F_pad 0, or every corpus empty) launches
    nothing and ranks to empty ``[V, 0]`` views; a zero-file store and a
    pack holding one rank as on the CPU."""
    kernel = _rank_dispatch("kernel")
    for f_pad in (0, 3):
        before = (kernel.value, _common.launch_counts().get("rank_files", 0))
        got = ops.rank_files(torch.ones((2, 7, f_pad), device=cuda), [0, 0],
                             [7, 5])
        assert kernel.value == before[0] + 1
        assert _common.launch_counts().get("rank_files", 0) == before[1]
        assert [r.shape for pair in got for r in pair] == [(7, 0)] * 2 + [
            (5, 0)] * 2
    g, n = compress_files([], 10)
    empty = flatten(g, 10, n)
    ids, counts = tcore.ranked_inverted_index(empty, device=cuda)
    assert ids.shape == counts.shape == (10, 0)
    assert ids.dtype == torch.int32 and counts.dtype == torch.float32
    files, vocab = _single_corpus()
    g, n = compress_files(files, vocab)
    gas = [empty, flatten(g, vocab, n)]
    for got, want in zip(
            run_batched(GrammarBatch.build(gas), "ranked_inverted_index"),
            run_batched(GrammarBatch.build(gas, device="cpu"),
                        "ranked_inverted_index")):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_unbucketed_pack_ranked_index_on_card(cuda):
    """A pack built with bucket=False (F_pad = 5, not a power of two) and
    corpora of 5, 3 and 2 files: the ranked index on the card is the CPU
    pack's, through one kernel launch."""
    rng = np.random.default_rng(29)
    gas = []
    for nf, vocab in ((5, 60), (3, 25), (2, 90)):
        files = [rng.integers(0, vocab, int(rng.integers(40, 120)))
                 for _ in range(nf)]
        g, n = compress_files(files, vocab)
        gas.append(flatten(g, vocab, n))
    gpu = GrammarBatch.build(gas, bucket=False)
    cpu = GrammarBatch.build(gas, bucket=False, device="cpu")
    assert gpu.F_pad == 5
    before = _common.launch_counts().get("rank_files", 0)
    got = run_batched(gpu, "ranked_inverted_index")
    assert _common.launch_counts()["rank_files"] == before + 1
    for g, w in zip(got, run_batched(cpu, "ranked_inverted_index")):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method", SERVE_METHODS)
def test_search_on_card(cuda, method):
    """Batched and single-corpus BM25 / TF-IDF rankings on the card equal
    the raw-file oracle bit for bit, tie orders included."""
    from repro_torch.search import batched_search, search_corpus
    corpora = _serve_corpora()
    gb = GrammarBatch.build([_grammar(f, v) for f, v in corpora])
    rare = _rare_term(*corpora[0])
    for terms in ((1, rare, 10_000, 1), (rare,), (0, 2, 3)):
        for scheme in ("bm25", "tfidf"):
            for k in (1, 3, 8):
                got = batched_search(gb, terms, k=k, scheme=scheme,
                                     method=method)
                for (files, v), (ids, sc) in zip(corpora, got):
                    want = files_search(files, v, terms, k, scheme)
                    _equal((ids, sc), want, f"{terms} {scheme} {k}")
                files, v = corpora[0]
                single = search_corpus(CompressedCorpus.build(files, v),
                                       terms, k=k, scheme=scheme,
                                       method=method)
                _equal(single, files_search(files, v, terms, k, scheme),
                       f"single {terms} {scheme} {k}")


@pytest.mark.parametrize("method", SERVE_METHODS)
def test_query_operators_on_card(cuda, method):
    """filter / agg / phrase, batched and single-corpus, on the card equal
    the raw-file oracle."""
    import repro_torch.query as tq
    corpora = _serve_corpora()
    gb = GrammarBatch.build([_grammar(f, v) for f, v in corpora])
    present = tuple(int(t) for t in corpora[0][0][0][:3])
    got = tq.batched_filter(gb, PRED, method=method)
    for (files, v), g in zip(corpora, got):
        _equal(g, files_filter(files, v, PRED), "filter")
    for op in ("sum", "max"):
        got = tq.batched_agg(gb, (1, 2, 2, 99), op, method=method)
        for (files, v), g in zip(corpora, got):
            _equal(g, files_agg(files, v, (1, 2, 2, 99), op), f"agg {op}")
    for phrase in (present, (99, 98, 97)):
        got = tq.batched_phrase(gb, phrase, method=method)
        for (files, _), g in zip(corpora, got):
            _equal(g, files_phrase(files, phrase), f"phrase {phrase}")
    files, v = corpora[0]
    cc = CompressedCorpus.build(files, v)
    _equal(tq.filter_corpus(cc, PRED, method=method),
           files_filter(files, v, PRED), "single filter")
    _equal(tq.agg_corpus(cc, (1, 2), "max", method=method),
           files_agg(files, v, (1, 2), "max"), "single agg")
    _equal(tq.phrase_corpus(cc, present, method=method),
           files_phrase(files, present), "single phrase")


def test_servers_on_card(cuda):
    """A small sync server on the card answers all 11 kinds as the CPU
    server does (and the search and query kinds as the oracle does); the
    async queue, fed from four threads, answers as the sync run."""
    import threading
    from repro_torch.serving import (SERVED_KINDS, AnalyticsServer,
                                     AsyncAnalyticsServer, Query)
    corpora = _serve_corpora()
    present = tuple(int(t) for t in corpora[0][0][0][:3])

    def queries(names):
        out = []
        for c in names:
            out += [Query(c, kind, terms=(1, 2, 99), k=3, predicate=PRED,
                          agg="max") for kind in SERVED_KINDS
                    if kind != "phrase_count"]
            out.append(Query(c, "phrase_count", terms=present))
        return out

    for method in SERVE_METHODS:
        _common.reset_launch_counts()
        srv = {dev: AnalyticsServer(max_batch=2, method=method, device=dev)
               for dev in (None, "cpu")}
        for dev, s in srv.items():
            for i, (files, v) in enumerate(corpora[:2]):
                s.register(f"c{i}", _grammar(files, v))
            s.register("store", CompressedCorpus.build(*corpora[2]))
        assert srv[None].device.type == cuda.type
        qs = queries(srv[None].corpora())
        got = srv[None].run(qs)
        want = srv["cpu"].run(qs)
        byname = dict(zip(("c0", "c1", "store"), corpora))
        for q, g, w in zip(qs, got, want):
            _equal(g, w, f"{method} {q.kind} {q.corpus}")
            files, v = byname[q.corpus]
            if q.kind == "search_bm25":
                _equal(g, files_search(files, v, q.terms, 3, "bm25"), "bm25")
            elif q.kind == "filter_count":
                _equal(g, files_filter(files, v, PRED), "filter")
            elif q.kind == "phrase_count":
                _equal(g, files_phrase(files, present), "phrase")
        assert srv[None].stats.single_calls > 0
        if method != "frontier":
            counts = _common.launch_counts()
            assert counts["ell_propagate_vector"] > 0, counts
        aq = AsyncAnalyticsServer(srv[None], idle_timeout=0.002).start()
        futs = [None] * len(qs)

        def worker(w):
            for j in range(w, len(qs), 4):
                futs[j] = aq.submit(qs[j], deadline=srv[None].clock() + 60)

        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        aq.close()
        for q, f, g in zip(qs, futs, got):
            _equal(f.result(timeout=60), g, f"async {method} {q.kind}")
        assert srv[None].stats.shed == 0


def _answer_parts(answers):
    return [p for a in answers for p in (a if isinstance(a, tuple) else (a,))]


def test_answers_land_pinned_and_the_callers_own_on_card(cuda):
    """Answers reach the host in page-locked memory, in true shapes (a
    transposed answer keeps its layout, a strided slice lands dense); the
    server counts their bytes as pinned and none as pageable; an answer
    held across a second call of its kind keeps its values and shares no
    memory with it; every kind equals the CPU server's answers."""
    from repro_torch.core.host_copy import to_host
    from repro_torch.serving import AnalyticsServer, Query
    base = torch.arange(60, dtype=torch.float32, device=cuda).view(6, 10)
    tr, sl = to_host([base.T, base[1:4, :7]])
    want = base.cpu().numpy()
    np.testing.assert_array_equal(tr, want.T)
    np.testing.assert_array_equal(sl, want[1:4, :7])
    assert tr.flags.f_contiguous and sl.flags.c_contiguous
    assert torch.from_numpy(tr).is_pinned()
    assert torch.from_numpy(sl).is_pinned()

    gas = _ragged_gas()
    names = [f"c{i}" for i in range(len(gas))]
    srv = {dev: AnalyticsServer(max_batch=len(gas), device=dev)
           for dev in (None, "cpu")}
    for s_ in srv.values():
        for name, ga in zip(names, gas):
            s_.register(name, ga)
    card = srv[None]
    assert card.device.type == "cuda"
    for kind in ANALYTICS_KINDS:
        qs = [Query(c, kind) for c in names]
        pinned0 = card.stats.host_copy_bytes["pinned"]
        first = card.run(qs)
        copied = card.stats.host_copy_bytes["pinned"] - pinned0
        parts = _answer_parts(first)
        # sequence_count too: its grams and counts are cut on the card
        assert copied == sum(p.nbytes for p in parts), kind
        assert all(torch.from_numpy(p).is_pinned() for p in parts), kind
        assert card.stats.host_copy_bytes["pageable"] == 0
        held = [p.copy() for p in parts]
        second = card.run(qs)
        for a in parts:
            assert not any(np.shares_memory(a, b)
                           for b in _answer_parts(second)), kind
        for a, h in zip(parts, held):
            np.testing.assert_array_equal(a, h, err_msg=kind)
        _equal(first, srv["cpu"].run(qs), f"{kind} card vs cpu")
        _equal(second, first, f"{kind} second call")
    assert srv["cpu"].stats.host_copy_bytes == {"pinned": 0, "pageable": 0}


def test_host_copy_falls_back_to_pageable_on_card(cuda, monkeypatch):
    """Where page-locked memory cannot be had, the copy lands in pageable
    memory, counted as such, with the same values."""
    from repro_torch.core import host_copy
    empty_like = torch.empty_like

    def no_pinned(*args, **kwargs):
        if kwargs.get("pin_memory"):
            raise RuntimeError("no page-locked memory")
        return empty_like(*args, **kwargs)

    monkeypatch.setattr(torch, "empty_like", no_pinned)
    base = torch.arange(60, dtype=torch.float32, device=cuda).view(6, 10)
    seen = []
    with host_copy.count_host_copies(lambda p, n: seen.append((p, n))):
        tr, sl = host_copy.to_host((base.T, base[1:4, :7]))
    want = base.cpu().numpy()
    np.testing.assert_array_equal(tr, want.T)
    np.testing.assert_array_equal(sl, want[1:4, :7])
    assert not torch.from_numpy(tr).is_pinned()
    assert seen == [("pageable", tr.nbytes), ("pageable", sl.nbytes)]


# ------------------------------------------- launch shapes (autotuner) --
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels import bincount as _bincount  # noqa: E402
from repro_torch.kernels import propagate as _propagate  # noqa: E402
from repro_torch.kernels import propagate_batched as _batched  # noqa: E402
from repro_torch.kernels import propagate_vector as _vector  # noqa: E402


@pytest.mark.parametrize("threads", _batched.THREADS_CANDIDATES)
def test_propagate_batched_every_launch_shape_on_card(cuda, threads,
                                                      seeded_rng):
    for n, rows, k, R in ((3, 300, 8, 500), (2, 70, 512, 90)):
        args = _on(cuda, *plan_inputs(seeded_rng, n, rows, k, R))
        _same(ell_propagate_batched_cuda(*args, threads=threads),
              ref.ell_propagate_batched_ref(*args))


@pytest.mark.parametrize("block", propagate_fused.BLOCK_CANDIDATES)
@pytest.mark.parametrize("case", FUSED_CASES)
def test_frontier_fused_every_launch_shape_on_card(cuda, block, case,
                                                   seeded_rng):
    """Each block size's cooperative grid (sized by the occupancy API for
    that block size) on the skewed and padded cases."""
    w0, ind, src, freq, max_rounds = fused_case(seeded_rng, case, 4, 1500,
                                                1024)
    args = _on(cuda, w0, ind, src, freq)
    got = propagate_fused.ell_frontier_fused_cuda(*args, max_rounds,
                                                  block=block)
    torch.cuda.synchronize()
    _same(got, ref.ell_frontier_fused_ref(*args, max_rounds))
    blocks, per_sm, sms = propagate_fused.last_grid
    assert per_sm >= 1 and 1 <= blocks <= per_sm * sms


@pytest.mark.parametrize("warps", _vector.WARPS_CANDIDATES)
@pytest.mark.parametrize("R,k,F,n", [(130, 5, 17, 2), (300, 128, 16, 2),
                                     (300, 8, 300, 1)])
def test_propagate_vector_every_launch_shape_on_card(cuda, warps, R, k, F,
                                                     n, seeded_rng):
    args = _on(cuda, *vector_inputs(seeded_rng, n, R, k, F))
    _same(_vector.ell_propagate_vector_cuda(*args, warps=warps),
          ref.ell_propagate_vector_ref(*args))


@pytest.mark.parametrize("threads", _bincount.THREADS_CANDIDATES)
def test_bincount_every_launch_shape_on_card(cuda, threads, seeded_rng):
    ids, vals = _on(cuda, *bincount_inputs(seeded_rng, 100001, 1030,
                                           case="zipf"))
    _same([weighted_bincount_cuda(ids, vals, 1030, threads=threads)],
          [ref.weighted_bincount_ref(ids, vals, 1030)])
    bids, bvals = _on(cuda, *bincount_inputs(seeded_rng, 5000, 300,
                                             case="padding_rows", rows=6))
    _same([weighted_bincount_cuda(bids.long(), bvals, 300, threads=threads)],
          [ref.weighted_bincount_ref(bids, bvals, 300)])


@pytest.mark.parametrize("threads", _propagate.THREADS_CANDIDATES)
def test_row_sums_every_launch_shape_on_card(cuda, threads, seeded_rng):
    for rows, k, R in ((1001, 5, 77), (9, 1024, 5000)):
        args = _on(cuda, *_row_sums_inputs(seeded_rng, rows, k, R, True))
        _same([ell_row_sums_cuda(*args, threads=threads)],
              [ref.ell_row_sums_ref(*args)])


@pytest.fixture
def tuned_table(tmp_path, monkeypatch):
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "tuned.json"))
    autotune.reset_table()
    yield tmp_path / "tuned.json"
    autotune.reset_table()


def test_sweeps_on_card_persist_and_feed_ops(cuda, tuned_table, seeded_rng):
    """The five sweeps and the route sweep run on the card, every
    candidate exact; the reloaded table gives ops a hit and the plain
    version's answers."""
    w, a, src, freq = pargs = _on(cuda, *plan_inputs(seeded_rng, 2, 300, 8,
                                                     500))
    fargs = _on(cuda, *batch_dags(seeded_rng, 400, 6, 2)[:4])
    vargs = _on(cuda, *vector_inputs(seeded_rng, 2, 300, 8, 16))
    hargs = _on(cuda, *bincount_inputs(seeded_rng, 20000, 700, case="zipf"))
    rargs = _on(cuda, *_row_sums_inputs(seeded_rng, 1001, 5, 77, True))
    entries = [autotune.tune_ell_batched(*pargs, repeat=2, reps=5),
               autotune.tune_ell_fused(*fargs, 12, repeat=2, reps=5),
               autotune.tune_ell_vector(*vargs, repeat=2, reps=5),
               autotune.tune_bincount(*hargs, 700, repeat=2, reps=5),
               autotune.tune_row_sums(*rargs, repeat=2, reps=5, save=True)]
    for e in entries:
        assert e["us"] == min(e["table_us"].values()) and e["us"] > 0
    autotune.reset_table()
    assert len(autotune.load_table()) == 5
    assert all(k.startswith(torch.cuda.get_device_name(cuda) + "|")
               for k in autotune.load_table())
    from repro_torch.obs import global_registry
    fam = global_registry().counter("repro_kernel_tuned_table_total", "",
                                    ("kind", "result"))
    before = fam.labels("ell_batched", "hit").value
    _same(ops.ell_propagate_batched(*pargs),
          ref.ell_propagate_batched_ref(*pargs))
    assert fam.labels("ell_batched", "hit").value == before + 1
    _same(ops.ell_frontier_fused(*fargs, 12, with_rounds=True),
          ref.ell_frontier_fused_ref(*fargs, 12))
    _same(ops.ell_propagate_vector(*vargs),
          ref.ell_propagate_vector_ref(*vargs))
    _same([ops.weighted_bincount(*hargs, 700)],
          [ref.weighted_bincount_ref(*hargs, 700)])
    _same([ops.ell_row_sums(*rargs)], [ref.ell_row_sums_ref(*rargs)])
    gas = []
    for files, vocab in ragged_corpora():
        g, nf = compress_files(files, vocab)
        gas.append(flatten(g, vocab, nf))
    e = autotune.tune_ell_vs_seg(GrammarBatch.build(gas[:4]), repeat=2)
    assert e["winner"] in ("segment_sum", "ell")


# ------------------------------------------------------------- sharding --
from repro_torch.distributed import corpus_mesh, shard_batch  # noqa: E402


def _ragged_gas():
    gas = []
    for files, vocab in ragged_corpora():
        g, nf = compress_files(files, vocab)
        gas.append(flatten(g, vocab, nf))
    return gas


def _sharded_equals_unsharded(mesh):
    from repro_torch.search.engine import batched_search
    gas = _ragged_gas()
    one = GrammarBatch.build(gas)
    sharded = shard_batch(gas, mesh)
    assert sharded.shards == mesh.size and sharded.real == len(gas)
    for sub, dev in zip(sharded.shard_packs, mesh.devices):
        assert sub.device == dev and sub.in_deg.device == dev
    for kind in ANALYTICS_KINDS:
        for method in ("frontier", "frontier_ell", "frontier_fused"):
            got = run_batched(sharded, kind, method)
            want = run_batched(one, kind, method)
            for g, w in zip(got, want):
                for x, y in zip(g if isinstance(g, tuple) else (g,),
                                w if isinstance(w, tuple) else (w,)):
                    np.testing.assert_array_equal(x, y, err_msg=f"{kind} "
                                                  f"{method}")
    got = batched_search(sharded, (1, 2, 3), k=3)
    want = batched_search(one, (1, 2, 3), k=3)
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            np.testing.assert_array_equal(x, y)
    mesh.close()


def test_sharded_pack_on_one_card_equals_unsharded(cuda):
    """Two and three shards on the one card (a device repeated in the
    mesh), each driven by its own host thread."""
    for k in (2, 3):
        _sharded_equals_unsharded(corpus_mesh((cuda,) * k))


def test_sharded_pack_over_every_card_equals_unsharded(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    mesh = corpus_mesh()
    assert mesh.size == torch.cuda.device_count()
    _sharded_equals_unsharded(mesh)


# ------------------------------------------------------------ the LM zoo --
import dataclasses  # noqa: E402

from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.serving import make_prefill_step  # noqa: E402

LM_CARD_TOL = 1e-4      # card vs CPU, same weights: * max(1, max|cpu|)
LM_PARALLEL_TOL = 3e-3  # decode vs parallel (tests/test_models.py's bound)


@pytest.fixture
def full_precision():
    """float32 matmuls without TF32, as the float32 checks need."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    assert not torch.backends.cuda.matmul.allow_tf32
    yield
    torch.set_float32_matmul_precision(old)


def _scaled_err(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max()) / max(1.0,
                                                 float(want.abs().max()))


def _lm_case(cfg, dev, B, S, rng):
    """The same weights on the CPU and the card; the card's decode of the
    prompt token by token; (cpu logits, card logits, card parallel text
    logits, card decode logits)."""
    cpu = tm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = tm.lm_from_params(cfg, tm.lm_to_params(cpu), device=dev)
    toks, extra = lm_inputs(cfg, B, S, rng)
    prefill = make_prefill_step(cfg)
    want = prefill(cpu, toks, extra_embeds=extra)
    full = prefill(card, toks, extra_embeds=extra)
    text = prefill(card, toks) if cfg.family == "vlm" else full
    cache = tm.init_cache(cfg, B, S, device=dev)
    outs = []
    with torch.no_grad():
        if cfg.family == "encdec":
            cache = tm.prefill_cross(cfg, card, cache, extra)
        for t in range(S):
            lg, cache = tm.decode_step(cfg, card, cache, toks[:, t:t + 1])
            outs.append(lg)
    return want, full, text, torch.cat(outs, dim=1)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_on_card_matches_cpu(cuda, full_precision, arch, seeded_rng):
    """Each reduced float32 arch: card logits within 1e-4 * max(1,
    max|cpu|) of the CPU's, and its decode within 3e-3 * max(1,
    max|full|) of its parallel logits (MoE without drops)."""
    over = {"moe_capacity_factor": 4.0} \
        if get_config(arch).moe_num_experts else {}
    cfg = tm.reduced(get_config(arch), dtype="float32", **over)
    want, full, text, dec = _lm_case(cfg, cuda, 2, 10, seeded_rng)
    assert full.device.type == "cuda" and bool(torch.isfinite(full).all())
    assert _scaled_err(full, want) <= LM_CARD_TOL
    assert _scaled_err(dec, text) <= LM_PARALLEL_TOL


def test_qwen2_full_width_on_card(cuda, full_precision, seeded_rng):
    """qwen2-0.5b at its published widths and depth in float32: card ==
    CPU, decode == parallel, and the greedy tokens equal wherever the top-2
    margin exceeds the bound."""
    cfg = dataclasses.replace(get_config("qwen2_05b"), dtype="float32")
    want, full, text, dec = _lm_case(cfg, cuda, 2, 8, seeded_rng)
    assert _scaled_err(full, want) <= LM_CARD_TOL
    assert _scaled_err(dec, text) <= LM_PARALLEL_TOL
    bound = LM_PARALLEL_TOL * max(1.0, float(text.abs().max()))
    margins = [torch.topk(x, 2, dim=-1).values for x in (text, dec)]
    margin = torch.minimum(*[m[..., 0] - m[..., 1] for m in margins])
    flips = text.argmax(-1) != dec.argmax(-1)
    assert bool((margin[flips] < bound).all())


# ------------------------------------------------------- the LM training --
from repro_torch import training as tt  # noqa: E402
from repro_torch.checkpoint import (flatten_with_paths,  # noqa: E402
                                    restore_checkpoint, save_checkpoint)

TRAIN_LOSS_RTOL = 1e-5   # card vs CPU loss, relative
TRAIN_GRAD_TOL = 1e-4    # card vs CPU gradients: * max(1, max|cpu leaf|)
TRAIN_STEP_TOL = 5e-3    # parameters after one step (tests/test_training.py)
TRAIN_FAMILIES = ["qwen2_05b", "qwen2_moe_a27b", "llama4_maverick",
                  "jamba_v01_52b", "mamba2_27b", "whisper_large_v3",
                  "pixtral_12b"]


def _train_batch(cfg, B, S, rng):
    toks, extra = lm_inputs(cfg, B, S, rng)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(rng.integers(
                 0, cfg.vocab_size, (B, S)).astype(np.int32))}
    if extra is not None:
        batch["extra_embeds"] = torch.from_numpy(extra)
    return batch


def _to(batch, dev):
    return {k: v.to(dev) for k, v in batch.items()}


def _loss_grads_both(cfg, dev, batch, remat=True):
    """The same host-drawn weights on the CPU and the card: (models,
    losses, gradient trees in the JAX layout)."""
    cpu = tm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = tm.lm_from_params(cfg, tm.lm_to_params(cpu), device=dev)
    losses, grads = [], []
    for model in (cpu, card):
        model.requires_grad_(True)
        loss, _ = tt.make_loss_fn(cfg, remat=remat)(
            model, _to(batch, model.device))
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append(tm.lm_grads(model))
        model.zero_grad(set_to_none=True)
    return (cpu, card), losses, grads


def _grads_close(got, want):
    want = dict(flatten_with_paths(want))
    got = dict(flatten_with_paths(got))
    assert list(got) == list(want)
    for k, w in want.items():
        assert _scaled_err(got[k], w) <= TRAIN_GRAD_TOL, k


@pytest.mark.parametrize("arch", TRAIN_FAMILIES)
def test_loss_and_grads_on_card_match_cpu(cuda, full_precision, arch,
                                          seeded_rng):
    """One reduced float32 arch of each family: the card's loss within
    1e-5 relative of the CPU's, every gradient leaf within 1e-4 of
    scale."""
    cfg = tm.reduced(get_config(arch), dtype="float32")
    _, losses, grads = _loss_grads_both(
        cfg, cuda, _train_batch(cfg, 2, 12, seeded_rng))
    assert abs(losses[1] - losses[0]) <= TRAIN_LOSS_RTOL * abs(losses[0])
    _grads_close(grads[1], grads[0])


def test_qwen2_train_step_on_card_matches_cpu(cuda, full_precision,
                                              seeded_rng):
    """qwen2-0.5b at its published widths, two layers, float32, B=2
    S=64: loss and gradients as above (``remat=True``), then one AdamW
    step (lr 1e-2, two microbatches) to parameters within 5e-3."""
    cfg = dataclasses.replace(get_config("qwen2_05b"), dtype="float32",
                              num_layers=2)
    batch = _train_batch(cfg, 2, 64, seeded_rng)
    models, losses, grads = _loss_grads_both(cfg, cuda, batch)
    assert abs(losses[1] - losses[0]) <= TRAIN_LOSS_RTOL * abs(losses[0])
    _grads_close(grads[1], grads[0])
    opt = tt.AdamW(lr=1e-2)
    after = []
    for model in models:
        step = tt.make_train_step(cfg, opt, remat=True, microbatches=2)
        model, st, met = step(model, opt.init(tm.lm_to_params(model)),
                              _to(batch, model.device))
        assert np.isfinite(float(met["loss"])) and int(st.count) == 1
        after.append(dict(flatten_with_paths(tm.lm_to_params(model))))
    for k, w in after[0].items():
        assert float((after[1][k].cpu() - w).abs().max()) <= TRAIN_STEP_TOL


def test_compression_on_card_equals_cpu(cuda, seeded_rng):
    """``topk_compress`` (error feedback over three steps) and
    ``int8_roundtrip`` of the same gradients: the card's equal the
    CPU's, bit for bit."""
    g = {"w": torch.from_numpy(seeded_rng.normal(size=(300, 7)).astype(
        np.float32)),
         "b": [torch.from_numpy(np.round(seeded_rng.normal(size=999) * 8)
                                .astype(np.float32)),
               torch.from_numpy(seeded_rng.normal(size=5).astype(
                   np.float32)).to(torch.bfloat16),
               # a gradient-sized leaf: a quotient one rounding off
               # flips an int8 value somewhere among 2M entries
               torch.from_numpy(seeded_rng.normal(size=(1024, 2048))
                                .astype(np.float32))]}
    gc = {"w": g["w"].to(cuda), "b": [t.to(cuda) for t in g["b"]]}
    e, ec = tt.init_error(g), tt.init_error(gc)
    for k_frac in (0.01, 0.1, 0.3):
        s, e = tt.topk_compress(g, e, k_frac)
        sc, ec = tt.topk_compress(gc, ec, k_frac)
        for (_, a), (_, b) in zip(flatten_with_paths((s, e)),
                                  flatten_with_paths((sc, ec))):
            assert torch.equal(b.cpu(), a)
    for (_, a), (_, b) in zip(flatten_with_paths(tt.int8_roundtrip(g)),
                              flatten_with_paths(tt.int8_roundtrip(gc))):
        assert torch.equal(b.cpu(), a)


def test_bf16_checkpoint_from_card_restores_bit_exact(cuda, tmp_path,
                                                      seeded_rng):
    w = torch.from_numpy(seeded_rng.integers(0, 1 << 16, (4, 33)).astype(
        np.uint16).view(np.int16)).view(torch.bfloat16)
    save_checkpoint(str(tmp_path), 1, {"w": w.to(cuda)})
    got, _, _ = restore_checkpoint(str(tmp_path), {"w": 0})
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), w.view(torch.int16))
