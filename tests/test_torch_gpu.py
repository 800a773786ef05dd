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
                           vector_case, vector_inputs)

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
