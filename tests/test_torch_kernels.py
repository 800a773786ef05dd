"""The port's kernel modules against the JAX package, on the CPU.

For each of the five kernels, numpy-seeded inputs go through the port's
plain torch version (the path every CPU tensor takes) and through the JAX
package twice: its jnp reference (``repro.kernels.ref``) and its Pallas
kernel in interpret mode.  Integer-valued inputs — every value on the
engine path — must match exactly; arbitrary floats are summed in another
order, so they get rtol=atol=1e-6 (rtol=1e-5 / atol=1e-4 for the row sums,
the tolerance of the JAX package's own tests of that kernel), and the
vector round's wide plans, whose rows sum up to hundreds of terms, the
float32 bound of an m-term sum in any order.  The CUDA
kernels themselves run only on the card (tests/test_torch_gpu.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.bincount import weighted_bincount_pallas
from repro.kernels.propagate import ell_row_sums_pallas
from repro.kernels.propagate_batched import ell_propagate_batched_pallas
from repro.kernels.propagate_fused import ell_frontier_fused_pallas
from repro.kernels.propagate_vector import ell_propagate_vector_pallas
from repro_torch.kernels import _common, ops, ref

from _torch_inputs import (batch_dags, bincount_inputs, fused_case,
                           plan_inputs, vector_case, vector_inputs)

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)
EPS = float(np.finfo(np.float32).eps)
ROW_SUMS_TOL = dict(rtol=1e-5, atol=1e-4)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _check(got, want, integer: bool, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **tol)


# ------------------------------------------------------------ bincount --
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("n,nbins,case", [
    (700, 300, "uniform"), (64, 8, "uniform"), (1500, 1030, "uniform"),
    (1001, 300, "zipf"), (1003, 517, "padding_rows"),
    (37, 8, "out_of_range")])
def test_bincount_matches_jax(n, nbins, case, integer, seeded_rng):
    """Uniform ids, Zipf-skewed ids with hot bins, a half made only of
    padding with zero values, and ids >= nbins or < 0 (n not a multiple
    of 4)."""
    ids, vals = bincount_inputs(seeded_rng, n, nbins, integer, case)
    got = ref.weighted_bincount_ref(*_t(ids, vals), nbins)
    _check(got, jref.weighted_bincount_ref(*_j(ids, vals), nbins), integer)
    _check(got, weighted_bincount_pallas(*_j(ids, vals), nbins,
                                         interpret=True), integer)
    _check(ops.weighted_bincount(*_t(ids, vals), nbins),
           jops.weighted_bincount(*_j(ids, vals), nbins), integer)


@pytest.mark.parametrize("n,t,nbins,case", [
    (3, 50, 40, "uniform"), (5, 200, 1 << 20, "uniform"),
    (6, 1001, 300, "zipf"), (4, 37, 1 << 20, "padding_rows"),
    (9, 1001, 1 << 19, "zipf"), (7, 203, 61, "out_of_range")])
def test_bincount_batched_matches_jax(n, t, nbins, case, seeded_rng):
    """The batch across the row-chunk crossover above
    BINCOUNT_BATCH_FLAT_LIMIT (4 x 2^20 bins is one chunk, 5 x 2^20 and
    9 x 2^19 are not), Zipf-skewed ids, rows made only of padding, and ids
    out of range: the wrapper, and the plain version's one-call batch
    form, equal the JAX package's flat-offset batching and its per-row
    reference."""
    if case == "uniform":
        ids = seeded_rng.integers(-1, min(nbins, 500), (n, t)).astype(
            np.int32)
        vals = seeded_rng.integers(0, 9, (n, t)).astype(np.float32)
    else:
        ids, vals = bincount_inputs(seeded_rng, t, nbins, True, case, rows=n)
    want = jops.weighted_bincount_batched(*_j(ids, vals), nbins)
    _check(ops.weighted_bincount_batched(*_t(ids, vals), nbins), want, True)
    one_call = ref.weighted_bincount_ref(*_t(ids, vals), nbins)
    _check(one_call, want, True)
    for i in range(n):
        _check(one_call[i], jref.weighted_bincount_ref(*_j(ids[i], vals[i]),
                                                       nbins), True)


def test_bincount_empty_and_bad_shapes():
    z = ops.weighted_bincount(torch.zeros(0, dtype=torch.int32),
                              torch.zeros(0), 5)
    assert z.shape == (5,) and not z.any()
    zb = ops.weighted_bincount_batched(torch.zeros((3, 0), dtype=torch.int32),
                                       torch.zeros((3, 0)), 4)
    assert zb.shape == (3, 4)
    with pytest.raises(ValueError):
        ops.weighted_bincount_batched(torch.zeros((2, 3), dtype=torch.int32),
                                      torch.zeros((2, 4)), 4)


# --------------------------------------------------------- ell_row_sums --
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("rows,w,R", [(64, 1, 10), (100, 4, 50),
                                      (1000, 16, 333), (5000, 8, 4000),
                                      (257, 3, 129)])
def test_row_sums_matches_jax(rows, w, R, integer, seeded_rng):
    """The shapes of the JAX package's own row-sum tests."""
    src = seeded_rng.integers(0, R, (rows, w)).astype(np.int32)
    freq = seeded_rng.integers(0, 5, (rows, w)).astype(np.float32)
    wts = (seeded_rng.integers(0, 1000, R) if integer
           else seeded_rng.normal(size=R)).astype(np.float32)
    got = ref.ell_row_sums_ref(*_t(wts, src, freq))
    _check(got, jref.ell_row_sums_ref(*_j(wts, src, freq)), integer,
           ROW_SUMS_TOL)
    _check(got, ell_row_sums_pallas(*_j(wts, src, freq), interpret=True),
           integer, ROW_SUMS_TOL)
    _check(ops.ell_row_sums(*_t(wts, src, freq)), got, True)


def test_row_sums_empty_and_bad_shapes():
    got = ops.ell_row_sums(torch.ones(5),
                           torch.zeros((0, 3), dtype=torch.int32),
                           torch.zeros((0, 3)))
    want = jops.ell_row_sums(jnp.ones(5), jnp.zeros((0, 3), jnp.int32),
                             jnp.zeros((0, 3)))
    _check(got, want, True)
    with pytest.raises(ValueError):
        ops.ell_row_sums(torch.ones(5), torch.zeros((4, 3), dtype=torch.int32),
                         torch.zeros((4, 2)))
    with pytest.raises(ValueError):
        ops.ell_row_sums(torch.ones((1, 5)),
                         torch.zeros((4, 3), dtype=torch.int32),
                         torch.zeros((4, 3)))


# ---------------------------------------------------- propagate_batched --
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("n,rows,k,R", [(1, 64, 1, 10), (3, 100, 4, 50),
                                        (2, 300, 16, 333)])
def test_propagate_batched_matches_jax(n, rows, k, R, integer, seeded_rng):
    inputs = plan_inputs(seeded_rng, n, rows, k, R, integer)
    d, s = ref.ell_propagate_batched_ref(*_t(*inputs))
    jd, js = jref.ell_propagate_batched_ref(*_j(*inputs))
    pd, ps = ell_propagate_batched_pallas(*_j(*inputs), br=64,
                                          interpret=True)
    for want_d, want_s in ((jd, js), (pd, ps)):
        _check(d, want_d, integer)
        _check(s, want_s, True)             # seen counts 0/1 masks: exact
    od, os_ = ops.ell_propagate_batched(*_t(*inputs))
    _check(od, d, True)
    _check(os_, s, True)


def test_propagate_batched_validation_and_empty():
    with pytest.raises(ValueError):
        ops.ell_propagate_batched(torch.zeros((2, 3)), torch.zeros((2, 3)),
                                  torch.zeros((2, 3, 1), dtype=torch.int32),
                                  torch.zeros((2, 3, 2)))
    d, s = ops.ell_propagate_batched(torch.zeros((2, 3)), torch.zeros((2, 3)),
                                     torch.zeros((2, 0, 4), dtype=torch.int32),
                                     torch.zeros((2, 0, 4)))
    assert d.shape == (2, 0) and s.shape == (2, 0)


# ----------------------------------------------------- propagate_vector --
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("R,k,F,n", [(64, 3, 4, 1), (130, 5, 17, 2),
                                     (300, 2, 129, 1)])
def test_propagate_vector_matches_jax(R, k, F, n, integer, seeded_rng):
    inputs = vector_inputs(seeded_rng, n, R, k, F, integer)
    d, s = ref.ell_propagate_vector_ref(*_t(*inputs))
    jd, js = jref.ell_propagate_vector_ref(*_j(*inputs))
    pd, ps = ell_propagate_vector_pallas(*_j(*inputs), interpret=True)
    for want_d, want_s in ((jd, js), (pd, ps)):
        _check(d, want_d, integer)
        _check(s, want_s, True)
    od, os_ = ops.ell_propagate_vector(*_t(*inputs))
    _check(od, d, True)
    _check(os_, s, True)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("case,n,R,k,F", [
    ("wide_interleaved", 2, 96, 128, 16), ("long_rows", 1, 80, 512, 4),
    ("hot_sources", 2, 70, 128, 17), ("all_inactive", 1, 64, 128, 33),
    ("wide_interleaved", 1, 64, 512, 300), ("long_rows", 1, 64, 128, 1)])
def test_propagate_vector_cases_match_jax(case, n, R, k, F, integer,
                                          seeded_rng):
    """Wide plans (K=128, 512) with the real entries among the padding,
    rows of more than 32 real entries, hot sources shared by many rows, an
    all-inactive round, fractional ``active`` and F in {1, 4, 16, 17, 33,
    300}: the plain version equals the JAX reference and the
    interpret-mode Pallas kernel."""
    inputs = vector_case(seeded_rng, case, n, R, k, F, integer)
    d, s = ops.ell_propagate_vector(*_t(*inputs))
    jd, js = jref.ell_propagate_vector_ref(*_j(*inputs))
    pd, ps = ell_propagate_vector_pallas(*_j(*inputs), interpret=True)
    W, a, src, freq = inputs
    # floats: rows of up to 3k/4 terms summed in another order are held
    # to the float32 bound of an m-term sum in any order,
    # 2 * m * eps * sum(|terms|), with m the row's real entries
    abs_sum, _ = ref.ell_propagate_vector_ref(*_t(np.abs(W), a, src,
                                                  np.abs(freq)))
    m = torch.from_numpy((freq != 0).sum(-1, keepdims=True))
    bound = (2 * m * EPS * abs_sum).numpy()
    for want_d, want_s in ((jd, js), (pd, ps)):
        if integer:
            _check(d, want_d, True)
        else:
            assert (np.abs(d.numpy() - np.asarray(want_d)) <= bound).all()
        _check(s, want_s, True)        # dyadic active: exact in any order
    if case == "all_inactive":
        assert not d.any() and not s.any()


def test_propagate_vector_validation_and_empty():
    with pytest.raises(ValueError):
        ops.ell_propagate_vector(torch.zeros((2, 3)), torch.zeros((2, 3)),
                                 torch.zeros((2, 3, 1), dtype=torch.int32),
                                 torch.zeros((2, 3, 1)))
    d, s = ops.ell_propagate_vector(torch.zeros((2, 3, 5)),
                                    torch.zeros((2, 3)),
                                    torch.zeros((2, 0, 4), dtype=torch.int32),
                                    torch.zeros((2, 0, 4)))
    assert d.shape == (2, 0, 5) and s.shape == (2, 0)


# ------------------------------------------------------ propagate_fused --
@pytest.mark.parametrize("R,max_deg,n", [(40, 3, 1), (130, 5, 3),
                                         (257, 2, 4)])
def test_frontier_fused_matches_jax(R, max_deg, n, seeded_rng):
    """Weights AND round counts equal the JAX reference, the interpret-mode
    Pallas kernel, and the exact DAG replay; extra rounds are no-ops."""
    w0, ind, src, freq, want, depth = batch_dags(seeded_rng, R, max_deg, n)
    rounds_bound = depth + 1
    w, rounds = ref.ell_frontier_fused_ref(*_t(w0, ind, src, freq),
                                           rounds_bound)
    np.testing.assert_array_equal(w.numpy(), want)
    jw, jr = jref.ell_frontier_fused_ref(*_j(w0, ind, src, freq),
                                         rounds_bound, with_rounds=True)
    pw, pr = ell_frontier_fused_pallas(*_j(w0, ind, src, freq),
                                       rounds_bound, br=64, interpret=True)
    for want_w, want_r in ((jw, jr), (pw, pr)):
        _check(w, want_w, True)
        _check(rounds, want_r, True)
    ew, er = ops.ell_frontier_fused(*_t(w0, ind, src, freq),
                                    rounds_bound + 3, with_rounds=True)
    _check(ew, w, True)
    _check(er, rounds, True)


@pytest.mark.parametrize("case,n,R,k", [
    ("interleaved_padding", 3, 130, 12), ("skewed_rows", 2, 300, 64),
    ("cut_max_rounds", 2, 257, 6), ("inconsistent_in_deg", 2, 200, 8)])
def test_frontier_fused_edge_plans_match_jax(case, n, R, k, seeded_rng):
    """Plans the CUDA kernel treats specially (padding anywhere in a row,
    long skewed rows, a cut round loop, rules that never become ready):
    the plain version's weights and round counts equal the JAX reference
    and the interpret-mode Pallas kernel."""
    w0, ind, src, freq, rounds_bound = fused_case(seeded_rng, case, n, R, k)
    w, rounds = ops.ell_frontier_fused(*_t(w0, ind, src, freq),
                                       rounds_bound, with_rounds=True)
    jw, jr = jref.ell_frontier_fused_ref(*_j(w0, ind, src, freq),
                                         rounds_bound, with_rounds=True)
    pw, pr = ell_frontier_fused_pallas(*_j(w0, ind, src, freq),
                                       rounds_bound, br=64, interpret=True)
    for want_w, want_r in ((jw, jr), (pw, pr)):
        _check(w, want_w, True)
        _check(rounds, want_r, True)
    if case == "cut_max_rounds":
        assert int(rounds.max()) == rounds_bound
    if case == "inconsistent_in_deg":
        assert bool((w.numpy() == 0).any())       # unreached rules stay 0


def test_frontier_fused_empty_plan():
    w0 = torch.ones((2, 3))
    w, r = ops.ell_frontier_fused(w0, torch.zeros((2, 3)),
                                  torch.zeros((2, 3, 0), dtype=torch.int32),
                                  torch.zeros((2, 3, 0)), 4, with_rounds=True)
    assert torch.equal(w, w0) and r.tolist() == [0, 0]


# ------------------------------------------------------------- routing --
def test_constants_match_jax():
    for name in ("BINCOUNT_BATCH_FLAT_LIMIT", "ELL_BATCH_MIN_ROWS",
                 "ELL_BATCH_MAX_WIDTH", "ELL_BATCH_MIN_FILL",
                 "ELL_PLAN_MAX_ENTRIES", "ELL_FUSED_MAX_RULES"):
        assert getattr(ops, name) == getattr(jops, name), name


@pytest.mark.parametrize("n", [1, 4, 16])
@pytest.mark.parametrize("rows", [8, 64, 1 << 13, 1 << 19])
@pytest.mark.parametrize("k", [1, 64, 4096])
def test_predicates_match_jax(n, rows, k):
    """Every routing predicate resolves as in the JAX package (no tuned
    table there either: the test session points it at a missing file)."""
    for edges in (0, rows, n * rows * k // 200, n * rows * k):
        assert (ops.ell_batched_use_ref(edges, n, rows, k)
                == jops.ell_batched_use_ref(edges, n, rows, k))
    assert ops.ell_fused_use_kernel(rows) == jops.ell_fused_use_kernel(rows)
    for f in (1, 64):
        assert (ops.ell_vector_plan_ok(n, rows, k, f)
                == jops.ell_vector_plan_ok(n, rows, k, f))
    assert (ops.bincount_batch_rows(n, rows * k)
            == jops.bincount_batch_rows(n, rows * k))


def test_cpu_tensors_take_the_plain_path(seeded_rng):
    """A CPU tensor never reaches a kernel: launch counts stay put."""
    before = _common.launch_counts()
    inputs = plan_inputs(seeded_rng, 2, 70, 4, 30)
    ops.ell_propagate_batched(*_t(*inputs))
    ops.ell_propagate_vector(*_t(*vector_inputs(seeded_rng, 2, 30, 2, 3)))
    ops.weighted_bincount(*_t(*bincount_inputs(seeded_rng, 100, 20)), 20)
    w, _, src, freq = plan_inputs(seeded_rng, 1, 70, 4, 30)
    ops.ell_row_sums(*_t(w[0], src[0], freq[0]))
    assert _common.launch_counts() == before
