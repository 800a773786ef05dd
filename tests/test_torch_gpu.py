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

from repro_torch.core import (ANALYTICS_KINDS, METHODS, GrammarBatch,
                              compress_files, flatten, run_batched)
from repro_torch.kernels import _common, ops, ref
from repro_torch.kernels.bincount import weighted_bincount_cuda
from repro_torch.kernels.propagate_batched import ell_propagate_batched_cuda

from _torch_inputs import (batch_dags, bincount_inputs, plan_inputs,
                           ragged_corpora, vector_inputs)

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
