"""The ranked inverted index's file ranking (``kernels.ops.rank_files``) on
the CPU, against a numpy stable argsort and the JAX package.

``rank_files`` takes the per-file term vector word-major, ``[N, V_pad,
F_pad]``, as its segment sum writes it, with each file's root words added
at ``word * F_pad + file`` (``batch.word_major_term_vector``, which the
packed engine and the single-corpus path share).  Every count is integer-valued float32, so the rankings and
counts must be bit-equal to the JAX package's ``jnp.argsort`` ones, on the
packed engine (corpora of different file counts, bucketed and not) and on
the single-corpus path.  Everything runs on the CPU, so ``rank_files``
takes its plain version; the kernel is held to it in
tests/test_torch_gpu.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import batch as jbatch
from repro.core.grammar import flatten as jflatten
from repro.core.sequitur import compress_files as jcompress_files
from repro_torch.core import GrammarArrays, GrammarBatch
from repro_torch.core import batch as tbatch
from repro_torch.kernels import ops, ref
from repro_torch.obs import global_registry

from _oracle import oracle
from _torch_inputs import ragged_corpora

torch.set_num_threads(1)

FIELDS = [f.name for f in dataclasses.fields(GrammarArrays)]


def _dispatch(path: str):
    return global_registry().counter(
        "repro_kernel_dispatch_total", "",
        ("decision", "path")).labels("rank_files", path)


def _numpy_ranked(tv: np.ndarray, nf: int, v: int):
    """A word's files by count descending, ties to the lower file id."""
    x = tv[:v, :nf]
    order = np.argsort(-x, axis=1, kind="stable")
    return order.astype(np.int32), np.take_along_axis(x, order, axis=1)


def _term_vectors(rng, f_pad: int, num_files, vocab, v_pad: int = 48):
    """Integer-valued counts with heavy ties and many zeros, a word that
    no file holds, and junk in the padded files and words (which the
    ranking must never read)."""
    n = len(num_files)
    tv = rng.integers(0, 4, (n, v_pad, f_pad)).astype(np.float32)
    tv[rng.random(tv.shape) < 0.5] = 0.0
    for i, (nf, v) in enumerate(zip(num_files, vocab)):
        if v:
            tv[i, v // 2, :nf] = 0.0
        tv[i, :, nf:] = 99.0
        tv[i, v:, :] = 77.0
    return tv


RANK_CASES = [(1, (1, 1, 1)), (2, (2, 1, 2)), (4, (3, 4, 1)),
              (5, (5, 3, 2)), (8, (5, 3, 8)), (16, (16, 5, 9)),
              (32, (31, 17, 3, 5)), (64, (33, 64, 17))]


@pytest.mark.parametrize("f_pad,num_files", RANK_CASES,
                         ids=[f"F{f}" for f, _ in RANK_CASES])
def test_plain_rank_files_is_a_stable_argsort(f_pad, num_files,
                                              seeded_rng):
    vocab = [int(seeded_rng.integers(1, 48)) for _ in num_files]
    tv = _term_vectors(seeded_rng, f_pad, num_files, vocab)
    plain = _dispatch("plain")
    before = plain.value
    got = ops.rank_files(torch.from_numpy(tv), num_files, vocab)
    assert plain.value == before + 1
    assert len(got) == len(num_files)
    for i, ((ids, counts), nf, v) in enumerate(zip(got, num_files, vocab)):
        want_ids, want_counts = _numpy_ranked(tv[i], nf, v)
        assert ids.dtype == torch.int32 and counts.dtype == torch.float32
        assert ids.shape == counts.shape == (v, nf)
        np.testing.assert_array_equal(ids.numpy(), want_ids)
        np.testing.assert_array_equal(counts.numpy(), want_counts)
        # the word no file holds ranks its files in their order
        np.testing.assert_array_equal(ids[v // 2].numpy(), np.arange(nf))


def test_rank_files_refuses_a_flat_term_vector():
    with pytest.raises(ValueError, match="V_pad, F_pad"):
        ops.rank_files(torch.zeros(4, 3), [3], [4])


def _jax_grammar(files, vocab):
    g, nf = jcompress_files(files, vocab)
    return jflatten(g, vocab, nf)


@pytest.fixture(scope="module")
def grammars():
    """(JAX grammars, the port's copies) of corpora with 1, 4, 6, 2 and 3
    files (the last one's files empty)."""
    jgas = [_jax_grammar(files, v) for files, v in ragged_corpora(21)]
    tgas = [GrammarArrays.from_numpy({n: getattr(ga, n) for n in FIELDS})
            for ga in jgas]
    return jgas, tgas


def _same(got, want):
    assert len(got) == len(want)
    for (gi, gc), (wi, wc) in zip(got, want):
        for g, w in ((gi, wi), (gc, wc)):
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("bucket", [True, False])
@pytest.mark.parametrize("method", ["frontier", "leveled_ell"])
def test_batched_ranked_index_matches_jax(grammars, method, bucket):
    """The pack's ranked index, from the word-major term vector, equals
    the JAX package's over corpora of different file counts: F_pad 8
    bucketed, 6 not; one ranking call a request."""
    jgas, tgas = grammars
    gb = GrammarBatch.build(tgas, bucket=bucket, device="cpu")
    assert gb.F_pad == (8 if bucket else 6)
    plain = _dispatch("plain")
    before = plain.value
    got = tbatch.batched_ranked_inverted_index(gb, method=method)
    assert plain.value == before + 1
    want = jbatch.batched_ranked_inverted_index(
        jbatch.GrammarBatch.build(jgas, bucket=bucket), method=method)
    _same(got, want)
    _same(tbatch.run_batched(gb, "ranked_inverted_index", method), want)


def test_store_ranked_index_matches_jax_and_oracle(grammars):
    """The single-corpus path ranks its word-major ``[V, F]`` term vector
    with the same op, and equals the JAX package and the oracle."""
    jgas, tgas = grammars
    plain = _dispatch("plain")
    for jga, tga in zip(jgas, tgas):
        before = plain.value
        got = tcore.ranked_inverted_index(tga, device="cpu")
        assert plain.value == before + 1
        _same([got], [jcore.ranked_inverted_index(jga)])
        ids, counts = oracle(jga, "ranked_inverted_index")
        np.testing.assert_array_equal(got[0].numpy(), ids)
        np.testing.assert_array_equal(got[1].numpy(), counts)


def test_plain_rank_files_matches_jax_argsort(grammars):
    """The pack's word-major term vector is the JAX package's ``[F, V]``
    one transposed, and the plain ``rank_files`` over it is the JAX
    package's argsort."""
    jgas, tgas = grammars
    gb = GrammarBatch.build(tgas, device="cpu")
    tv = tbatch.word_major_term_vector(gb,
                                       tbatch.batched_per_file_weights(gb))
    jgb = jbatch.GrammarBatch.build(jgas)
    np.testing.assert_array_equal(tv.transpose(1, 2).numpy(),
                                  np.asarray(jbatch.batched_term_vector(jgb)))
    _same(ref.rank_files_ref(tv, gb.num_files, gb.vocab_sizes),
          jbatch.batched_ranked_inverted_index(jgb))


@pytest.fixture(scope="module")
def no_files():
    """(JAX grammar, the port's copy) of a corpus with no files."""
    jga = _jax_grammar([], 10)
    assert jga.num_files == 0
    return jga, GrammarArrays.from_numpy({n: getattr(jga, n)
                                          for n in FIELDS})


def test_zero_file_store_ranks_empty(no_files):
    """A corpus with no files ranks to empty ``[V, 0]`` answers on the
    single-corpus path, as in the JAX package."""
    jga, tga = no_files
    ids, counts = tcore.ranked_inverted_index(tga, device="cpu")
    assert ids.dtype == torch.int32 and counts.dtype == torch.float32
    assert ids.shape == counts.shape == (10, 0)
    _same([(ids, counts)], [jcore.ranked_inverted_index(jga)])
    assert tbatch.word_major_term_vector(
        GrammarBatch.build([tga], device="cpu"),
        torch.zeros((1, tga.num_rules, 0))).shape == (1, 16, 0)


def test_pack_with_a_zero_file_corpus_matches_jax(grammars, no_files):
    """A zero-file corpus among others in one pack ranks to ``[V, 0]``
    and leaves the others' rankings as the JAX package's."""
    jgas, tgas = grammars
    jgas, tgas = [no_files[0]] + jgas[:2], [no_files[1]] + tgas[:2]
    got = tbatch.batched_ranked_inverted_index(
        GrammarBatch.build(tgas, device="cpu"))
    assert got[0][0].shape == (10, 0)
    _same(got, jbatch.batched_ranked_inverted_index(
        jbatch.GrammarBatch.build(jgas)))
