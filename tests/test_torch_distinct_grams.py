"""The distinct l-grams of ``sequence_count``, extracted on the device.

``core.batch.distinct_grams`` keeps, on the pack's device, the first
window of every segment whose count is above 0, compacts those by their
ranks (the host reads only each row's count of them) and copies only the
grams and their counts to the host.  It
replaced a host pass over every sorted window (``host_extraction`` below,
the code it replaced): here both run on the same sorted windows and must
agree bit for bit, dtypes included, and both must equal the
decompress-then-scan oracle (``tests/_oracle.py``), for the batched engine
over a ragged pack (a corpus with no windows among them) and over a
sharded pack's padding rows, for l = 2 to 5, for windows of zero weight
that share their tokens with a counted gram, and for the single-corpus
store path (``core.sequence.sequence_count``).  On the CPU nothing is
copied; the card test ``test_answers_land_pinned_and_the_callers_own_on_card``
holds the bytes copied to the answers' bytes.
"""

import numpy as np
import pytest
import torch

import repro_torch.serving as ts
from repro_torch.core import GrammarBatch, batch as tbatch
from repro_torch.core import sequence as tsequence
from repro_torch.data import CompressedCorpus
from repro_torch.distributed import corpus_mesh, shard_batch

from _oracle import assert_result_equal, oracle_sequence_count
from _torch_inputs import ragged_corpora

torch.set_num_threads(1)


def host_extraction(stok, newseg, seg, counts):
    """The host pass ``distinct_grams`` replaced: every sorted window on
    the host, the first window of each segment found by ``searchsorted``,
    segments of zero count dropped."""
    stok_h, seg_h, counts_h = stok.numpy(), seg.numpy(), counts.numpy()
    out = []
    for i in range(stok_h.shape[0]):
        n_seg = int(seg_h[i, -1]) + 1
        first_idx = np.searchsorted(seg_h[i], np.arange(n_seg), "left")
        grams = stok_h[i][first_idx]
        cnts = counts_h[i, :n_seg]
        keep = cnts > 0
        out.append((grams[keep].astype(np.int32), cnts[keep]))
    return out


@pytest.fixture
def extractions(monkeypatch):
    """Every ``distinct_grams`` call of the test, each held to the host
    extraction on the same windows; yields the list of their answers."""
    real, seen = tbatch.distinct_grams, []

    def checked(stok, newseg, seg, counts):
        got = real(stok, newseg, seg, counts)
        want = host_extraction(stok, newseg, seg, counts)
        assert len(got) == len(want)
        for (g, c), (wg, wc) in zip(got, want):
            assert g.dtype == wg.dtype and c.dtype == wc.dtype
            np.testing.assert_array_equal(g, wg)
            np.testing.assert_array_equal(c, wc)
        seen.append(got)
        return got

    monkeypatch.setattr(tbatch, "distinct_grams", checked)
    return seen


@pytest.fixture(scope="module")
def gas():
    """A ragged set: wildly different sizes, a single-file corpus and an
    empty one (no windows at any l), and one of four files too short for
    any window of length 2 or more."""
    out = [CompressedCorpus.build(files, v).ga
           for files, v in ragged_corpora(7)]
    short = [np.array([3]), np.array([4]), np.array([3]), np.array([5])]
    return out + [CompressedCorpus.build(short, 8).ga]


@pytest.mark.parametrize("l", [2, 3, 4, 5])
def test_ragged_pack_equals_host_extraction_and_oracle(gas, extractions, l):
    gb = GrammarBatch.build(gas, device="cpu")
    got = tbatch.batched_sequence_count(gb, l=l, method="frontier")
    assert len(extractions) == 1 and len(got) == len(gas)
    for i, ga in enumerate(gas):
        assert_result_equal(got[i], oracle_sequence_count(ga, l),
                            "sequence_count", f"corpus {i}, l={l}")
    assert got[-1][0].shape == (0, l) and got[-1][1].shape == (0,)
    assert got[-2][0].shape == (0, l)               # the empty corpus


def test_sharded_padding_rows(gas, extractions):
    """Three shards over five corpora: the last shard's second row is
    padding (a repeat of a real grammar), extracted and then dropped."""
    mesh = corpus_mesh(("cpu",) * 3)
    got = tbatch.run_batched(shard_batch(gas[:5], mesh), "sequence_count",
                             l=3)
    assert len(extractions) == 3 and len(got) == 5
    assert [len(rows) for rows in extractions] == [2, 2, 2]
    for i, ga in enumerate(gas[:5]):
        assert_result_equal(got[i], oracle_sequence_count(ga, 3),
                            "sequence_count", f"corpus {i}")


def test_zero_weight_windows_sharing_a_counted_gram(extractions):
    """Invalid windows (weight 0) with the tokens of a counted gram sort
    into its segment, some ahead of the counted window; a segment of
    zero-weight windows alone, and a row with no weight at all, give
    nothing."""
    wtok = torch.tensor([[[1, 2, 3], [4, 4, 4], [1, 2, 3], [0, 0, 1],
                          [1, 2, 3], [-2, 1, 2], [4, 4, 4], [9, 9, 9]],
                         [[1, 2, 3]] * 8], dtype=torch.int32)
    wweight = torch.tensor([[0, 1, 2, 0, 0, 0, 3, 0], [0] * 8],
                           dtype=torch.float32)
    got = tbatch.distinct_grams(*tbatch._segment_windows(wtok, wweight))
    assert len(extractions) == 1
    np.testing.assert_array_equal(got[0][0], np.int32([[1, 2, 3],
                                                       [4, 4, 4]]))
    np.testing.assert_array_equal(got[0][1], np.float32([2, 4]))
    assert got[1][0].shape == (0, 3) and got[1][1].shape == (0,)


@pytest.mark.parametrize("l", [2, 3, 4, 5])
def test_store_path_equals_host_extraction_and_oracle(extractions, l):
    files, v = ragged_corpora(11)[2]
    store = CompressedCorpus.build(files, v)
    got = tsequence.sequence_count(store.ga, l=l, method="frontier",
                                   device="cpu")
    assert len(extractions) == 1
    assert_result_equal(got, oracle_sequence_count(store.ga, l),
                        "sequence_count", f"l={l}")
    srv = ts.AnalyticsServer(device="cpu")
    srv.register("s", store)
    served = srv.run([ts.Query("s", "sequence_count", l=l)])[0]
    assert len(extractions) == 2
    assert_result_equal(served, got, "sequence_count", "served store")
