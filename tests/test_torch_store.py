"""The port's ``CompressedCorpus`` store and ``expand_range`` against the JAX
package, on the CPU.

* Window reads: ``expand_range``, ``window`` and ``global_window`` return
  the raw files' tokens and the JAX package's, and raise where it raises.
* Ingest: ``build`` equals the JAX store's build field for field;
  ``append_files`` equals a rebuild of the concatenated files and the JAX
  store's append, bumps the epoch, and ``check_epoch`` guards it.
* Memos: epoch-stamped and keyed by device; a planted stale entry is never
  returned.
* ``save``/``load`` round-trip every field, in the JAX package's file
  format (each package loads the other's file).

All comparisons are exact (integer data, integer-valued float32 weights).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.grammar import expand_range as jexpand_range
from repro.data.store import CompressedCorpus as JCorpus
from repro_torch.core import StaleGrammarError, expand_range
from repro_torch.core import GrammarArrays
from repro_torch.data import CompressedCorpus
from repro_torch.obs import global_registry

from _torch_inputs import corpus_files

torch.set_num_threads(1)

FIELDS = [f.name for f in dataclasses.fields(GrammarArrays)]


def _files(seed: int = 21, n: int = 6, size: int = 150, vocab: int = 25):
    return corpus_files(np.random.default_rng(seed), vocab, n, size), vocab


def _assert_corpus_equal(got, want):
    """Every grammar field, the file offsets and the epoch, bit-equal."""
    for name in FIELDS:
        g, w = getattr(got.ga, name), getattr(want.ga, name)
        assert np.asarray(g).dtype == np.asarray(w).dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(got.file_starts, want.file_starts)
    np.testing.assert_array_equal(got.file_lens, want.file_lens)
    assert got.epoch == want.epoch


def _stream(files, vocab):
    """The corpus stream: each file followed by its unique splitter."""
    parts = []
    for i, f in enumerate(files):
        parts += [np.asarray(f, np.int64), np.array([vocab + i])]
    return np.concatenate(parts)


# ---------------------------------------------------------------- reads --
def test_expand_range_matches_jax_and_stream(seeded_rng):
    files, vocab = _files()
    cc = CompressedCorpus.build(files, vocab)
    jga = JCorpus.build(files, vocab).ga
    stream = _stream(files, vocab)
    total = len(stream)
    assert int(cc.ga.exp_len[0]) == total
    cases = [(0, total), (0, 0), (total, 5), (total - 1, 10), (3, 1)]
    cases += [(int(s), int(n)) for s, n in zip(
        seeded_rng.integers(0, total, 20), seeded_rng.integers(0, 80, 20))]
    for start, length in cases:
        got = expand_range(cc.ga, start, length)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, stream[start: start + length])
        np.testing.assert_array_equal(got, jexpand_range(jga, start, length))


def test_windows_match_files_and_jax(seeded_rng):
    files, vocab = _files()
    cc, jc = CompressedCorpus.build(files, vocab), JCorpus.build(files, vocab)
    for fid, f in enumerate(files):
        for off in (0, int(seeded_rng.integers(0, len(f))), len(f)):
            for length in (0, 7, len(f) + 5):
                got = cc.window(fid, off, length)
                np.testing.assert_array_equal(got, f[off: off + length])
                np.testing.assert_array_equal(got,
                                              jc.window(fid, off, length))
    total = int(cc.ga.exp_len[0])
    for off, length in ((0, total), (total - 3, 10), (total, 10), (5, 0)):
        np.testing.assert_array_equal(cc.global_window(off, length),
                                      jc.global_window(off, length))
    assert cc.global_window(0, total).size == total


@pytest.mark.parametrize("call,exc", [
    (("window", 0, 151, 1), ValueError),      # one past the file end
    (("window", 1, -3, 10), ValueError),      # would read file 0's tokens
    (("window", 1, 0, -1), ValueError),       # negative length
    (("window", 6, 0, 1), IndexError),        # no such file
    (("window", -1, 0, 1), IndexError),
    (("global_window", -1, 5), ValueError),
    (("global_window", 0, -2), ValueError),
    (("global_window", 10 ** 6, 1), ValueError)])
def test_window_edges_raise_like_jax(call, exc):
    files, vocab = _files()
    name, *args = call
    for corpus in (CompressedCorpus.build(files, vocab),
                   JCorpus.build(files, vocab)):
        with pytest.raises(exc):
            getattr(corpus, name)(*args)


# --------------------------------------------------------------- ingest --
def test_build_matches_jax_store():
    files, vocab = _files()
    cc, jc = CompressedCorpus.build(files, vocab), JCorpus.build(files, vocab)
    _assert_corpus_equal(cc, jc)
    assert cc.stats() == jc.stats()
    assert cc.total_tokens == jc.total_tokens == sum(len(f) for f in files)


@pytest.mark.parametrize("split", [1, 3, 5])
def test_append_equals_rebuild_and_jax_append(split):
    files, vocab = _files()
    appends = global_registry().counter("repro_store_appends_total")
    before = appends.value
    cc = CompressedCorpus.build(files[:split], vocab)
    assert cc.append_files(files[split:]) is cc
    assert cc.epoch == 1 and appends.value == before + 1
    rebuilt = CompressedCorpus.build(files, vocab)
    rebuilt.epoch = 1
    _assert_corpus_equal(cc, rebuilt)
    jc = JCorpus.build(files[:split], vocab).append_files(files[split:])
    _assert_corpus_equal(cc, jc)
    for fid, f in enumerate(files):
        np.testing.assert_array_equal(cc.window(fid, 0, len(f)), f)


def test_empty_append_is_a_noop_and_epochs_guard():
    files, vocab = _files()
    cc = CompressedCorpus.build(files[:2], vocab)
    ga = cc.ga
    cc.append_files([])
    assert cc.epoch == 0 and cc.ga is ga
    cc.check_epoch(0)
    cc.append_files(files[2:4]).append_files(files[4:])
    assert cc.epoch == 2
    cc.check_epoch(2)
    with pytest.raises(StaleGrammarError, match="epoch 2"):
        cc.check_epoch(1)


def test_memo_is_epoch_stamped_and_keyed_by_device():
    """Hits serve the memoized tensor; an append recomputes it, equal to a
    fresh build's and to the JAX store's; keys carry the device."""
    files, vocab = _files()
    lookups = global_registry().counter(
        "repro_store_memo_lookups_total", "", ("result",))
    hits = lookups.labels("hit").value
    cc = CompressedCorpus.build(files[:4], vocab)
    w = cc.top_down_weights(device="cpu")
    assert cc.top_down_weights(device="cpu") is w
    assert lookups.labels("hit").value == hits + 1
    assert cc.cached_weight_keys() == (("top_down", "frontier", "cpu"),)
    cc.append_files(files[4:])
    assert cc.cached_weight_keys() == ()
    jc = JCorpus.build(files, vocab)
    for method in ("frontier", "leveled", "frontier_fused"):
        got = cc.top_down_weights(method, device="cpu")
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jc.top_down_weights(method)))
        got = cc.per_file_weights(method, device="cpu")
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jc.per_file_weights(method)))
    assert ("per_file", "leveled", "cpu") in cc.cached_weight_keys()
    cc.clear_weight_cache()
    assert cc.cached_weight_keys() == ()


def test_planted_stale_memo_is_never_returned():
    files, vocab = _files()
    cc = CompressedCorpus.build(files[:3], vocab)
    cc.append_files(files[3:])
    stale = global_registry().counter(
        "repro_store_memo_lookups_total", "", ("result",)).labels("stale")
    before = stale.value
    poison = object()
    for key in (("top_down", "frontier", "cpu"),
                ("per_file", "frontier", "cpu")):
        cc._weights_cache[key] = (cc.epoch - 1, poison)
    w = cc.top_down_weights(device="cpu")
    wf = cc.per_file_weights(device="cpu")
    assert w is not poison and wf is not poison
    assert stale.value == before + 2
    fresh = CompressedCorpus.build(files, vocab)
    assert torch.equal(w, fresh.top_down_weights(device="cpu"))
    assert torch.equal(wf, fresh.per_file_weights(device="cpu"))


# ------------------------------------------------------------------- io --
def test_save_load_round_trips_every_field(tmp_path):
    files, vocab = _files()
    cc = CompressedCorpus.build(files[:4], vocab).append_files(files[4:])
    path = str(tmp_path / "c.npz")
    cc.save(path)
    loaded = CompressedCorpus.load(path)
    _assert_corpus_equal(loaded, cc)
    assert loaded.stats() == cc.stats()
    # one file format: each package loads what the other saved
    _assert_corpus_equal(JCorpus.load(path), cc)
    jpath = str(tmp_path / "j.npz")
    JCorpus.build(files[:4], vocab).append_files(files[4:]).save(jpath)
    _assert_corpus_equal(CompressedCorpus.load(jpath), cc)


def test_loaded_corpus_resumes_ingest_bit_exact(tmp_path):
    """A loaded store has no live Sequitur: its first append replays the
    stored stream, and the result equals an uninterrupted build."""
    files, vocab = _files()
    path = str(tmp_path / "c.npz")
    CompressedCorpus.build(files[:3], vocab).save(path)
    cc = CompressedCorpus.load(path).append_files(files[3:])
    want = CompressedCorpus.build(files, vocab)
    want.epoch = 1
    _assert_corpus_equal(cc, want)
    _assert_corpus_equal(cc, JCorpus.load(path).append_files(files[3:]))
