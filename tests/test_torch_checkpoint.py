"""The port's checkpointing (``repro_torch.checkpoint``) against the JAX
package's, on the CPU.

* Flattening: the port's leaf keys and order equal ``jax.tree_util``'s
  ``tree_flatten_with_path`` + ``keystr`` on nested dicts, lists, tuples
  and namedtuples.
* Cross-package: a tree and a mid-ingest corpus snapshot written by either
  package restore in the other with the same keys, arrays and epoch; so
  does an LM's parameter tree (``lm_to_params`` / ``lm_from_params``),
  to the same logits (within 1e-4 of scale, two float32 packages).
* The JAX package's own checkpoint tests, mirrored: round trip, keep-k GC
  and the LATEST pointer, an interrupted write, the every-N manager, a
  missing directory, corpus snapshots (mid-ingest, resume, wrong kind,
  keep-latest).

All other comparisons are exact.
"""

import collections
import dataclasses
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.data.store import CompressedCorpus as JCorpus
from repro_torch import checkpoint as tckpt
from repro_torch.core import GrammarArrays
from repro_torch.data import CompressedCorpus

from _torch_inputs import corpus_files

torch.set_num_threads(1)

FIELDS = [f.name for f in dataclasses.fields(GrammarArrays)]
Pair = collections.namedtuple("Pair", "mu count")


def _tree():
    return {"a": torch.arange(5, dtype=torch.float32),
            "nested": {"b": torch.ones((3, 4)),
                       "c": torch.zeros((), dtype=torch.int32)}}


def _np_tree():
    return {"a": np.arange(5.0, dtype=np.float32),
            "nested": {"b": np.ones((3, 4), np.float32),
                       "c": np.zeros((), np.int32)}}


def _leaves_equal(got, want):
    g = [v for _, v in tckpt.flatten_with_paths(got)]
    w = [v for _, v in tckpt.flatten_with_paths(want)]
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ flattening --
FLATTEN_CASES = {
    "nested_dicts": {"z": {"y": 1, "b": 2}, "a": np.zeros(3)},
    "lists_tuples": {"w": [np.ones(2), (np.zeros(1), 3), []], "v": ()},
    "namedtuple": {"opt": Pair(mu=np.ones(2), count=np.int32(4)),
                   "p": [Pair(1, 2)]},
    "escapes": {"a/b": {"c/d": np.ones(1)}, "e": None},
    "ordered": collections.OrderedDict([("q", 1), ("b", [2, 3])]),
    "int_keys": {3: np.ones(1), 1: {"x": 2}},
    "bare_leaf": np.arange(4),
}


@pytest.mark.parametrize("case", sorted(FLATTEN_CASES))
def test_flatten_keys_equal_jax_keystr(case):
    tree = FLATTEN_CASES[case]
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    want = [(jax.tree_util.keystr(p), leaf) for p, leaf in flat]
    got = tckpt.flatten_with_paths(tree)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a is b


def test_restore_rebuilds_the_template_structure(tmp_path):
    tree = {"opt": Pair(mu=torch.ones(2), count=torch.tensor(4)),
            "layers": [torch.zeros(2, 2), (torch.ones(1), None)],
            "od": collections.OrderedDict([("z", torch.ones(1)),
                                           ("a", torch.zeros(1))])}
    tckpt.save_checkpoint(str(tmp_path), 3, tree)
    got, step, _ = tckpt.restore_checkpoint(str(tmp_path), tree)
    assert step == 3
    assert isinstance(got["opt"], Pair) and isinstance(got["layers"][1],
                                                       tuple)
    assert got["layers"][1][1] is None
    assert list(got["od"]) == ["z", "a"]
    assert isinstance(got["opt"].mu, np.ndarray)   # numpy leaves
    _leaves_equal(got, tree)


# --------------------------------------------------------- cross-package --
@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_tree_checkpoint_restores_across_packages(tmp_path, writer):
    tree = {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
            "layers": [{"k/v": np.ones((2, 2), np.int64)},
                       {"k/v": np.zeros((1,), np.int8)}],
            "opt": Pair(mu=np.full(3, 0.5, np.float32),
                        count=np.int32(7))}
    save, restore = ((tckpt.save_checkpoint, jckpt.restore_checkpoint)
                     if writer == "torch"
                     else (jckpt.save_checkpoint, tckpt.restore_checkpoint))
    save(str(tmp_path), 11, tree, extra={"note": writer})
    got, step, extra = restore(str(tmp_path), tree)
    assert step == 11 and extra == {"note": writer}
    _leaves_equal(got, tree)
    with open(tmp_path / "step_000000011" / "manifest.json") as f:
        manifest = json.load(f)
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    assert manifest["keys"] == [jax.tree_util.keystr(p) for p, _ in flat]


def _mid_ingest(package, seed=5):
    rng = np.random.default_rng(seed)
    files = corpus_files(rng, 30, 5, 120)
    corpus = (CompressedCorpus if package == "torch" else JCorpus).build(
        files[:3], 30)
    corpus.append_files(files[3:4])
    return corpus, files


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_corpus_snapshot_restores_across_packages(tmp_path, writer):
    """A mid-ingest snapshot by one package restores in the other at the
    same epoch, field for field, and resumes ingest bit-exact."""
    corpus, files = _mid_ingest(writer)
    (tckpt if writer == "torch" else jckpt).save_corpus(str(tmp_path), 4,
                                                        corpus)
    reader = jckpt if writer == "torch" else tckpt
    restored, step = reader.restore_corpus(str(tmp_path))
    assert step == 4 and restored.epoch == corpus.epoch == 1
    for name in FIELDS:
        g, w = getattr(restored.ga, name), getattr(corpus.ga, name)
        assert np.asarray(g).dtype == np.asarray(w).dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(restored.file_starts, corpus.file_starts)
    np.testing.assert_array_equal(restored.file_lens, corpus.file_lens)
    restored.append_files(files[4:])
    corpus.append_files(files[4:])
    assert restored.epoch == corpus.epoch == 2
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(restored.ga, name),
                                      getattr(corpus.ga, name),
                                      err_msg=name)


# ------------------------------------- the JAX package's tests, mirrored --
def test_roundtrip(tmp_path):
    t = _tree()
    tckpt.save_checkpoint(str(tmp_path), 7, t, extra={"note": "x"})
    restored, step, extra = tckpt.restore_checkpoint(str(tmp_path), t)
    assert step == 7 and extra == {"note": "x"}
    _leaves_equal(restored, _np_tree())


def test_latest_pointer_and_gc(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        tckpt.save_checkpoint(str(tmp_path), s, t, keep=2)
    assert tckpt.latest_step(str(tmp_path)) == 5
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_000000004", "step_000000005"]
    assert not (tmp_path / "LATEST.tmp").exists()


def test_interrupted_write_invisible(tmp_path):
    t = _tree()
    tckpt.save_checkpoint(str(tmp_path), 1, t)
    # a crashed writer's tmp dir must not affect restores or the GC
    os.makedirs(str(tmp_path / "step_000000002.tmp"))
    assert tckpt.latest_step(str(tmp_path)) == 1
    _, step, _ = tckpt.restore_checkpoint(str(tmp_path), t)
    assert step == 1
    tckpt.save_checkpoint(str(tmp_path), 3, t, keep=1)
    assert (tmp_path / "step_000000002.tmp").exists()


def test_manager_every_n(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path / "m"), every=3)
    t = _tree()
    assert mgr.restore_or_none(t) is None
    saved = [s for s in range(1, 10) if mgr.maybe_save(s, t)]
    assert saved == [3, 6, 9]
    assert mgr.restore_or_none(t)[1] == 9


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path / "nope"), _tree())
    with pytest.raises(FileNotFoundError):
        tckpt.restore_corpus(str(tmp_path / "nope"))


def test_corpus_snapshot_roundtrip_mid_ingest(tmp_path):
    corpus, _ = _mid_ingest("torch", seed=8)
    tckpt.save_corpus(str(tmp_path), 42, corpus)
    restored, step = tckpt.restore_corpus(str(tmp_path))
    assert step == 42 and restored.epoch == 1
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(corpus.ga, name),
                                      getattr(restored.ga, name),
                                      err_msg=name)
    assert restored.stats() == corpus.stats()


def test_corpus_snapshot_restore_resumes_ingest(tmp_path):
    """Appending after a restore is bit-identical to never checkpointing,
    and derived memos start empty — computed fresh at the restored epoch."""
    corpus, files = _mid_ingest("torch", seed=9)
    corpus.top_down_weights(device="cpu")
    tckpt.save_corpus(str(tmp_path), 1, corpus)
    restored, _ = tckpt.restore_corpus(str(tmp_path))
    assert restored.cached_weight_keys() == ()
    corpus.append_files(files[4:])
    restored.append_files(files[4:])
    assert restored.epoch == corpus.epoch == 2
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(corpus.ga, name),
                                      getattr(restored.ga, name),
                                      err_msg=name)
    assert torch.equal(corpus.top_down_weights(device="cpu"),
                       restored.top_down_weights(device="cpu"))


def test_corpus_snapshot_wrong_kind_raises(tmp_path):
    tckpt.save_checkpoint(str(tmp_path), 3, _tree())
    with pytest.raises(ValueError, match="not a corpus snapshot"):
        tckpt.restore_corpus(str(tmp_path))


def test_corpus_snapshot_keeps_latest(tmp_path):
    rng = np.random.default_rng(3)
    files = corpus_files(rng, 20, 4, 60)
    corpus = CompressedCorpus.build(files[:3], 20)
    tckpt.save_corpus(str(tmp_path), 1, corpus)
    corpus.append_files(files[3:])
    tckpt.save_corpus(str(tmp_path), 2, corpus)
    restored, step = tckpt.restore_corpus(str(tmp_path))
    assert step == 2 and restored.epoch == 1
    old, step = tckpt.restore_corpus(str(tmp_path), step=1)
    assert step == 1 and old.epoch == 0
    assert old.ga.num_files == 3 and restored.ga.num_files == 4


# ----------------------------------------------------------------------- #
# Model trees (the LM zoo's parameters)                                    #
# ----------------------------------------------------------------------- #
def _qwen2_pair():
    from repro import models as jm
    from repro.configs import get_config as jget
    from repro_torch import models as tm
    from repro_torch.configs import get_config as tget
    return (jm, jm.reduced(jget("qwen2_05b"), dtype="float32"),
            tm, tm.reduced(tget("qwen2_05b"), dtype="float32"))


def _logits_close(got, want):
    """Logits within 1e-4 * max(1, max|want|) (float32, two packages)."""
    want = np.asarray(want)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= 1e-4 * max(1.0, float(np.abs(want).max())), err


def test_lm_tree_from_jax_restores_in_port(tmp_path):
    """The JAX package's checkpoint of ``unbox(init_lm(...))[0]`` restores
    through ``restore_checkpoint`` + ``lm_from_params`` to the same
    logits."""
    jm, jcfg, tm, tcfg = _qwen2_pair()
    params = jm.unbox(jm.init_lm(jax.random.PRNGKey(4), jcfg))[0]
    jckpt.save_checkpoint(str(tmp_path), 5, params)
    template = tm.lm_to_params(tm.init_lm(tcfg, device="cpu"))
    tree, step, _ = tckpt.restore_checkpoint(str(tmp_path), template)
    assert step == 5
    model = tm.lm_from_params(tcfg, tree, device="cpu")
    toks = np.random.default_rng(4).integers(0, tcfg.vocab_size, (2, 9))
    want, _ = jm.apply_lm(jcfg, params, jnp.asarray(toks, jnp.int32))
    with torch.no_grad():
        got, _ = tm.apply_lm(tcfg, model, toks)
    _logits_close(got, want)


def test_lm_tree_from_port_restores_in_jax(tmp_path):
    """``lm_to_params`` of a port model, saved by the port, restores in
    the JAX package leaf for leaf, and the JAX model gives its logits."""
    jm, jcfg, tm, tcfg = _qwen2_pair()
    model = tm.init_lm(tcfg, torch.Generator().manual_seed(4), device="cpu")
    tckpt.save_checkpoint(str(tmp_path), 6, tm.lm_to_params(model))
    template = jm.unbox(jm.init_lm(jax.random.PRNGKey(0), jcfg))[0]
    params, step, _ = jckpt.restore_checkpoint(str(tmp_path), template)
    assert step == 6
    _leaves_equal(tm.lm_to_params(model), params)
    toks = np.random.default_rng(5).integers(0, tcfg.vocab_size, (2, 9))
    want, _ = jm.apply_lm(jcfg, params, jnp.asarray(toks, jnp.int32))
    with torch.no_grad():
        got, _ = tm.apply_lm(tcfg, model, toks)
    _logits_close(got, want)


# ----------------------------------------------------------------------- #
# bfloat16 leaves                                                          #
# ----------------------------------------------------------------------- #
# bit patterns: 1.0, -0.0, +inf, -inf, the smallest subnormal, the
# largest finite, a quiet NaN, and a negative non-integer
BF16_BITS = np.array([0x3F80, 0x8000, 0x7F80, 0xFF80, 0x0001, 0x7F7F,
                      0x7FC1, 0xC2F7], np.uint16)


def _bf16_bits(rng):
    """[3, 8] bfloat16 raw bits: the patterns above and random ones."""
    return np.concatenate([BF16_BITS, rng.integers(
        0, 1 << 16, 16, dtype=np.uint16)]).reshape(3, 8)


def _bf16_tensor(bits):
    return torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)


def _bits_of(t):
    assert isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def test_bf16_roundtrip_bit_exact(tmp_path, seeded_rng):
    """A bfloat16 tensor (even a non-contiguous view) saves and restores
    as a bfloat16 tensor with the same bits; the manifest names it
    "bfloat16" and the npz holds its raw 2-byte values (``|V2``)."""
    bits = _bf16_bits(seeded_rng)
    t = _bf16_tensor(bits)
    tree = {"w": t, "wt": t.T, "f": torch.arange(3, dtype=torch.float32)}
    tckpt.save_checkpoint(str(tmp_path), 1, tree)
    got, _, _ = tckpt.restore_checkpoint(str(tmp_path), tree)
    np.testing.assert_array_equal(_bits_of(got["w"]), bits)
    np.testing.assert_array_equal(_bits_of(got["wt"]), bits.T)
    np.testing.assert_array_equal(got["f"], np.arange(3, dtype=np.float32))
    step_dir = tmp_path / "step_000000001"
    manifest = json.loads((step_dir / "manifest.json").read_text())
    assert manifest["dtypes"] == {"['f']": "float32", "['w']": "bfloat16",
                                  "['wt']": "bfloat16"}
    with np.load(step_dir / "shard_00000.npz") as z:
        assert z["['w']"].dtype == np.dtype("V2")


def _bf16_pair(tmp_path, bits):
    """The same bfloat16 values saved by both packages (JAX through
    ``ml_dtypes``): the two step directories."""
    import ml_dtypes
    tckpt.save_checkpoint(str(tmp_path / "torch"), 2,
                          {"p": {"w": _bf16_tensor(bits)}})
    jckpt.save_checkpoint(str(tmp_path / "jax"), 2, {"p": {"w": jnp.asarray(
        bits.view(ml_dtypes.bfloat16))}})
    return [tmp_path / d / "step_000000002" for d in ("torch", "jax")]


def test_bf16_npz_bytes_equal_jax(tmp_path, seeded_rng):
    """The port writes the JAX package's bytes: the npz member (the .npy
    header and the raw values) and the manifest are equal."""
    ours, theirs = _bf16_pair(tmp_path, _bf16_bits(seeded_rng))
    for name in ("manifest.json",):
        assert json.loads((ours / name).read_text()) == json.loads(
            (theirs / name).read_text())
    members = []
    for d in (ours, theirs):
        with zipfile.ZipFile(d / "shard_00000.npz") as z:
            members.append({n: z.read(n) for n in z.namelist()})
    assert members[0] == members[1]


def test_bf16_checkpoint_from_jax_restores_in_port(tmp_path, seeded_rng):
    """A bfloat16 leaf the JAX package wrote restores in the port as a
    bfloat16 tensor with the same bits.  The JAX package's own restore
    returns the raw ``|V2`` array (a reference quirk the port does not
    share)."""
    bits = _bf16_bits(seeded_rng)
    _, theirs = _bf16_pair(tmp_path, bits)
    template = {"p": {"w": 0}}
    got, step, _ = tckpt.restore_checkpoint(str(tmp_path / "jax"), template)
    assert step == 2
    np.testing.assert_array_equal(_bits_of(got["p"]["w"]), bits)
    ref, _, _ = jckpt.restore_checkpoint(str(tmp_path / "jax"), template)
    assert ref["p"]["w"].dtype == np.dtype("V2")


def test_bf16_lm_tree_resumes_bit_exact(tmp_path):
    """A bfloat16 model's parameters (the published dtype) round-trip
    through a port checkpoint into another model in place, bit for
    bit."""
    from repro_torch import models as tm
    from repro_torch.configs import get_config
    cfg = tm.reduced(get_config("qwen2_05b"))
    assert cfg.dtype == "bfloat16"
    src = tm.init_lm(cfg, torch.Generator().manual_seed(1), device="cpu")
    dst = tm.init_lm(cfg, torch.Generator().manual_seed(2), device="cpu")
    tckpt.save_checkpoint(str(tmp_path), 3, tm.lm_to_params(src))
    tree, _, _ = tckpt.restore_checkpoint(str(tmp_path),
                                          tm.lm_to_params(dst))
    tm.lm_load_params(dst, tree)
    for a, b in zip(src.parameters(), dst.parameters()):
        assert a.dtype == b.dtype and torch.equal(a.view(torch.int16)
                                                  if a.dtype == torch.bfloat16
                                                  else a,
                                                  b.view(torch.int16)
                                                  if b.dtype == torch.bfloat16
                                                  else b)
