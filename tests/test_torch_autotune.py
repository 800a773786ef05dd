"""The port's autotuner (``repro_torch.kernels.autotune``) and the dispatch
layer's use of its table, against the JAX package's, on the CPU.

* The table: load/save/corrupt-file/version/key behaviour, ``shape_bucket``,
  ``tuned_use_ref`` and ``tuned_blocks`` equal the JAX package's on the
  same sequence of ``put_entry`` calls, and each package reads the file the
  other wrote (the key's backend is ``cpu`` here in both).
* Routing: an ``ell_vs_seg`` entry flips ``ell_batched_use_ref`` in the
  port as it flips it in the JAX package, per shard too.
* Launch shapes: a table miss launches exactly the shipped shapes; a
  tuned entry changes the shape each wrapper launches (unknown keys
  dropped) and counts a ``hit``.  The kernels cannot launch here, so the
  CUDA entry is a spy.
* Sweeps: they refuse CPU tensors; the sweep logic (default first, every
  candidate held to the plain version, the median time decides, the entry
  persisted) runs on the CPU with the card's timer stubbed out.
"""

import json

import numpy as np
import pytest
import torch

from repro.kernels import autotune as jat
from repro.kernels import ops as jops
from repro_torch.core import GrammarBatch, compress_files, flatten
from repro_torch.kernels import autotune as tat
from repro_torch.kernels import ops as tops
from repro_torch.kernels import (bincount, propagate, propagate_batched,
                                 propagate_fused, propagate_vector, ref)
from repro_torch.obs import global_registry

from _torch_inputs import (batch_dags, bincount_inputs, plan_inputs,
                           vector_inputs)

torch.set_num_threads(1)


@pytest.fixture
def table(tmp_path, monkeypatch):
    """Both packages' tables pointed at one temp file, memos dropped on
    entry and exit."""
    path = tmp_path / "tuned.json"
    monkeypatch.setenv(tat.CACHE_ENV, str(path))
    assert tat.CACHE_ENV == jat.CACHE_ENV
    for mod in (tat, jat):
        mod.reset_table()
    yield path
    for mod in (tat, jat):
        mod.reset_table()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- table --
def test_table_defaults_equal_the_reference():
    assert tat.DEFAULT_CACHE_PATH == jat.DEFAULT_CACHE_PATH
    assert tat.CACHE_VERSION == jat.CACHE_VERSION
    assert tat.ANNOTATE_ENV == jat.ANNOTATE_ENV
    assert tat.backend_name() == jat.backend_name() == "cpu"
    for dims in [(3, 100, 5), (1,), (0, 1, 2, 7), (16, 8192, 512, 9),
                 (1025, 3)]:
        assert tat.shape_bucket(*dims) == jat.shape_bucket(*dims)


ENTRIES = [
    ("ell_batched", (4, 128, 8), {"winner": "x", "use_ref": False,
                                  "blocks": {"br": 128}, "us": 1.5}),
    ("ell_vs_seg", (1, 8, 2), {"use_ref": False}),
    ("ell_vs_seg", (4, 1024, 4), {"use_ref": True, "us": 9.0}),
    ("ell_fused", (2, 64, 4, 8), {"blocks": {"block": 256}}),
    ("ell_batched", (4, 128, 8), {"blocks": {"threads": 512},
                                  "use_ref": True}),         # overwrite
]


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_table_sequence_equals_the_reference(table, writer):
    for mod in (tat, jat):
        assert mod.load_table() == {}
        assert mod.get_entry("ell_batched", (4, 128, 8)) is None
        assert mod.tuned_use_ref("ell_batched", (4, 128, 8)) is None
        assert mod.tuned_blocks("ell_batched", (4, 128, 8)) == {}
    for kind, bucket, entry in ENTRIES:
        for mod in (tat, jat):
            mod.put_entry(kind, bucket, dict(entry))
    assert tat.load_table() == jat.load_table()
    for kind, bucket, _ in ENTRIES:
        for backend in (None, "cpu", "NVIDIA H100 80GB HBM3"):
            assert tat.get_entry(kind, bucket, backend) == \
                jat.get_entry(kind, bucket, backend)
            assert tat.tuned_use_ref(kind, bucket, backend) == \
                jat.tuned_use_ref(kind, bucket, backend)
            assert tat.tuned_blocks(kind, bucket, backend) == \
                jat.tuned_blocks(kind, bucket, backend)
    (tat if writer == "torch" else jat).save_table()
    text = table.read_text()
    other = jat if writer == "torch" else tat
    other.reset_table()
    assert other.load_table() == json.loads(text)["entries"]
    # the same file, byte for byte, from either writer
    table.unlink()
    other.save_table()
    assert table.read_text() == text


@pytest.mark.parametrize("content", ["{not json", "[]",
                                     '{"version": 99, "entries": {"a": 1}}',
                                     None])
def test_missing_or_corrupt_table_is_empty(table, content):
    if content is not None:
        table.write_text(content)
    for mod in (tat, jat):
        mod.reset_table()
        assert mod.load_table() == {}
    assert tat.cache_path() == str(table)


def test_table_memo_follows_the_path(table, tmp_path):
    tat.put_entry("ell_vs_seg", (1, 8, 2), {"use_ref": True})
    tat.save_table()
    other = tmp_path / "other.json"
    assert tat.load_table(str(other)) == {}          # another file
    assert tat.load_table(str(table)) != {}          # re-read from disk


def test_backend_names_the_card(monkeypatch):
    monkeypatch.setattr(tat, "_BACKENDS", {})
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda idx=None: f"card {idx}")
    assert tat.backend_name(torch.device("cuda", 1)) == "card 1"
    assert tat.backend_name("cpu") == "cpu"
    assert tat._key("k", (2, 4), "card 1") == "card 1|k|2x4"


def test_annotations_are_opt_in(monkeypatch):
    from contextlib import nullcontext
    monkeypatch.delenv(tat.ANNOTATE_ENV, raising=False)
    assert isinstance(tat.trace_annotation("x"), nullcontext)
    monkeypatch.setenv(tat.ANNOTATE_ENV, "0")
    assert not tat.annotations_enabled()
    monkeypatch.setenv(tat.ANNOTATE_ENV, "1")
    assert isinstance(tat.trace_annotation("x"),
                      torch.profiler.record_function)
    with tat.trace_annotation("autotune-test"):
        pass


# -------------------------------------------------------------- routing --
def test_ell_vs_seg_entry_flips_routing_like_the_reference(table):
    for mod, ops in ((tat, tops), (jat, jops)):
        assert ops.ell_batched_use_ref(10, 1, 8, 2)
        mod.put_entry("ell_vs_seg", mod.shape_bucket(1, 8, 2),
                      {"use_ref": False})
        assert not ops.ell_batched_use_ref(10, 1, 8, 2)
        assert not ops.ell_batched_use_ref(4000, 4, 1000, 4)
        mod.put_entry("ell_vs_seg", mod.shape_bucket(4, 1000, 4),
                      {"use_ref": True})
        assert ops.ell_batched_use_ref(4000, 4, 1000, 4)
        # the sharded gate reads the per-shard bucket
        mod.put_entry("ell_vs_seg", mod.shape_bucket(2, 1000, 4),
                      {"use_ref": False})
        assert not ops.ell_batched_use_ref(4000, 4, 1000, 4, shards=2)


def test_ell_vs_seg_entry_reroutes_a_pack(table):
    """``auto`` follows the table: the same pack resolves to the ELL
    engine, then (after a tuned entry) to segment_sum — same answers."""
    rng = np.random.default_rng(4)
    gas = []
    for _ in range(2):
        files = [np.tile(rng.integers(0, 30, 7), 20) for _ in range(3)]
        g, nf = compress_files(files, 30)
        gas.append(flatten(g, 30, nf))
    gb = GrammarBatch.build(gas, device="cpu")
    from repro_torch.core.batch import (batched_top_down_weights,
                                        resolve_batch_method)
    first = resolve_batch_method(gb, "auto")
    w0 = batched_top_down_weights(gb, "auto")
    tat.put_entry("ell_vs_seg",
                  tat.shape_bucket(gb.n, gb.R_pad, gb.ell_plan_width()),
                  {"use_ref": first != "frontier"})
    second = resolve_batch_method(gb, "auto")
    assert (first == "frontier") != (second == "frontier")
    assert torch.equal(batched_top_down_weights(gb, "auto"), w0)


# -------------------------------------------------------- launch shapes --
def _spy_calls(monkeypatch):
    """Route the wrappers' CUDA branch to spies that record the launch
    shape and answer with the plain version."""
    seen = {}
    monkeypatch.setattr(tops._common, "on_cuda", lambda t: True)

    def spy(name, plain, key):
        def fn(*args, **kw):
            seen[name] = kw.get(key)
            kw.pop(key, None)
            kw.pop("out", None)
            return plain(*args, **kw)
        return fn
    monkeypatch.setattr(tops, "ell_propagate_batched_cuda", spy(
        "ell_batched", ref.ell_propagate_batched_ref, "threads"))
    monkeypatch.setattr(tops, "ell_row_sums_cuda", spy(
        "row_sums", ref.ell_row_sums_ref, "threads"))
    monkeypatch.setattr(tops, "ell_propagate_vector_cuda", spy(
        "ell_vector", ref.ell_propagate_vector_ref, "warps"))
    monkeypatch.setattr(tops, "ell_frontier_fused_cuda", spy(
        "ell_fused", ref.ell_frontier_fused_ref, "block"))
    monkeypatch.setattr(tops, "weighted_bincount_cuda", spy(
        "bincount", ref.weighted_bincount_ref, "threads"))
    return seen


def _call_every_wrapper(rng):
    n, R, k, F = 2, 100, 3, 4
    w, a, src, freq = map(_t, plan_inputs(rng, n, R, k, R))
    tops.ell_propagate_batched(w, a, src, freq)
    tops.ell_row_sums(w[0], src[0], freq[0])
    W, av, vs, vf = map(_t, vector_inputs(rng, n, R, k, F))
    tops.ell_propagate_vector(W, av, vs, vf)
    w0, ind, fs, ff = map(_t, batch_dags(rng, R, k, n)[:4])
    tops.ell_frontier_fused(w0, ind, fs, ff, 6)
    ids, vals = map(_t, bincount_inputs(rng, 300, 50))
    tops.weighted_bincount(ids, vals, 50)
    return dict(ell_batched=(n, R, k), row_sums=(R, k),
                ell_vector=(n, R, k, F), ell_fused=(n, R, k, 6),
                bincount=(1, 300, 50))


DEFAULTS = {"ell_batched": propagate_batched.DEFAULT_THREADS,
            "row_sums": propagate.DEFAULT_THREADS,
            "ell_vector": propagate_vector.DEFAULT_WARPS,
            "ell_fused": propagate_fused.DEFAULT_BLOCK,
            "bincount": bincount.DEFAULT_THREADS}
TUNED = {"ell_batched": {"threads": 128}, "row_sums": {"threads": 1024},
         "ell_vector": {"warps": 4}, "ell_fused": {"block": 256},
         "bincount": {"threads": 512}}


def _tuned_count(kind, result):
    return global_registry().counter(
        "repro_kernel_tuned_table_total", "", ("kind", "result")).labels(
            kind, result).value


def test_a_table_miss_launches_the_shipped_shapes(table, monkeypatch,
                                                  seeded_rng):
    assert DEFAULTS == {"ell_batched": 256, "row_sums": 256,
                        "ell_vector": 8, "ell_fused": 512, "bincount": 256}
    seen = _spy_calls(monkeypatch)
    misses = {k: _tuned_count(k, "miss") for k in DEFAULTS}
    _call_every_wrapper(seeded_rng)
    assert seen == DEFAULTS
    for kind in DEFAULTS:
        assert _tuned_count(kind, "miss") == misses[kind] + 1


def test_tuned_entries_change_the_launch_shape(table, monkeypatch,
                                               seeded_rng):
    buckets = _call_every_wrapper(np.random.default_rng(0))
    for kind, dims in buckets.items():
        tat.put_entry(kind, tat.shape_bucket(*dims),
                      {"blocks": {**TUNED[kind], "bogus": 7}})
    seen = _spy_calls(monkeypatch)
    hits = {k: _tuned_count(k, "hit") for k in DEFAULTS}
    _call_every_wrapper(seeded_rng)
    assert seen == {k: next(iter(v.values())) for k, v in TUNED.items()}
    for kind in DEFAULTS:
        assert _tuned_count(kind, "hit") == hits[kind] + 1


@pytest.mark.parametrize("call", [
    lambda: propagate_batched.ell_propagate_batched_cuda(
        *[torch.zeros(1)] * 4, threads=100),
    lambda: propagate.ell_row_sums_cuda(*[torch.zeros(1)] * 3, threads=48),
    lambda: propagate_vector.ell_propagate_vector_cuda(
        *[torch.zeros(1)] * 4, warps=32),
    lambda: propagate_fused.ell_frontier_fused_cuda(
        *[torch.zeros(1)] * 4, 3, block=2048),
    lambda: bincount.weighted_bincount_cuda(
        torch.zeros(1, dtype=torch.int32), torch.zeros(1), 4, threads=64),
], ids=["ell_batched", "row_sums", "ell_vector", "ell_fused", "bincount"])
def test_wrappers_check_the_launch_shape_before_launch(call):
    with pytest.raises(ValueError, match="not a launch shape"):
        call()


# ---------------------------------------------------------------- sweeps --
@pytest.mark.parametrize("sweep", [
    lambda r: tat.tune_ell_batched(*map(_t, plan_inputs(r, 1, 70, 2, 70))),
    lambda r: tat.tune_ell_fused(*map(_t, batch_dags(r, 70, 2, 1)[:4]), 4),
    lambda r: tat.tune_ell_vector(*map(_t, vector_inputs(r, 1, 70, 2, 3))),
    lambda r: tat.tune_row_sums(*[_t(a[0]) for a in plan_inputs(
        r, 1, 70, 2, 70)[::2]], _t(plan_inputs(r, 1, 70, 2, 70)[3][0])),
    lambda r: tat.tune_bincount(*map(_t, bincount_inputs(r, 300, 50)), 50),
], ids=["ell_batched", "ell_fused", "ell_vector", "row_sums", "bincount"])
def test_sweeps_refuse_cpu_tensors(sweep, seeded_rng, table):
    with pytest.raises(ValueError, match="on one card"):
        sweep(seeded_rng)
    assert tat.load_table() == {}


def test_ell_vs_seg_sweep_refuses_a_cpu_pack():
    g, nf = compress_files([np.arange(10) % 4] * 2, 4)
    gb = GrammarBatch.build([flatten(g, 4, nf)], device="cpu")
    with pytest.raises(ValueError, match="on a card"):
        tat.tune_ell_vs_seg(gb)


def test_sweep_logic_with_a_stub_timer(table, monkeypatch, seeded_rng):
    """``_sweep``: the default shape is measured first and named
    ``default``, each candidate must equal the plain version, the median
    of the rounds decides, and the winner is persisted under the card's
    key."""
    times = {256: [3.0, 9.0, 3.0], 128: [2.0, 2.5, 50.0], 512: [4.0] * 3}
    order = []

    def timer(fn, dev, reps, name):
        order.append(name)
        return times[int(name.rsplit("threads", 1)[-1])
                     if "threads" in name else 256].pop(0)
    monkeypatch.setattr(tat, "_device_ms", timer)
    monkeypatch.setattr(tat, "backend_name", lambda dev=None: "stub card")
    w, a, src, freq = map(_t, plan_inputs(seeded_rng, 1, 70, 2, 70))
    plain = ref.ell_propagate_batched_ref(w, a, src, freq)
    launch = lambda t: ref.ell_propagate_batched_ref(w, a, src, freq)
    entry = tat._sweep("ell_batched", (1, 128, 2), "threads",
                       (128, 256, 512), 256, launch, plain,
                       torch.device("cpu"), repeat=3, reps=5, save=True)
    assert order[:3] == ["autotune:ell_batched:default",
                         "autotune:ell_batched:threads128",
                         "autotune:ell_batched:threads512"]
    assert entry["winner"] == "threads128"
    assert entry["blocks"] == {"threads": 128} and not entry["use_ref"]
    assert entry["us"] == 2500.0 and entry["default_us"] == 3000.0
    assert set(entry["table_us"]) == {"default", "threads128", "threads512"}
    saved = json.loads(table.read_text())["entries"]
    assert saved["stub card|ell_batched|1x128x2"]["winner"] == "threads128"
    # a candidate that disagrees with the plain version raises
    bad = lambda t: tuple(x + (t == 512) for x in plain)
    with pytest.raises(ValueError, match="threads=512 disagrees"):
        tat._sweep("ell_batched", (1, 128, 2), "threads", (128, 512), 256,
                   bad, plain, torch.device("cpu"), 1, 1, False)
