"""Device-sharded batch execution: host-side plan logic on any device
count, in-process sharded runs when >1 device is visible (CI's multidevice
lane forces 8 CPU host devices), and an 8-device subprocess running the
full sharded differential worker."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from repro.core import GrammarBatch, compress_files, flatten, run_batched
from repro.core.batch import CORPUS_AXIS
from repro.distributed.shard_batch import (corpus_mesh, mesh_size,
                                           pad_corpora, run_sharded,
                                           shard_batch)
from repro.serving.analytics_server import AnalyticsServer, Query
from repro.serving.queue import AsyncAnalyticsServer

multidevice = pytest.mark.skipif(
    jax.device_count() < 2,
    reason="needs >1 device (run with "
           "XLA_FLAGS=--xla_force_host_platform_device_count=8)")


def _mk(rng, vocab=40, nf=2, size=150):
    files = [rng.integers(0, vocab, size) for _ in range(nf)]
    g, n = compress_files(files, vocab)
    return flatten(g, vocab, n)


def _corpora(rng, n):
    return [_mk(rng, vocab=int(rng.integers(20, 60)),
                nf=int(rng.integers(1, 4)),
                size=int(rng.integers(60, 250))) for _ in range(n)]


# --------------------------------------------------------- host-side plan --
def test_pad_corpora_shapes(seeded_rng):
    gas = _corpora(seeded_rng, 5)
    padded, n_real = pad_corpora(gas, 8)
    assert n_real == 5 and len(padded) == 8
    # padding repeats the smallest grammar: no padded dim grows
    smallest = min(gas, key=lambda ga: ga.num_rules)
    assert all(p is smallest for p in padded[5:])
    # already divisible -> untouched
    same, n_real = pad_corpora(gas, 5)
    assert n_real == 5 and all(a is b for a, b in zip(same, gas))
    # multiple=1 never pads
    same, _ = pad_corpora(gas, 1)
    assert len(same) == 5 and all(a is b for a, b in zip(same, gas))
    with pytest.raises(ValueError):
        pad_corpora([], 4)
    with pytest.raises(ValueError):
        pad_corpora(gas, 0)


def test_corpus_mesh_single_device_fallback():
    assert corpus_mesh(max_shards=1) is None
    assert mesh_size(None) == 1
    with pytest.raises(ValueError):
        corpus_mesh(max_shards=0)
    if jax.device_count() < 2:
        # on a single-device host auto-detection yields no mesh, and the
        # whole sharding layer degrades to plain packs
        assert corpus_mesh() is None


def test_shard_validation(seeded_rng):
    gas = _corpora(seeded_rng, 3)
    gb = GrammarBatch.build(gas)
    bad_axis = Mesh(np.array(jax.devices()[:1]), ("data",))
    with pytest.raises(ValueError, match="corpus"):
        gb.shard(bad_axis)
    mesh1 = Mesh(np.array(jax.devices()[:1]), (CORPUS_AXIS,))
    with pytest.raises(ValueError, match="n_real"):
        gb.shard(mesh1, n_real=7)


def test_one_device_mesh_is_equivalent(seeded_rng):
    """A 1-device corpus mesh is legal and bit-equal to the plain pack —
    the degenerate end of the transparent-fallback contract."""
    gas = _corpora(seeded_rng, 3)
    mesh1 = Mesh(np.array(jax.devices()[:1]), (CORPUS_AXIS,))
    gb = GrammarBatch.build(gas)
    gbs = gb.shard(mesh1)
    assert gbs.shards == 1 and gbs.real == 3
    assert gbs.signature == gb.signature
    for method in ("frontier", "leveled", "frontier_ell"):
        want = run_batched(gb, "word_count", method=method)
        got = run_batched(gbs, "word_count", method=method)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w), np.asarray(g))


def test_run_sharded_single_device_fallback(seeded_rng):
    """mesh=None (auto-detect finds nothing to shard over on 1 device, or
    the caller passes None on many): run_sharded == run_batched."""
    gas = _corpora(seeded_rng, 3)
    want = run_batched(GrammarBatch.build(gas), "word_count")
    got = run_sharded(gas, "word_count", mesh=corpus_mesh(max_shards=1))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), np.asarray(g))


def test_signature_records_shard_count(seeded_rng):
    gb = GrammarBatch.build(_corpora(seeded_rng, 2))
    assert gb.signature[-1] == 1 and gb.shards == 1
    assert gb.real == 2 and gb.real_gas == gb.gas


# ------------------------------------------------------------ server knobs --
def test_server_shard_selection_without_mesh(seeded_rng):
    srv = AnalyticsServer(max_batch=4, mesh=None)
    assert srv.shard_count(1) == srv.shard_count(100) == 1
    assert srv.chunk_capacity(1) == srv.chunk_capacity(8) == 4
    with pytest.raises(ValueError):
        srv.chunk_capacity(0)
    with pytest.raises(ValueError):
        AnalyticsServer(shard_min_corpora=0)
    # run_group with a shard target still works (degrades to max_batch)
    for i, ga in enumerate(_corpora(seeded_rng, 6)):
        srv.register(f"c{i}", ga)
    out = srv.run_group("word_count", [f"c{i}" for i in range(6)],
                        target_shards=4)
    assert set(out) == {f"c{i}" for i in range(6)}
    assert srv.stats.sharded_calls == 0


def test_queue_target_shards_validation():
    srv = AnalyticsServer(max_batch=2, mesh=None)
    with pytest.raises(ValueError):
        AsyncAnalyticsServer(srv, target_shards=0)
    q = AsyncAnalyticsServer(srv, target_shards=4)
    assert q.target_shards == 4           # harmless without a mesh


# ----------------------------------------------------- in-process sharded --
@multidevice
def test_sharded_pack_bit_equal_in_process(seeded_rng):
    gas = _corpora(seeded_rng, 5)        # N < device count exercises padding
    mesh = corpus_mesh()
    gb1 = GrammarBatch.build(gas)
    gbs = shard_batch(gas, mesh)
    assert gbs.shards == jax.device_count()
    assert gbs.real == 5 and gbs.n % gbs.shards == 0
    for kind in ("word_count", "term_vector", "sequence_count"):
        for method in ("frontier", "leveled", "frontier_ell",
                       "leveled_ell"):
            want = run_batched(gb1, kind, method=method)
            got = run_batched(gbs, kind, method=method)
            assert len(got) == len(want) == 5
            for w, g in zip(want, got):
                ws = w if isinstance(w, tuple) else (w,)
                gs = g if isinstance(g, tuple) else (g,)
                for a, b in zip(ws, gs):
                    np.testing.assert_array_equal(
                        np.asarray(a), np.asarray(b),
                        err_msg=f"{kind}/{method} diverged under sharding")


@multidevice
def test_server_sharded_mode_in_process(seeded_rng):
    gas = _corpora(seeded_rng, 10)
    srv_s = AnalyticsServer(max_batch=4, shard_min_corpora=2)
    srv_1 = AnalyticsServer(max_batch=4, mesh=None)
    for i, ga in enumerate(gas):
        srv_s.register(f"c{i}", ga)
        srv_1.register(f"c{i}", ga)
    qs = [Query(f"c{i}", "word_count") for i in range(10)]
    for got, want in zip(srv_s.run(qs), srv_1.run(qs)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert srv_s.stats.sharded_calls > 0


# ------------------------------------------------------ 8-device subprocess --
def test_sharded_subprocess():
    """Full sharded differential worker on 8 forced host devices: oracle
    equality on ragged shards, server + queue sharded modes (fast lane —
    this is the sharding layer's primary correctness gate)."""
    worker = os.path.join(os.path.dirname(__file__), "_shard_worker.py")
    r = subprocess.run([sys.executable, worker], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert "SHARDED ALL OK" in r.stdout
