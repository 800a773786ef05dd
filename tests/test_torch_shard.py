"""Corpus-sharded packs of the port (``repro_torch.distributed``) against the
JAX package's unsharded engine, on the CPU.

The JAX package's own sharded path (``shard_map``) fails on the installed
JAX (a known fault of the reference), and it promises bit-identity with
its unsharded path (``core/batch.py`` DESIGN note).  So every sharded
result of the port is held to the JAX package's **unsharded**
``run_batched`` / ``batched_search`` / ``run_batched_query`` and to the
decompress-then-scan oracle (``tests/_oracle.py``):

* ``run_sharded`` over ``corpus_mesh(("cpu",) * k)`` for k = 1..4 on five
  ragged corpora (an empty one, a single-file one; 5 divides none of
  2..4, so the last shard carries padding), for all six analytics under
  every traversal method and the search and query kinds;
* ``pad_corpora``, the padded epochs and ``n_real`` equal the reference's;
  the shards carry the whole pack's padded dims;
* ``ell_batched_use_ref(..., shards)`` equals the reference's over a grid,
  counters included;
* the sharded server's answers equal the reference server's (built with
  ``mesh=None``), and its ``shard_count`` / ``chunk_capacity`` /
  ``plan_groups`` / chunking equal the reference server's planning over a
  stand-in mesh of the same size (which never reaches ``shard_map``);
* the mesh's host threads: results in shard order, a shard's exception
  reaches the caller, nested calls run inline, launch counters count from
  every thread.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

import repro.core.batch as jbatch
from repro.distributed import pad_corpora as jpad_corpora
from repro.distributed import shard_batch as jshard_batch
import repro.kernels.ops as jops
import repro.query.engine as jquery
import repro.search.engine as jsearch
import repro.serving as js
from repro.core import compress_files as jcompress, flatten as jflatten
from repro.obs import global_registry as jregistry
from repro_torch.core import GrammarArrays, GrammarBatch
from repro_torch.core.batch import ANALYTICS_KINDS, METHODS, run_batched
from repro_torch.data import CompressedCorpus
from repro_torch.distributed import (CorpusMesh, corpus_mesh, mesh_size,
                                     pad_corpora, run_sharded, shard_batch)
from repro_torch.kernels import _common
from repro_torch.kernels import ops as tops
from repro_torch.obs import global_registry as tregistry
from repro_torch.search.engine import search_sharded
import repro_torch.serving as ts

from _oracle import oracle_batch, oracle_query, oracle_search_kind
from _torch_inputs import ragged_corpora

torch.set_num_threads(1)

FIELDS = [f.name for f in dataclasses.fields(GrammarArrays)]
TERMS = (1, 2, 3, 10_000)
PRED = ("or", (("term", 1, 1), ("and", (("term", 2, 2), ("term", 3, 1)))))
QUERIES = {
    "search_bm25": dict(terms=TERMS, k=3),
    "search_tfidf": dict(terms=(0, 5), k=10),
    "filter_count": dict(predicate=PRED),
    "agg_terms": dict(terms=(1, 2, 77), agg="max"),
    "phrase_count": dict(terms=(1, 2)),
}


@pytest.fixture(scope="module")
def packs():
    """(JAX gas, port gas) of the five ragged corpora, built once."""
    jgas, tgas = [], []
    for files, v in ragged_corpora():
        g, nf = jcompress(files, v)
        jga = jflatten(g, v, nf)
        jgas.append(jga)
        tgas.append(GrammarArrays.from_numpy(
            {n: getattr(jga, n) for n in FIELDS}))
    return jgas, tgas


@pytest.fixture(scope="module")
def reference(packs):
    """The JAX package's unsharded answers for every kind (frontier; its
    methods are bit-identical), computed once."""
    jgas, _ = packs
    jgb = jbatch.GrammarBatch.build(jgas)
    out = {kind: jbatch.run_batched(jgb, kind) for kind in ANALYTICS_KINDS}
    for kind, kw in QUERIES.items():
        if kind.startswith("search"):
            out[kind] = jsearch.batched_search(
                jgb, kw["terms"], k=kw["k"],
                scheme="bm25" if kind == "search_bm25" else "tfidf")
        else:
            out[kind] = jquery.run_batched_query(jgb, kind, **kw)
    return out


def _same(got, want, what, dtypes=True):
    """Bit-equal results; ``dtypes=False`` for the oracle, whose index
    arrays are int64 where the engines give int32."""
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{what}[{i}]", dtypes)
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    assert g.dtype == w.dtype or not dtypes, (what, g.dtype, w.dtype)
    assert np.array_equal(g, w), what


def _mesh(k):
    return corpus_mesh(("cpu",) * k)


# ------------------------------------------------------ results per kind --
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_run_sharded_equals_jax_unsharded(packs, reference, k, method):
    jgas, tgas = packs
    mesh = _mesh(k)
    assert mesh_size(mesh) == k
    for kind in ANALYTICS_KINDS:
        got = run_sharded(tgas, kind, mesh=mesh, method=method,
                          device="cpu")
        _same(got, reference[kind], f"{kind} k={k} {method}")
    if method in ("frontier", "frontier_ell", "frontier_fused"):
        for kind, kw in QUERIES.items():
            got = run_sharded(tgas, kind, mesh=mesh, method=method,
                              device="cpu", **kw)
            _same(got, reference[kind], f"{kind} k={k} {method}")


@pytest.mark.parametrize("k", [2, 3])
def test_sharded_results_equal_the_oracle(packs, k):
    jgas, tgas = packs
    gb = shard_batch(tgas, _mesh(k))
    for kind in ANALYTICS_KINDS:
        _same(run_batched(gb, kind), oracle_batch(jgas, kind), kind,
              dtypes=False)
    for kind, kw in QUERIES.items():
        if kind.startswith("search"):
            want = [oracle_search_kind(ga, kind, kw["terms"], k=kw["k"])
                    for ga in jgas]
            got = search_sharded(tgas, kw["terms"], k=kw["k"],
                                 scheme=kind.split("_")[1], mesh=_mesh(k))
        else:
            want = [oracle_query(ga, kind, **kw) for ga in jgas]
            got = run_sharded(tgas, kind, mesh=_mesh(k), **kw)
        _same(got, want, kind, dtypes=False)


# ------------------------------------------------------- pack structure --
@pytest.mark.parametrize("k", [2, 3, 4])
def test_padding_and_epochs_equal_the_reference(packs, k, monkeypatch):
    jgas, tgas = packs
    jpad, jreal = jpad_corpora(jgas, k)
    tpad, treal = pad_corpora(tgas, k)
    assert treal == jreal == len(tgas)
    assert [jgas.index(g) for g in jpad] == [tgas.index(g) for g in tpad]
    # the reference's shard_batch up to its placement (which needs a real
    # mesh): its GrammarBatch.shard only records n_real here
    monkeypatch.setattr(jbatch.GrammarBatch, "shard",
                        lambda self, mesh, n_real=None: dataclasses.replace(
                            self, n_real=n_real))
    epochs = [3, 1, 4, 1, 5]
    jgb = jshard_batch(jgas, mesh=_StandInMesh(k), epochs=epochs)
    mesh = _mesh(k)
    gb = shard_batch(tgas, mesh, epochs=epochs)
    assert gb.epochs == jgb.epochs and gb.n_real == jgb.n_real
    assert gb.n == jgb.n and gb.real == len(tgas) and gb.shards == k
    assert gb.signature[:-1] == jgb.signature[:-1] and gb.signature[-1] == k
    for i, sub in enumerate(gb.shard_packs):
        m = gb.n // k
        assert sub.mesh is None and sub.n == m
        assert sub.device == mesh.devices[i]
        assert (sub.R_pad, sub.E_pad, sub.T_pad, sub.F_pad, sub.V_pad,
                sub.Tf_pad) == (gb.R_pad, gb.E_pad, gb.T_pad, gb.F_pad,
                                gb.V_pad, gb.Tf_pad)
        assert sub.ell_plan_width() == gb.ell_plan_width()
        assert sub.epochs == gb.epochs[i * m: (i + 1) * m]
        assert sub.gas == gb.gas[i * m: (i + 1) * m]
    gb.check_epochs(epochs)
    with pytest.raises(Exception, match="epoch"):
        gb.check_epochs([3, 1, 4, 1, 6])


def test_shard_refuses_bad_meshes(packs):
    _, tgas = packs
    gb = GrammarBatch.build(tgas, device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        gb.shard(_mesh(2))
    with pytest.raises(ValueError, match="out of range"):
        GrammarBatch.build(tgas[:4], device="cpu").shard(_mesh(2), n_real=5)
    sharded = GrammarBatch.build(tgas[:4], device="cpu").shard(_mesh(2))
    with pytest.raises(ValueError, match="already sharded"):
        sharded.shard(_mesh(2))
    assert sharded.real == 4 and sharded.in_deg is None
    with pytest.raises(ValueError, match="statistics"):
        from repro_torch.search.engine import batch_search_stats
        batch_search_stats(sharded)
    with pytest.raises(ValueError, match="epochs"):
        shard_batch(tgas, _mesh(2), epochs=[0])


def test_corpus_mesh_over_cards_and_stand_ins(monkeypatch):
    assert corpus_mesh(("cpu",)) is None and corpus_mesh([]) is None
    assert mesh_size(None) == 1
    m = corpus_mesh(["cpu", torch.device("cpu"), "cpu"])
    assert isinstance(m, CorpusMesh) and m.size == 3
    assert m.devices == (torch.device("cpu"),) * 3
    # no card here: the default mesh is the single pack
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert corpus_mesh() is None
    # two visible cards: a two-shard mesh, one card each
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    m2 = corpus_mesh()
    assert m2.devices == (torch.device("cuda", 0), torch.device("cuda", 1))


# ------------------------------------------------------------- dispatch --
def _dispatch_counts(registry):
    snap = registry.snapshot()
    out = {}
    for fam in ("repro_kernel_dispatch_total",
                "repro_kernel_tuned_table_total"):
        for row in snap.get(fam, {}).get("samples", []):
            if "ell_vs_seg" in row["labels"].values():
                out[(fam, tuple(sorted(row["labels"].items())))] = \
                    row["value"]
    return out


def test_ell_batched_use_ref_agrees_with_the_reference():
    grid = [(e, n, rows, k, s)
            for e in (10, 4_000, 200_000)
            for n in (1, 2, 5, 16)
            for rows in (8, 40, 1000)
            for k in (2, 64, 4096)
            for s in (1, 2, 3, 4)]
    j0, t0 = _dispatch_counts(jregistry()), _dispatch_counts(tregistry())
    for args in grid:
        e, n, rows, k, s = args
        assert tops.ell_batched_use_ref(e, n, rows, k, shards=s) == \
            jops.ell_batched_use_ref(e, n, rows, k, shards=s), args
    j1, t1 = _dispatch_counts(jregistry()), _dispatch_counts(tregistry())
    delta = lambda a, b: {key: b[key] - a.get(key, 0) for key in b
                          if b[key] != a.get(key, 0)}
    assert delta(t0, t1) == delta(j0, j1)
    # the per-shard gate: 2 corpora x 40 rows pass at one shard, not two
    assert not tops.ell_batched_use_ref(4_000, 2, 40, 2)
    assert tops.ell_batched_use_ref(4_000, 2, 40, 2, shards=2)


def test_resolution_is_judged_per_shard(packs):
    """A sharded pack resolves ``auto`` against its shard count, as the
    reference's ``resolve_traversal_method`` does."""
    _, tgas = packs
    for k in (2, 4):
        gb = shard_batch(tgas, _mesh(k))
        dims = dict(n=gb.n, rows=gb.R_pad, k=gb.ell_plan_width(),
                    edges=gb.total_edges, f=gb.F_pad)
        for method in METHODS:
            for per_file in (False, True):
                want = jbatch.resolve_traversal_method(
                    method, shards=k, per_file=per_file, **dims)
                from repro_torch.core.batch import resolve_batch_method
                assert resolve_batch_method(gb, method,
                                            per_file=per_file) == want


# --------------------------------------------------------------- threads --
def test_mesh_threads_order_errors_and_nesting():
    mesh = _mesh(3)
    names = mesh.map(lambda x: (x, threading.current_thread().name),
                     [0, 1, 2])
    assert [x for x, _ in names] == [0, 1, 2]
    assert all(n.startswith("corpus-shard") for _, n in names)

    def boom(x):
        if x == 1:
            raise KeyError("shard 1 failed")
        return x
    with pytest.raises(KeyError, match="shard 1 failed"):
        mesh.map(boom, [0, 1, 2])
    # a map from inside a shard runs its items in turn on that thread
    inner = mesh.map(lambda x: mesh.map(lambda y: y * x, [1, 2, 3]),
                     [1, 2, 3])
    assert inner == [[1, 2, 3], [2, 4, 6], [3, 6, 9]]
    with pytest.raises(ValueError, match="items"):
        mesh.map(lambda x: x, [1, 2])
    mesh.close()
    assert mesh.map(lambda x: x + 1, [0, 1, 2]) == [1, 2, 3]


def test_launch_counters_count_from_every_thread():
    c = _common.launch_counter("shard-test")
    c.count = 0
    mesh = _mesh(4)
    mesh.map(lambda _: [c.inc() for _ in range(5000)], [0] * 4)
    assert c.count == 20_000


# --------------------------------------------------------------- serving --
def _servers(packs, **kw):
    jgas, tgas = packs
    jsrv = js.AnalyticsServer(max_batch=2, mesh=None)
    tsrv = ts.AnalyticsServer(max_batch=2, device="cpu", **kw)
    for i, (jga, tga) in enumerate(zip(jgas, tgas)):
        jsrv.register(f"c{i}", jga)
        tsrv.register(f"c{i}", tga)
    return jsrv, tsrv


def _all_kinds(Q, names):
    out = []
    for c in names:
        out += [Q(c, "word_count"), Q(c, "sort"), Q(c, "term_vector"),
                Q(c, "inverted_index"), Q(c, "ranked_inverted_index"),
                Q(c, "sequence_count", l=3)]
        out += [Q(c, kind, **kw) for kind, kw in QUERIES.items()]
    return out


@pytest.mark.parametrize("k", [2, 3])
def test_sharded_server_answers_equal_the_reference(packs, k):
    jsrv, tsrv = _servers(packs, mesh=_mesh(k), shard_min_corpora=2)
    names = tsrv.corpora()
    for rnd in range(2):                        # the second hits the cache
        want = jsrv.run(_all_kinds(js.Query, names))
        got = tsrv.run(_all_kinds(ts.Query, names))
        _same(got, want, f"k={k} round {rnd}")
    assert tsrv.stats.sharded_calls > 0
    assert tsrv.stats.sharded_calls == tsrv.stats.batched_calls
    # every pack is built once, then served from the cache (padded ones
    # too: their padding rows' epochs repeat real rows')
    st_ = tsrv.stats
    assert st_.epoch_invalidations == 0
    assert st_.batch_cache_hits == (st_.batched_calls + st_.single_calls
                                    - len(tsrv._batches))
    assert all(key[1] == k for key in tsrv._batches if len(key[0]) > 1)


def test_sharded_store_registration_and_epochs(packs):
    files, v = ragged_corpora()[2]
    srv = ts.AnalyticsServer(max_batch=2, device="cpu", mesh=_mesh(2),
                             shard_min_corpora=2)
    store = CompressedCorpus.build(files[:3], v)
    srv.register("store", store)
    srv.register("c1", packs[1][1])
    q = [ts.Query("store", "word_count"), ts.Query("c1", "word_count")]
    before = srv.run(q)
    store.append_files(files[3:])
    after = srv.run(q)
    assert srv.stats.epoch_invalidations == 1 and srv.stats.sharded_calls == 2
    want = np.bincount(np.concatenate(files), minlength=v).astype(np.float32)
    _same(after[0], want, "store after append", dtypes=False)
    assert not np.array_equal(before[0], after[0])


class _StandInMesh:
    """What the reference server's planning reads of a mesh: its size."""

    def __init__(self, size):
        self.size = size


@pytest.mark.parametrize("k,min_corpora", [(2, None), (3, 2), (4, 5)])
def test_shard_planning_equals_the_reference(packs, k, min_corpora,
                                             monkeypatch):
    jgas, tgas = packs
    jsrv = js.AnalyticsServer(max_batch=2, mesh=_StandInMesh(k),
                              shard_min_corpora=min_corpora)
    tsrv = ts.AnalyticsServer(max_batch=2, device="cpu", mesh=_mesh(k),
                              shard_min_corpora=min_corpora)
    assert tsrv.shard_min_corpora == jsrv.shard_min_corpora
    for n in range(1, 12):
        assert tsrv.shard_count(n) == jsrv.shard_count(n), n
    for t in range(1, 6):
        assert tsrv.chunk_capacity(t) == jsrv.chunk_capacity(t), t
    for bad in (0, -1):
        for srv in (jsrv, tsrv):
            with pytest.raises(ValueError):
                srv.chunk_capacity(bad)
    with pytest.raises(ValueError):
        ts.AnalyticsServer(device="cpu", mesh=_mesh(2), shard_min_corpora=0)
    for i, (jga, tga) in enumerate(zip(jgas, tgas)):
        jsrv.register(f"c{i}", jga)
        tsrv.register(f"c{i}", tga)
    names = tsrv.corpora()
    qs = _all_kinds
    assert tsrv.plan_groups(qs(ts.Query, names)) == \
        jsrv.plan_groups(qs(js.Query, names))
    chunks = {"j": [], "t": []}
    for tag, srv in (("j", jsrv), ("t", tsrv)):
        monkeypatch.setattr(
            srv, "execute_chunk",
            lambda kind, chunk, tag=tag, srv=srv, **kw: (
                chunks[tag].append((kind, tuple(chunk),
                                    srv.shard_count(len(chunk)))),
                {n: None for n in chunk})[1])
        for target in (1, 2, 3, 8):
            srv.run_group("word_count", names, target_shards=target)
    assert chunks["t"] == chunks["j"]


def test_async_queue_target_shards(packs):
    """Four corpora of one size bucket fill ``max_batch * target_shards``:
    the group flushes at once, as one sharded pack."""
    jgas, tgas = packs
    jsrv = js.AnalyticsServer(max_batch=2, mesh=None)
    tsrv = ts.AnalyticsServer(max_batch=2, device="cpu", mesh=_mesh(2),
                              shard_min_corpora=2)
    names = [f"a{i}" for i in range(4)]
    for name in names:
        jsrv.register(name, jgas[2])
        tsrv.register(name, tgas[2])
    with pytest.raises(ValueError, match="target_shards"):
        ts.AsyncAnalyticsServer(tsrv, target_shards=0)
    aq = ts.AsyncAnalyticsServer(tsrv, target_shards=2, idle_timeout=60.0)
    futs = [aq.submit(ts.Query(c, "word_count")) for c in names]
    assert all(f.done() for f in futs)
    assert tsrv.stats.flushes.get("max_batch") == 1
    assert tsrv.stats.sharded_calls == 1
    want = jsrv.run([js.Query(c, "word_count") for c in names])
    _same([f.result() for f in futs], want, "async")
    aq.close()
