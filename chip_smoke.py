#!/usr/bin/env python3
"""Drive the PyTorch port's analytics engines and its analytics server once
on one NVIDIA H100.

    python3 chip_smoke.py

run from the root of a checkout, on a machine with one Hopper card and the
CUDA toolkit.  Phases:

1. Set-up: print the card's name and power limit (nvidia-smi), build the
   five CUDA kernels from ``src/repro_torch/kernels/csrc`` and print the
   build seconds.
2. Data: 16 synthetic corpora (64 files x 4000 tokens, vocab 20,000,
   Zipfian words with 60% repeated phrases) from a fixed seed, compressed
   with the port's Sequitur and packed into one ``GrammarBatch`` on the
   card.  The paper's datasets run to gigabytes; host-side Python Sequitur
   is what cuts the scale here.  The corpus count is lowered only if the
   dense ELL plan would exceed ``ELL_PLAN_MAX_ENTRIES``, so that every
   explicit ELL method resolves to itself.  A second, smaller pack (a file
   subset) is sized so the per-file ELL rounds are admitted
   (``ell_vector_plan_ok``); at the full pack they degrade to segment_sum.
3. Engine (the main path), with launch counts zeroed just before and read
   just after:
   a. ``run_batched`` for all six analytics under all six traversal
      methods, word count and sort also under the kernel backend, on both
      packs;
   b. the single-corpus engine on one more corpus (256 files x 4000
      tokens, another seed) built through ``CompressedCorpus.build``: the
      six analytics under every single-corpus method and ``auto`` (word
      count and sort under both backends), ``bottom_up_tables`` (checked
      against the word count, with its peak device memory),
      ``bottom_up_bounds`` and the memory plans, the ELL row sums of the
      in-edge plan as the flow check of the top-down weights (row r's sum
      is rule r's weight for r >= 1, 0 for the root), append == rebuild
      with the memoized weights recomputed, window reads, save/load.
   Every analytic is checked exactly against a numpy decompress-then-scan
   oracle built from the raw token files.
4. Serving (the path users call), with launch counts zeroed just before
   and read just after: one ``AnalyticsServer(max_batch=16)`` on the card
   per method (``frontier``, ``frontier_ell``, ``frontier_fused``) holds
   the pack's 16 corpora and the subset's 4 as ``GrammarArrays`` and the
   single corpus as its ``CompressedCorpus``; every corpus is asked all 11
   served kinds — the six analytics, BM25 and TF-IDF top-10 over two
   three-term queries (an out-of-vocabulary term; a term so rare that
   zero-score ties reach the top 10), an and/or filter, sum and max
   aggregations, and two phrases (the first three words of one of the
   generator's repeated phrases, and one that never occurs);
   ``sequence_count`` and ``phrase_count`` under ``frontier`` only (host
   sequence planning).  Each corpus set's queries of one kind go through
   ``run`` six times: every answer exact against the raw-file oracle, each
   repeat equal to the first, ``[serve]`` lines with the first call's and
   the next five's median host-clock latency, and ``method_fallbacks``
   held to the routing ``resolve_batch_method`` gives each chunk.  Then
   the same queries go through ``AsyncAnalyticsServer`` from four threads
   with deadlines: equal to the sync answers, nothing shed, flush reasons
   printed.  Kernels 1, 2 and 3 must each launch here (``serve_launches``
   in each record).
5. Checkpoint, with launch counts zeroed just before and read just after:
   the single corpus built from 75% of its files and grown by one append
   (epoch 1) is snapshot with ``save_corpus`` into a temporary directory
   and restored; every field and the epoch survive, an append of the
   remaining files after the restore equals the same append on the
   unbroken store and a build of all files, and the restored corpus's six
   analytics (``frontier_fused``, kernel histogram) are exact against the
   oracle.  Kernels 2 and 4 must launch here.
6. Sharding, counts zeroed just before and read just after: the pack's
   corpora over corpus meshes of 2 and 3 shards on the one card
   (``corpus_mesh(("cuda:0",) * k)``; 3 pads 16 corpora to 18) and, with
   two or more cards, over every visible card: the six analytics under
   ``frontier``, ``frontier_ell`` and ``frontier_fused`` on the sharded
   pack, a BM25 search, a filter and a phrase through ``run_sharded`` —
   every answer exact against the oracle and equal to the unsharded
   pack's, wall times beside the unsharded ones — the subset's per-file
   ELL rounds and kernel histogram over 2 shards, then one
   ``AnalyticsServer(mesh=..., shard_min_corpora=2)`` a mesh serving the
   11 kinds to every pack corpus, exact, with ``sharded_calls > 0``.
   Kernels 1-4 must launch here.
7. Kernels: each kernel at the main path's shapes against its plain torch
   version on the same card inputs (exact equality: all values are
   integer-valued float32 below 2^24), timed with CUDA events around one
   wrapper call (``ms``, median of 20 runs after warm-up) beside its bound
   (bytes over 3.35 TB/s or float32 operations over 67 TFLOP/s) and, for
   the histogram and the row sums, a library yardstick the port never
   calls.  Each record splits that time: ``device_ms`` is the device's own
   time a call (the kernels and memsets the call launches, from
   ``torch.profiler``; ``device_ops`` lists them) and ``host_us`` the
   wrapper's host cost a call (200 calls back to back on the host clock).
   The histogram is also timed in the engine's batched call
   (``batched_*`` fields).  The fused frontier kernel is timed at the pack
   and again on the single corpus's N=1 plan (extra ``single_*`` fields of
   its record), each with the grid of its cooperative launch and a
   breakdown (the kernel cut to one round against the whole loop).
8. Autotune, counts zeroed just before and read just after: every
   kernel's launch shapes swept (``kernels/autotune.py``) at the shapes of
   the pack, the subset and the single corpus that its main path runs,
   every candidate exact against the plain version before its time
   counts (device time a call: CUDA events around 20 calls queued behind
   a spin kernel), and the ``ell_vs_seg`` route timed at the pack and the
   subset; the table goes to a temporary file, is reloaded, and ``ops``
   must hit it at every swept shape with the same answers.  Each record
   gains ``tuned_shape`` / ``tuned_device_ms`` at its main-path shape
   beside ``default_sweep_device_ms``.

Phases 1-7 run with no tuned table (``REPRO_AUTOTUNE_CACHE`` points at a
file that does not exist), so they launch the shipped shapes.
It prints one ``{"kernels": [...]}`` line and, last, the device line, and
exits non-zero on any failure — or at once when there is no CUDA device or
no ``src/repro_torch`` beside it.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# the data (phase 2)
N_CORPORA = 16
N_FILES = 64
TOKENS_PER_FILE = 4000
VOCAB = 20000
PHRASE_RATE = 0.6
N_PHRASES = 200
PHRASE_LEN = 10
SEED = 0
SEQ_L = 3
# the single corpus (phase 3b): a corpus that is not in the pack
SINGLE_FILES = 256
SINGLE_SEED = SEED + 16
# files of the single corpus built first; the rest are appended
INGEST_SHARE = 0.75

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# the serving phase (phase 4)
SERVE_METHODS = ("frontier", "frontier_ell", "frontier_fused")
SERVE_K = 10
SERVE_REPEATS = 5
SERVE_THREADS = 4
# async queue: idle flush after SERVE_IDLE s, deadlines SERVE_DEADLINE s out
SERVE_IDLE = 1.0
SERVE_DEADLINE = 600.0
# the kernels the serving path must launch
SERVE_KERNELS = ("ell_propagate_batched", "ell_frontier_fused",
                 "ell_propagate_vector")

# the checkpoint phase (phase 5): the kernels its analytics must launch
CKPT_KERNELS = ("ell_frontier_fused", "weighted_bincount")
# the sharding phase (phase 6): shard counts on the one card, methods, and
# the kernels it must launch
SHARD_COUNTS = (2, 3)
SHARD_METHODS = ("frontier", "frontier_ell", "frontier_fused")
SHARD_KERNELS = ("ell_propagate_batched", "ell_frontier_fused",
                 "ell_propagate_vector", "weighted_bincount")

TIMING_REPS = 20
TIMING_WARMUP = 3
# back-to-back wrapper calls timed on the host clock for host_us
HOST_CALLS = 200
# profiler traces taken before device_ms gives up
PROFILE_ATTEMPTS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ----------------------------------------------------------------------- #
# Oracle: decompress-then-scan over the raw token files                    #
# ----------------------------------------------------------------------- #
def oracle(files, vocab: int, l: int = SEQ_L) -> dict:
    """The six analytics of one corpus from its raw files, shaped like the
    engine's ``run_batched`` results."""
    files = [np.asarray(f, np.int64) for f in files]
    wc = np.bincount(np.concatenate(files) if files else np.zeros(0, int),
                     minlength=vocab).astype(np.float32)
    tv = np.stack([np.bincount(f, minlength=vocab) for f in files]
                  ).astype(np.float32)
    order = np.argsort(-wc, kind="stable")
    rank = np.argsort(-tv, axis=0, kind="stable")
    grams = [np.stack([f[i: len(f) - l + 1 + i] for i in range(l)], axis=1)
             for f in files if len(f) >= l]
    grams = np.concatenate(grams) if grams else np.zeros((0, l), np.int64)
    uniq, counts = np.unique(grams, axis=0, return_counts=True)
    return {
        "word_count": wc,
        "sort": (order.astype(np.int32), wc[order]),
        "term_vector": tv,
        "inverted_index": tv > 0,
        "ranked_inverted_index": (rank.T.astype(np.int32),
                                  np.take_along_axis(tv, rank, axis=0).T),
        "sequence_count": (uniq.astype(np.int32), counts.astype(np.float32)),
    }


def assert_same(got, want, what: str) -> None:
    if isinstance(want, tuple):
        check(isinstance(got, tuple) and len(got) == len(want),
              f"{what}: result has the wrong arity")
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{what}[{i}]")
        return
    g = np.asarray(got)
    check(g.shape == want.shape, f"{what}: shape {g.shape} != {want.shape}")
    check(g.dtype == want.dtype, f"{what}: dtype {g.dtype} != {want.dtype}")
    bad = np.argwhere(g != want)
    check(len(bad) == 0, f"{what}: {len(bad)} entries differ from the "
                         f"oracle, first at {bad[:1].tolist()}")


# ----------------------------------------------------------------------- #
# Phases                                                                   #
# ----------------------------------------------------------------------- #
def corpus_files(name: str, n_files: int, tokens_per_file: int, vocab: int,
                 seed: int):
    from repro_torch.data.synthetic import CorpusSpec, make_corpus
    return make_corpus(CorpusSpec(
        name, n_files=n_files, tokens_per_file=tokens_per_file, vocab=vocab,
        phrase_rate=PHRASE_RATE, n_phrases=N_PHRASES, phrase_len=PHRASE_LEN,
        seed=seed))


def make_corpora(n: int, n_files: int, tokens_per_file: int, vocab: int):
    from repro_torch.core import compress_files, flatten

    corpora = []
    for i in range(n):
        files = corpus_files(f"smoke{i}", n_files, tokens_per_file, vocab,
                             SEED + i)
        g, nf = compress_files(files, vocab)
        corpora.append((files, flatten(g, vocab, nf)))
    return corpora


def plan_dims(gas):
    """(R_pad, K) of a pack of ``gas`` without building it."""
    from repro_torch.core.batch import _round_up_pow2
    from repro_torch.core.grammar import pow2_bucket
    return (_round_up_pow2(max(ga.num_rules for ga in gas)),
            pow2_bucket(max(int(ga.in_deg.max(initial=0)) for ga in gas)))


def fit_scalar_pack(corpora):
    """The largest corpus prefix whose dense plan every explicit ELL
    method admits."""
    from repro_torch.core import resolve_traversal_method
    for n in range(len(corpora), 0, -1):
        gas = [ga for _, ga in corpora[:n]]
        rows, k = plan_dims(gas)
        edges = sum(ga.num_edges for ga in gas)
        if all(resolve_traversal_method(m, n=n, rows=rows, k=k, edges=edges)
               == m for m in ("frontier_ell", "leveled_ell",
                              "frontier_fused")):
            return n
    raise SmokeFailure("no corpus count admits the ELL methods")


def fit_vector_subset(corpora, vocab: int):
    """A file subset of the first corpora whose per-file ELL rounds are
    admitted (``ell_vector_plan_ok``); returns its corpora."""
    from repro_torch.core import compress_files, flatten
    from repro_torch.core import resolve_traversal_method
    n = min(4, len(corpora))
    f = max(1, len(corpora[0][0]) // 4)
    while True:
        sub = []
        for files, _ in corpora[:n]:
            g, nf = compress_files(files[:f], vocab)
            sub.append((files[:f], flatten(g, vocab, nf)))
        gas = [ga for _, ga in sub]
        rows, k = plan_dims(gas)
        edges = sum(ga.num_edges for ga in gas)
        f_pad = max(1, 1 << (max(ga.num_files for ga in gas) - 1).bit_length())
        if all(resolve_traversal_method(m, n=n, rows=rows, k=k, edges=edges,
                                        per_file=True, f=f_pad) == m
               for m in ("frontier_ell", "leveled_ell")):
            return sub
        if f == 1 and n == 1:
            raise SmokeFailure("no file subset admits the per-file ELL "
                               "rounds")
        if f > 1:
            f //= 2
        else:
            n //= 2


def pack_bytes(gb) -> int:
    import torch
    return sum(v.numel() * v.element_size() for v in vars(gb).values()
               if isinstance(v, torch.Tensor))


def run_engine(gb, oracles, label: str) -> None:
    """Every kind x method (+ kernel backend) through ``run_batched``,
    each result checked against the oracle."""
    from repro_torch.core import ANALYTICS_KINDS, METHODS, run_batched
    from repro_torch.core.batch import resolve_batch_method

    for m in METHODS:
        log(f"[{label}] method {m}: scalar -> "
            f"{resolve_batch_method(gb, m)}, per-file -> "
            f"{resolve_batch_method(gb, m, per_file=True)}")
    times = {}
    runs = [(k, m, "torch") for k in ANALYTICS_KINDS for m in METHODS]
    runs += [(k, m, "kernel") for k in ("word_count", "sort")
             for m in METHODS]
    for kind, method, backend in runs:
        t0 = time.perf_counter()
        res = run_batched(gb, kind, method, backend=backend, l=SEQ_L)
        times[(kind, method, backend)] = (time.perf_counter() - t0) * 1e3
        for i, r in enumerate(res):
            assert_same(r, oracles[i][kind],
                        f"[{label}] {kind}/{method}/{backend} corpus {i}")
    slowest = sorted(times.items(), key=lambda kv: -kv[1])[:6]
    log(f"[{label}] {len(runs)} runs match the oracle; total "
        f"{sum(times.values()):.1f} ms; slowest: "
        + ", ".join(f"{k}/{m}/{b} {t:.1f} ms" for (k, m, b), t in slowest))


def to_host(r):
    """An engine result as numpy (tensors copied off the device)."""
    if isinstance(r, tuple):
        return tuple(to_host(x) for x in r)
    return r.cpu().numpy() if hasattr(r, "cpu") else r


def assert_corpus_equal(got, want, what: str) -> None:
    import dataclasses
    for f in dataclasses.fields(want.ga):
        assert_same(getattr(got.ga, f.name), np.asarray(
            getattr(want.ga, f.name)), f"{what}: field {f.name}")
    assert_same(got.file_starts, want.file_starts, f"{what}: file_starts")
    assert_same(got.file_lens, want.file_lens, f"{what}: file_lens")


def single_phase(files, vocab: int, dev):
    """The single-corpus engine and the store on one corpus (phase 3b);
    returns ``(ga, weights)`` for the kernel phase."""
    import tempfile
    import torch
    import repro_torch.core as tc
    from repro_torch.core.traversal import TOP_DOWN_METHODS
    from repro_torch.data import CompressedCorpus
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    cc = CompressedCorpus.build(files, vocab)
    ga = cc.ga
    K = tc.pow2_bucket(int(ga.in_deg.max(initial=0)))
    log(f"[single] {len(files)} files x {len(files[0])} tokens (vocab "
        f"{vocab}) compressed in {time.perf_counter() - t0:.1f} s: "
        f"{ga.num_rules} rules, {ga.num_edges} edges, {len(ga.tw_rule)} "
        f"word-table entries, max in-degree {int(ga.in_deg.max())} (K={K}), "
        f"{ga.num_levels} levels")
    want = oracle(files, vocab)
    methods = TOP_DOWN_METHODS + ("auto",)
    for m in methods:
        r = m if m != "auto" else tc.selector.select_traversal(ga)
        log(f"[single] method {m}: scalar -> "
            f"{tc.resolve_single_method(ga, r)}, per-file -> "
            f"{tc.resolve_single_method(ga, r, per_file=True)}")
    apps = {"word_count": tc.word_count, "sort": tc.sort_words,
            "term_vector": tc.term_vector,
            "inverted_index": tc.inverted_index,
            "ranked_inverted_index": tc.ranked_inverted_index,
            "sequence_count": tc.sequence_count}
    runs = [(k, m, "torch") for k in apps for m in methods]
    runs += [(k, m, "kernel") for k in ("word_count", "sort")
             for m in methods]
    total = 0.0
    for kind, method, backend in runs:
        kw = {"backend": backend} if kind in ("word_count", "sort") else {}
        t0 = time.perf_counter()
        res = to_host(apps[kind](ga, method=method, device=dev, **kw))
        ms = (time.perf_counter() - t0) * 1e3
        total += ms
        assert_same(res, want[kind], f"[single] {kind}/{method}/{backend}")
        log(f"[single] {kind}/{method}/{backend}: {ms:.1f} ms, exact")
    log(f"[single] {len(runs)} runs match the oracle; total {total:.1f} ms")

    # flow check of the top-down weights through the row-sum kernel
    w = tc.top_down_weights(ga, "frontier", device=dev)
    src, freq = (torch.as_tensor(a, device=dev)
                 for a in ga.in_edges_ell_dense())
    flow = ops.ell_row_sums(w, src, freq)
    check(float(flow[0]) == 0.0 and torch.equal(flow[1:], w[1:]),
          "[single] ell_row_sums of the in-edge plan != the weights")
    log(f"[single] flow check: row sums of the [{src.shape[0]}, "
        f"{src.shape[1]}] in-edge plan == weights on every rule >= 1")

    # bottom-up tables, bounds, arenas
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        resident = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    C, result = tc.bottom_up_tables(ga, device=dev)
    ms = (time.perf_counter() - t0) * 1e3
    assert_same(result.cpu().numpy(), want["word_count"],
                "[single] bottom_up_tables result")
    table_sizes = (C > 0).sum(dim=1).cpu().numpy()
    del C
    if cuda:
        top = torch.cuda.max_memory_allocated(dev)
        peak = (f"{top - resident} B of its own ({top} B peak over "
                f"{resident} B resident before the call)")
    else:
        peak = "not measured (CPU)"
    log(f"[single] bottom_up_tables: [{ga.num_rules}, {vocab}] in "
        f"{ms:.1f} ms, == word_count; device memory {peak}")
    bounds = tc.bottom_up_bounds(ga, device=dev).cpu().numpy()
    check(bool((bounds >= table_sizes).all()),
          "[single] bottom_up_bounds below a local table size")
    tables = tc.plan_local_tables(ga, device=dev)
    streams = tc.plan_streams(ga, SEQ_L)
    check(tables.total == int(np.minimum(bounds, vocab).sum()),
          "[single] plan_local_tables total")
    check(streams.total >= len(tc.sequence.plan_stream(ga, SEQ_L).st_kind),
          "[single] plan_streams below the stream length")
    log(f"[single] bounds dominate the tables; arenas: tables "
        f"{tables.total}, streams {streams.total} entries")

    # ingest: build a prefix, append the rest == build everything
    cut = max(1, int(len(files) * INGEST_SHARE))
    t0 = time.perf_counter()
    grown = CompressedCorpus.build(files[:cut], vocab)
    before = grown.top_down_weights(device=dev)
    grown.append_files(files[cut:])
    check(grown.epoch == 1, "[single] append did not bump the epoch")
    assert_corpus_equal(grown, cc, "[single] append != rebuild")
    after = grown.top_down_weights(device=dev)
    check(after is not before and torch.equal(after, w),
          "[single] memoized weights not recomputed after the append")
    log(f"[single] ingest: build({cut}) + append({len(files) - cut}) == "
        f"build({len(files)}), epoch 1, weights recomputed "
        f"({time.perf_counter() - t0:.1f} s)")

    # window reads
    rng = np.random.default_rng(SINGLE_SEED)
    for fid in rng.integers(0, len(files), 4):
        f = files[int(fid)]
        off = int(rng.integers(0, len(f)))
        assert_same(cc.window(int(fid), off, 100),
                    np.asarray(f[off: off + 100], np.int64),
                    f"[single] window({int(fid)}, {off})")
    stream = np.concatenate([np.append(np.asarray(f, np.int64), vocab + i)
                             for i, f in enumerate(files)])
    for off in (0, int(rng.integers(0, len(stream))), len(stream) - 10):
        assert_same(cc.global_window(off, 64), stream[off: off + 64],
                    f"[single] global_window({off})")
    log("[single] window and global_window reads == the raw files")

    # save / load
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "corpus.npz")
        grown.save(path)
        loaded = CompressedCorpus.load(path)
    check(loaded.epoch == 1, "[single] load lost the epoch")
    assert_corpus_equal(loaded, grown, "[single] save/load")
    log("[single] save/load round-trips every field and the epoch")
    return (ga, w), cc, want


# ----------------------------------------------------------------------- #
# Serving (phase 4): the analytics server, sync and async                 #
# ----------------------------------------------------------------------- #
# BM25 constants, float32, and the scoring in the engine's operation order
K1, B = np.float32(1.2), np.float32(0.75)
ONE, HALF = np.float32(1.0), np.float32(0.5)


def search_oracle(tv, terms, k: int, scheme: str):
    """BM25 / TF-IDF top-k of one corpus from its raw-file term vector
    ``tv [F, V]``: (ids int32, scores float32), ties toward the lower file
    id (a stable argsort)."""
    F, V = tv.shape
    dl = tv.sum(axis=1, dtype=np.float32)
    df = (tv > 0).sum(axis=0).astype(np.float32)
    n = np.float32(F)
    avgdl = np.float32(dl.sum(dtype=np.float32)) / np.float32(max(F, 1))
    if not avgdl > 0:
        avgdl = ONE
    norm = (K1 * (ONE - B + B * (dl / np.float32(avgdl)))).astype(np.float32)
    t = np.asarray(terms, np.int64)
    ok = (t >= 0) & (t < V)
    tf_q = np.zeros((F, len(t)), np.float32)
    tf_q[:, ok] = tv[:, t[ok]]
    df_q = np.zeros(len(t), np.float32)
    df_q[ok] = df[t[ok]]
    if scheme == "bm25":
        idf = np.log(ONE + (n - df_q + HALF) / (df_q + HALF)).astype(
            np.float32)
        quot = (tf_q * (K1 + ONE)) / (tf_q + norm[:, None])
    else:
        idf = (np.log((n + ONE) / (df_q + ONE)) + ONE).astype(np.float32)
        quot = tf_q
    score = np.zeros(F, np.float32)
    for j in range(len(t)):                 # term by term, as the engine
        score = score + idf[j] * quot[:, j]
    order = np.argsort(-score, kind="stable")[: min(int(k), F)]
    return order.astype(np.int32), score[order]


def filter_oracle(tv, pred) -> np.ndarray:
    F, V = tv.shape

    def ev(node):
        if node[0] == "term":
            _, t, c = node
            cnt = tv[:, t] if t < V else np.zeros(F, np.float32)
            return cnt >= np.float32(c)
        masks = [ev(ch) for ch in node[1]]
        out = masks[0]
        for m in masks[1:]:
            out = (out & m) if node[0] == "and" else (out | m)
        return out

    return np.flatnonzero(ev(pred)).astype(np.int32)


def agg_oracle(tv, terms, op: str):
    F, V = tv.shape
    pf = np.zeros(F, np.float32)
    for t in terms:
        cnt = tv[:, t] if t < V else np.zeros(F, np.float32)
        pf = pf + cnt if op == "sum" else np.maximum(pf, cnt)
    total = (np.float32(pf.sum(dtype=np.float32)) if op == "sum"
             else np.float32(pf.max()) if F else np.float32(0.0))
    return pf, total


def phrase_oracle(files, phrase) -> np.float32:
    ph = np.asarray(phrase, np.int64)
    count = 0
    for f in files:
        f = np.asarray(f, np.int64)
        if len(f) >= len(ph):
            wins = np.lib.stride_tricks.sliding_window_view(f, len(ph))
            count += int((wins == ph[None, :]).all(axis=1).sum())
    return np.float32(count)


def serve_specs(sets, vocab: int):
    """``[(kind, params)]`` every registered corpus is asked: the six
    analytics, two three-term searches per scheme (k=10; one term out of
    the vocabulary, and one so rare that zero-score ties reach the top
    10), an and/or filter, sum and max aggregations, and two phrases: the
    first three words of the generator's first repeated phrase and one
    that never occurs."""
    from repro_torch.data.synthetic import zipf_words
    files = sets["pack"][0][2]
    tv = sets["pack"][0][3]["term_vector"]
    df = (tv > 0).sum(axis=0)
    by_df = np.argsort(-df, kind="stable")
    common, mid = int(by_df[0]), int(by_df[len(files) // 2])
    rare = int(np.flatnonzero(df == 2)[0]) if (df == 2).any() else \
        int(by_df[np.count_nonzero(df) - 1])
    oov = vocab + 7
    phrase = tuple(int(t) for t in zipf_words(np.random.default_rng(SEED),
                                              PHRASE_LEN, vocab)[:3])
    absent = (phrase[2], phrase[1], phrase[0])
    if any(phrase_oracle(fs, absent) for name in sets
           for _, _, fs, _ in sets[name]):
        absent = (phrase[0], oov, phrase[1])
    pred = ("or", (("and", (("term", common, 3), ("term", mid, 1))),
                   ("term", rare, 1)))
    specs = [(k, {}) for k in ("word_count", "sort", "term_vector",
                               "inverted_index", "ranked_inverted_index")]
    specs.append(("sequence_count", dict(l=SEQ_L)))
    for kind in ("search_bm25", "search_tfidf"):
        specs += [(kind, dict(terms=(common, rare, oov), k=SERVE_K)),
                  (kind, dict(terms=(rare, oov, mid), k=SERVE_K))]
    specs.append(("filter_count", dict(predicate=pred)))
    specs += [("agg_terms", dict(terms=(common, mid, rare, oov), agg=op))
              for op in ("sum", "max")]
    specs += [("phrase_count", dict(terms=phrase)),
              ("phrase_count", dict(terms=absent))]
    log(f"[serve] terms: common {common} (df {int(df[common])} of "
        f"{len(files)} files in p0), mid {mid} (df {int(df[mid])}), rare "
        f"{rare} (df {int(df[rare])}), out of vocabulary {oov}; phrases "
        f"{phrase} and {absent}")
    return specs


def serve_oracle(kind: str, params: dict, files, want):
    """The raw-file answer to one query, shaped like the server's."""
    tv = want["term_vector"]
    if kind in want:
        return want[kind]
    if kind in ("search_bm25", "search_tfidf"):
        return search_oracle(tv, params["terms"], params["k"],
                             "bm25" if kind == "search_bm25" else "tfidf")
    if kind == "filter_count":
        return filter_oracle(tv, params["predicate"])
    if kind == "agg_terms":
        return agg_oracle(tv, params["terms"], params["agg"])
    return phrase_oracle(files, params["terms"])


def expected_fallbacks(srv, sets, kind: str, groups: int, counter) -> None:
    """Count, as ``resolve_batch_method`` (or the single-corpus analogue)
    routes each chunk, the explicit-ELL requests of one ``run`` of
    ``kind`` that land on a segment_sum base — what
    ``stats.method_fallbacks`` must show.  Each corpus set is one chunk of
    each of the kind's ``groups`` groups."""
    from repro_torch.core import (resolve_single_method,
                                  resolve_traversal_method)
    from repro_torch.core.batch import (PER_FILE_KINDS,
                                        is_segment_sum_fallback)
    from repro_torch.search.index import base_method
    stats_kind = kind in ("search_bm25", "search_tfidf", "filter_count",
                          "agg_terms")
    per_file = kind in PER_FILE_KINDS or stats_kind
    requested = base_method(srv.method) if stats_kind else srv.method
    for name, members in sets.items():
        if len(members) == 1:
            resolved = resolve_single_method(members[0][1].ga, requested,
                                             per_file=per_file)
        else:
            gas = [m[1] for m in members]
            rows, k = plan_dims(gas)
            f = max(1, 1 << (max(ga.num_files for ga in gas) - 1
                             ).bit_length())
            resolved = resolve_traversal_method(
                requested, n=len(gas), rows=rows, k=k,
                edges=sum(ga.num_edges for ga in gas), per_file=per_file,
                f=f)
        if is_segment_sum_fallback(requested, resolved):
            counter[f"{requested}->{resolved}"] += groups


def serve_phase(sets, vocab: int, dev):
    """Phase 4: every corpus set registered on one ``AnalyticsServer`` per
    method (the pack's corpora and the subset's as ``GrammarArrays``, the
    single corpus as its ``CompressedCorpus``), every served kind asked of
    every corpus through ``run`` — each answer exact against the raw-file
    oracle, repeat calls timed and equal to the first — then the same
    queries through ``AsyncAnalyticsServer`` from SERVE_THREADS threads,
    equal to the sync answers with nothing shed.  Returns the query specs."""
    import collections
    import threading
    from repro_torch.serving import (AnalyticsServer, AsyncAnalyticsServer,
                                     Query)
    t_phase = time.perf_counter()
    specs = serve_specs(sets, vocab)
    kinds = list(dict.fromkeys(k for k, _ in specs))
    for method in SERVE_METHODS:
        srv = AnalyticsServer(max_batch=16, method=method, device=dev)
        for members in sets.values():
            for name, src, _, _ in members:
                srv.register(name, src)
        sync = {}
        fallbacks = collections.Counter()
        for kind in kinds:
            if kind in ("sequence_count", "phrase_count") and \
                    method != SERVE_METHODS[0]:
                continue        # host sequence planning: one method only
            lat = []
            for set_name, members in sets.items():
                qs = [(name, files, want, kw, Query(name, kind, **kw))
                      for name, _, files, want in members
                      for k2, kw in specs if k2 == kind]
                times, first = [], None
                for rep in range(1 + SERVE_REPEATS):
                    t0 = time.perf_counter()
                    res = srv.run([q for *_, q in qs])
                    times.append((time.perf_counter() - t0) * 1e3)
                    if first is None:
                        first = res
                        for (name, files, want, kw, _), r in zip(qs, res):
                            assert_same(to_tuple(r), serve_oracle(
                                kind, kw, files, want),
                                f"[serve] {method} {name} {kind} {kw}")
                    else:
                        for (name, *_), r, r0 in zip(qs, res, first):
                            assert_same(to_tuple(r), to_tuple(r0),
                                        f"[serve] {method} {name} {kind} "
                                        f"repeat {rep}")
                for (name, _, _, kw, q), r in zip(qs, first):
                    sync[(name, kind, repr(kw))] = (q, r)
                lat.append(f"{set_name} {times[0]:.1f}/"
                           f"{statistics.median(times[1:]):.1f}")
            groups = sum(1 for k2, _ in specs if k2 == kind)
            expected_fallbacks(srv, sets, kind,
                               groups * (1 + SERVE_REPEATS), fallbacks)
            log(f"[serve] {method} {kind}: " + ", ".join(lat)
                + " ms (first call / median of the next "
                f"{SERVE_REPEATS}, host clock through run)")
        got_fb = dict(srv.stats.method_fallbacks)
        check(got_fb == dict(fallbacks),
              f"[serve] {method}: method_fallbacks {got_fb} != the routing "
              f"of resolve_batch_method {dict(fallbacks)}")
        log(f"[serve] {method}: {len(sync)} distinct queries exact against "
            f"the oracle; method_fallbacks {got_fb} as routed; stats "
            f"{srv.stats}")

        # the same queries through the async queue, from several threads
        entries = list(sync.values())
        aq = AsyncAnalyticsServer(srv, idle_timeout=SERVE_IDLE,
                                  max_wait=10 * SERVE_IDLE).start()
        futs = [None] * len(entries)
        deadline = srv.clock() + SERVE_DEADLINE

        def submit(w):
            for j in range(w, len(entries), SERVE_THREADS):
                futs[j] = aq.submit(entries[j][0], deadline=deadline)

        t0 = time.perf_counter()
        flushes0 = dict(srv.stats.flushes)
        threads = [threading.Thread(target=submit, args=(w,))
                   for w in range(SERVE_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=SERVE_DEADLINE)
            check(not t.is_alive(), "[serve] a submitting thread hung")
        # let the serve loop flush what is left (idle, max_wait) before
        # the drain
        t_wait = time.perf_counter()
        while aq.queue_depth and \
                time.perf_counter() - t_wait < 20 * SERVE_IDLE:
            time.sleep(SERVE_IDLE / 10)
        aq.drain()
        aq.close()
        for (q, r), f in zip(entries, futs):
            assert_same(to_tuple(f.result(timeout=SERVE_DEADLINE)),
                        to_tuple(r), f"[serve] async {method} {q.corpus} "
                                     f"{q.kind}")
        check(srv.stats.shed == 0, f"[serve] async shed {srv.stats.shed}")
        reasons = {k: v - flushes0.get(k, 0)
                   for k, v in dict(srv.stats.flushes).items()}
        log(f"[serve] {method} async: {len(entries)} queries from "
            f"{SERVE_THREADS} threads in "
            f"{time.perf_counter() - t0:.1f} s == the sync answers, shed 0; "
            f"flushes by reason {reasons}")
        del srv, aq
    log(f"[serve] phase done in {time.perf_counter() - t_phase:.1f} s")
    return specs


def to_tuple(r):
    """A served answer with its lists made tuples (the oracle's shape)."""
    return tuple(r) if isinstance(r, list) else r


def time_ms(fn, dev) -> float:
    """Median milliseconds of ``fn()`` over TIMING_REPS runs after warm-up
    (CUDA events on the card, the host clock otherwise)."""
    import torch
    cuda = dev.type == "cuda"
    for _ in range(TIMING_WARMUP):
        fn()
    if cuda:
        torch.cuda.synchronize(dev)
    samples = []
    for _ in range(TIMING_REPS):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)


def short_name(kernel: str) -> str:
    """A device activity's name without its namespaces and signature."""
    base = kernel.removeprefix("void ").replace("(anonymous namespace)::", "")
    return base.split("(")[0].split("<")[0].rsplit("::", 1)[-1].strip()


def device_split(fn, dev):
    """``(device_ms, host_us, device_ops)`` of one wrapper call.

    ``device_ms`` is the median over TIMING_REPS calls of the device's own
    time per call: the summed durations of the kernels and memsets the call
    puts on the card, from ``torch.profiler`` (CUPTI, which also sees the
    launches made through ctypes).  ``device_ops`` lists those activities,
    each with its median microseconds.  ``host_us`` is the host's cost per
    call: HOST_CALLS calls back to back on the host clock, with no
    synchronize between them.  On the CPU all three are None: they are
    device metrics.
    """
    import torch
    if dev.type != "cuda":
        return None, None, None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(TIMING_WARMUP):
        fn()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    host_us = (time.perf_counter() - t0) / HOST_CALLS * 1e6
    torch.cuda.synchronize(dev)

    # a trace now and then comes back without the device's activities;
    # such a trace is taken again
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(TIMING_REPS):
                fn()
            torch.cuda.synchronize(dev)
        evs = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)),
                     key=lambda e: e.time_range.start)
        if evs and len(evs) % TIMING_REPS == 0:
            break
        log(f"[kernel] trace of {TIMING_REPS} calls held {len(evs)} device "
            f"activities; tracing again")
    check(bool(evs) and len(evs) % TIMING_REPS == 0,
          f"{len(evs)} device activities traced in {TIMING_REPS} calls, "
          f"{PROFILE_ATTEMPTS} times: none, or no fixed count a call")
    per = len(evs) // TIMING_REPS
    calls = [evs[i: i + per] for i in range(0, len(evs), per)]
    total = statistics.median(sum(e.time_range.elapsed_us() for e in c)
                              for c in calls)
    ops = [{"name": short_name(calls[0][j].name),
            "us": statistics.median(c[j].time_range.elapsed_us()
                                    for c in calls)}
           for j in range(per)]
    return total / 1e3, host_us, ops


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def plan_read_bytes(src, freq, active, row_bytes: int) -> int:
    """Bytes one masked round must read: all of ``freq`` (it tells edges
    from padding), ``src`` for the real edges only, ``active`` once per
    distinct source, and a payload row of ``row_bytes`` once per distinct
    active source."""
    import torch
    n, R = active.shape
    nz = freq != 0
    off = (torch.arange(n, device=src.device) * R)[:, None, None]
    srcs = torch.unique((src.long() + off)[nz])
    act = int((active.reshape(-1)[srcs] > 0).sum())
    return (nbytes(freq) + 4 * int(nz.sum()) + 4 * srcs.numel()
            + row_bytes * act)


def max_abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def fused_args(gb):
    """Kernel 2's inputs for the scalar traversal of pack ``gb``: root
    weights, in-degrees, the ELL plan and its exact round bound."""
    import torch
    src, freq, _, num_levels = gb.ell_plan()
    n, R, _ = src.shape
    w0 = torch.zeros((n, R), dtype=torch.float32, device=src.device)
    w0[:, 0] = 1.0
    return w0, gb.in_deg.to(torch.float32), src, freq, num_levels


def fused_timing(fargs, dev, label: str):
    """Kernel 2 and its plain version on one plan: ``(got, want, ms,
    plain_ms, bound, grid)``.  Also times the kernel cut to one round, so the
    rounds' share of the time shows: phase 0 (the one read of the plan)
    plus one round, against the whole loop."""
    import torch
    from repro_torch.kernels import ops, propagate_fused, ref
    w0, ind, src, freq, max_rounds = fargs
    got = ops.ell_frontier_fused(*fargs, with_rounds=True)
    want = ref.ell_frontier_fused_ref(*fargs)
    ms = time_ms(lambda: ops.ell_frontier_fused(*fargs), dev)
    one_ms = time_ms(lambda: ops.ell_frontier_fused(w0, ind, src, freq, 1),
                     dev)
    plain_ms = time_ms(lambda: ref.ell_frontier_fused_ref(*fargs), dev)
    rounds = int(got[1].max())
    edges = int((freq != 0).sum())
    n, R = w0.shape
    # read once: w0, in_deg, freq and the real edges' src; every edge
    # contributes once over the whole traversal; weights and rounds out
    b = bound(nbytes(w0, ind, freq) + 4 * edges + n * R * 4 + n * 4,
              4 * edges)
    blocks, per_sm, sms = propagate_fused.last_grid
    per_round = ((ms - one_ms) / (rounds - 1)) if rounds > 1 else 0.0
    # rows by live length (last real entry + 1), split as the kernel
    # splits them: one thread up to 4 entries, one warp up to 128
    pos = torch.arange(1, freq.shape[-1] + 1, dtype=torch.int32,
                       device=freq.device)
    live = torch.where(freq != 0, pos, 0).amax(dim=-1)
    tiers = [int((live == 0).sum()), int(((live > 0) & (live <= 4)).sum()),
             int(((live > 4) & (live <= 128)).sum()), int((live > 128).sum())]
    log(f"[kernel] ell_frontier_fused {label} grid: {blocks} blocks "
        f"(co-resident {per_sm} a SM x {sms} SMs); breakdown: phase 0 + "
        f"1 round {one_ms:.5g} ms, all {rounds} rounds {ms:.5g} ms, "
        f"{per_round:.5g} ms a further round; {edges} real edges in "
        f"{freq.numel()} plan entries; rows by live length: {tiers[0]} "
        f"empty, {tiers[1]} of 1-4, {tiers[2]} of 5-128, {tiers[3]} longer "
        f"(max {int(live.max())})")
    return got, want, ms, plain_ms, b, [blocks, per_sm, sms]


def kernel_phase(gb, sub, single, dev):
    """Each kernel at the main path's shapes against its plain version."""
    import torch
    from repro_torch.core import batch as tb
    from repro_torch.core.traversal import device_pack
    from repro_torch.kernels import ops, ref

    out = []
    src, freq, level, num_levels = gb.ell_plan()
    w = tb.batched_top_down_weights(gb, "frontier")
    n, R, K = src.shape

    def record(name, cu, replaces, got, want, fn, plain_ms, b, lib_ms=None,
               ms=None):
        """One kernel's record; ``fn`` calls its ops.py wrapper (timed here
        unless ``ms`` is given)."""
        err = max(max_abs_err(g, p) for g, p in zip(got, want))
        check(all(torch.equal(g, p) for g, p in zip(got, want)),
              f"{name}: kernel differs from its plain version "
              f"(max abs err {err})")
        if ms is None:
            ms = time_ms(fn, dev)
        dev_ms, host_us, dev_ops = device_split(fn, dev)
        out.append({"name": name, "route": "cuda",
                    "source": f"src/repro_torch/kernels/csrc/{cu}",
                    "replaces": replaces, "max_abs_err": err,
                    "ms": ms, "device_ms": dev_ms, "host_us": host_us,
                    "device_ops": dev_ops,
                    "plain_ms": plain_ms, "bound_ms": b[0],
                    "bound_by": b[1], "library_ms": lib_ms})
        log(f"[kernel] {name}: exact; {ms:.5g} ms (device {dev_ms} ms: "
            f"{dev_ops}; host {host_us} us a call; plain {plain_ms:.5g} ms, "
            f"bound {b[0]:.5g} ms by {b[1]}"
            + (f", library {lib_ms:.5g} ms" if lib_ms is not None else "")
            + ")")

    # 1. one frontier round: the level-1 parents active, real weights
    active = (level == 1).to(torch.float32)
    args = (w, active, src, freq)
    got = ops.ell_propagate_batched(*args)
    want = ref.ell_propagate_batched_ref(*args)
    edges = int((freq != 0).sum())
    record("ell_propagate_batched", "propagate_batched.cu",
           "src/repro/kernels/propagate_batched.py:96", got, want,
           lambda: ops.ell_propagate_batched(*args),
           time_ms(lambda: ref.ell_propagate_batched_ref(*args), dev),
           bound(plan_read_bytes(src, freq, active, 4) + 2 * n * R * 4,
                 4 * edges))
    log(f"[kernel] ell_propagate_batched shape: N={n} R={R} K={K}")

    # 2. the whole frontier loop, at the pack and on the single corpus's
    #    N=1 plan
    fargs = fused_args(gb)
    got, want, ms, plain_ms, b, grid = fused_timing(fargs, dev, "pack")
    check(torch.equal(got[0], w), "fused weights differ from frontier")
    record("ell_frontier_fused", "propagate_fused.cu",
           "src/repro/kernels/propagate_fused.py:145", got, want,
           lambda: ops.ell_frontier_fused(*fargs), plain_ms, b, ms=ms)
    log(f"[kernel] ell_frontier_fused: max_rounds={num_levels}, rounds per "
        f"corpus {got[1].tolist()} (max {int(got[1].max())})")
    ga, sw = single
    sargs = fused_args(device_pack(ga, dev))
    sgot, swant, sms, splain_ms, sb, sgrid = fused_timing(sargs, dev,
                                                          "single")
    check(all(torch.equal(g, p) for g, p in zip(sgot, swant)),
          "ell_frontier_fused single: kernel differs from its plain version")
    check(torch.equal(sgot[0][0], sw),
          "ell_frontier_fused single: weights differ from frontier")
    _, sR, sK = sargs[2].shape
    log(f"[kernel] ell_frontier_fused single: exact; {sms:.5g} ms (plain "
        f"{splain_ms:.5g} ms, bound {sb[0]:.5g} ms by {sb[1]}); N=1 R={sR} "
        f"K={sK} max_rounds={sargs[4]}, rounds {int(sgot[1][0])}")
    out[-1].update({
        "grid": grid, "single_grid": sgrid, "single_shape": [1, sR, sK],
        "single_max_abs_err": max(max_abs_err(g, p)
                                  for g, p in zip(sgot, swant)),
        "single_ms": sms, "single_plain_ms": splain_ms,
        "single_bound_ms": sb[0], "single_bound_by": sb[1]})

    # 3. one vector round on the subset pack: level-1 non-root parents,
    #    real per-file weights
    vsrc, vfreq, vlevel, _ = sub.ell_plan()
    W = tb.batched_per_file_weights(sub, "frontier")
    vn, vR, vK = vsrc.shape
    F = W.shape[2]
    nonroot = (torch.arange(vR, device=dev) > 0)[None, :]
    vactive = ((vlevel == 1) & nonroot).to(torch.float32)
    vargs = (W, vactive, vsrc, vfreq)
    got = ops.ell_propagate_vector(*vargs)
    want = ref.ell_propagate_vector_ref(*vargs)
    vedges = int((vfreq != 0).sum())
    record("ell_propagate_vector", "propagate_vector.cu",
           "src/repro/kernels/propagate_vector.py:111", got, want,
           lambda: ops.ell_propagate_vector(*vargs),
           time_ms(lambda: ref.ell_propagate_vector_ref(*vargs), dev),
           bound(plan_read_bytes(vsrc, vfreq, vactive, 4 * F)
                 + vn * vR * (F + 1) * 4, 3 * vedges * F))
    taken = int(((vfreq != 0) & (torch.gather(
        vactive, 1, vsrc.reshape(vn, -1).long()).reshape(vsrc.shape) > 0)
        ).sum())
    log(f"[kernel] ell_propagate_vector subset shape: N={vn} R={vR} K={vK} "
        f"F={F}; {vedges} live plan entries, {taken} of them active")

    # 4. the word-count histogram over the flat-offset batch
    vals = gb.tw_cnt * torch.gather(w, 1, gb.tw_rule)
    nbins = n * gb.V_pad
    valid = (gb.tw_word >= 0) & (gb.tw_word < gb.V_pad)
    offs = (torch.arange(n, device=dev) * gb.V_pad)[:, None]
    ids = torch.where(valid, gb.tw_word + offs, -1).reshape(-1).to(
        torch.int32)
    flat_vals = vals.reshape(-1).contiguous()
    got = ops.weighted_bincount(ids, flat_vals, nbins)
    want = ref.weighted_bincount_ref(ids, flat_vals, nbins)
    keep = ids >= 0
    lib_ids, lib_vals = ids[keep].long(), flat_vals[keep]
    lib = torch.bincount(lib_ids, weights=lib_vals, minlength=nbins)
    check(torch.equal(lib.to(torch.float32), want),
          "torch.bincount yardstick disagrees")
    record("weighted_bincount", "bincount.cu",
           "src/repro/kernels/bincount.py:78", (got,), (want,),
           lambda: ops.weighted_bincount(ids, flat_vals, nbins),
           time_ms(lambda: ref.weighted_bincount_ref(ids, flat_vals, nbins),
                   dev),
           bound(nbytes(ids, flat_vals) + nbins * 4, ids.numel()),
           time_ms(lambda: torch.bincount(lib_ids, weights=lib_vals,
                                          minlength=nbins), dev))
    log(f"[kernel] weighted_bincount shape: n={ids.numel()} nbins={nbins}")

    # the call the engine makes (batched_word_count, backend "kernel")
    def k4b():
        return ops.weighted_bincount_batched(gb.tw_word, vals, gb.V_pad)
    got = k4b()
    for i in range(n):
        check(torch.equal(got[i], ref.weighted_bincount_ref(
            gb.tw_word[i], vals[i], gb.V_pad)),
            f"weighted_bincount_batched row {i} differs from the plain "
            f"version")
    bdev, bhost, bops = device_split(k4b, dev)
    out[-1].update({"batched_ms": time_ms(k4b, dev),
                    "batched_device_ms": bdev, "batched_host_us": bhost,
                    "batched_device_ops": bops,
                    "batched_shape": list(gb.tw_word.shape)})
    log(f"[kernel] weighted_bincount_batched: exact per row; "
        f"{out[-1]['batched_ms']:.5g} ms (device {bdev} ms: {bops}; host "
        f"{bhost} us a call); ids "
        f"{list(gb.tw_word.shape)} {gb.tw_word.dtype}, nbins {gb.V_pad}")

    # 5. the row sums of the single corpus's in-edge plan
    ga, sw = single
    rsrc, rfreq = (torch.as_tensor(a, device=dev)
                   for a in ga.in_edges_ell_dense())
    rargs = (sw, rsrc, rfreq)
    got = ops.ell_row_sums(*rargs)
    want = ref.ell_row_sums_ref(*rargs)
    nz = rfreq != 0
    redges = int(nz.sum())
    rsrcs = int(torch.unique(rsrc[nz]).numel())
    # the library's yardstick: a weighted-sum embedding bag per row
    table = sw[:, None]

    def bag():
        return torch.nn.functional.embedding_bag(
            rsrc, table, per_sample_weights=rfreq, mode="sum")[:, 0]
    check(torch.equal(bag(), want), "embedding_bag yardstick disagrees")
    record("ell_row_sums", "row_sums.cu",
           "src/repro/kernels/propagate.py:84", (got,), (want,),
           lambda: ops.ell_row_sums(*rargs),
           time_ms(lambda: ref.ell_row_sums_ref(*rargs), dev),
           # all of freq, src of the real edges, each gathered weight once,
           # the output once; one multiply-add per real edge
           bound(nbytes(rfreq) + 4 * redges + 4 * rsrcs + 4 * rsrc.shape[0],
                 2 * redges),
           time_ms(bag, dev))
    log(f"[kernel] ell_row_sums shape: rows={rsrc.shape[0]} "
        f"W={rsrc.shape[1]} edges={redges}")
    return out


# ----------------------------------------------------------------------- #
# Checkpoint (phase 5): a mid-ingest snapshot of the single store          #
# ----------------------------------------------------------------------- #
def ckpt_phase(files, vocab: int, cc, want, dev) -> None:
    """Phase 5: the single corpus built from a prefix of its files and
    grown by one append (epoch 1) is snapshot with ``save_corpus`` into a
    temporary directory and restored; every field and the epoch survive,
    an append after the restore equals the same append on the unbroken
    store (and a build of every file), and the restored corpus's analytics
    are exact against the oracle."""
    import torch
    import repro_torch.core as tc
    from repro_torch.checkpoint import restore_corpus, save_corpus
    from repro_torch.data import CompressedCorpus

    t_phase = time.perf_counter()
    cut = max(1, int(len(files) * INGEST_SHARE))
    mid = (cut + len(files)) // 2
    live = CompressedCorpus.build(files[:cut], vocab)
    live.append_files(files[cut:mid])
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        save_corpus(tmp, 1, live)
        size = sum(os.path.getsize(os.path.join(root, f))
                   for root, _, fs in os.walk(tmp) for f in fs)
        restored, step = restore_corpus(tmp)
        io_ms = (time.perf_counter() - t0) * 1e3
    check(step == 1 and restored.epoch == live.epoch == 1,
          f"[ckpt] restored step {step} epoch {restored.epoch}, saved at "
          f"step 1 epoch {live.epoch}")
    assert_corpus_equal(restored, live, "[ckpt] restore")
    check(restored.cached_weight_keys() == (),
          "[ckpt] a restored corpus came back with memos")
    log(f"[ckpt] snapshot of the store after {mid} of {len(files)} files "
        f"(build {cut} + append {mid - cut}, epoch 1): {size} B on disk, "
        f"saved and restored in {io_ms:.1f} ms; every field and the epoch "
        f"round-trip")
    t0 = time.perf_counter()
    restored.append_files(files[mid:])
    live.append_files(files[mid:])
    check(restored.epoch == live.epoch == 2, "[ckpt] epochs after append")
    assert_corpus_equal(restored, live, "[ckpt] append after restore")
    assert_corpus_equal(restored, cc, "[ckpt] append after restore vs build")
    log(f"[ckpt] append of {len(files) - mid} files after the restore == "
        f"the same append on the unbroken store == a build of all files "
        f"({time.perf_counter() - t0:.1f} s, replay included)")
    m = "frontier_fused"
    w = restored.top_down_weights(m, device=dev)
    wf = restored.per_file_weights(m, device=dev)
    ga = restored.ga
    res = {
        "word_count": tc.word_count(ga, m, "kernel", weights=w, device=dev),
        "sort": tc.sort_words(ga, m, "kernel", weights=w, device=dev),
        "term_vector": tc.term_vector(ga, m, file_weights=wf, device=dev),
        "inverted_index": tc.inverted_index(ga, m, file_weights=wf,
                                            device=dev),
        "ranked_inverted_index": tc.ranked_inverted_index(
            ga, m, file_weights=wf, device=dev),
        "sequence_count": tc.sequence_count(ga, SEQ_L, m, weights=w,
                                            device=dev)}
    for kind, r in res.items():
        assert_same(to_host(r), want[kind], f"[ckpt] restored {kind}")
    check(torch.equal(w, cc.top_down_weights(m, device=dev)),
          "[ckpt] restored weights differ from the unbroken store's")
    log(f"[ckpt] the six analytics of the restored corpus ({m}, kernel "
        f"histogram) == the oracle; phase done in "
        f"{time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------------------- #
# Sharding (phase 6): the pack split over a corpus mesh                     #
# ----------------------------------------------------------------------- #
def shard_phase(corpora, oracles, sub_corpora, sub_oracles, gb, specs,
                dev) -> None:
    """Phase 6: the pack's corpora over corpus meshes of SHARD_COUNTS
    shards on the one card (the last shard padded where the count does not
    divide) and, with two or more cards, over every visible card: the six
    analytics under SHARD_METHODS through ``run_batched`` on the sharded
    pack, a search, a filter and a phrase through ``run_sharded``, each
    exact against the raw-file oracle and equal to the unsharded pack's
    answer, with the wall time of each shard count beside the unsharded
    time.  The subset's per-file ELL rounds and the kernel histogram run
    sharded too.  Then one ``AnalyticsServer(mesh=..., shard_min_corpora=2)``
    a mesh serves the 11 kinds to every pack corpus once, exact, with
    ``sharded_calls > 0``."""
    import torch
    from repro_torch.core import ANALYTICS_KINDS, run_batched
    from repro_torch.core.batch import PER_FILE_KINDS
    from repro_torch.distributed import corpus_mesh, run_sharded, shard_batch
    from repro_torch.query.engine import run_batched_query
    from repro_torch.search.engine import batched_search
    from repro_torch.search.scoring import KIND_SCHEME
    from repro_torch.serving import AnalyticsServer, Query

    t_phase = time.perf_counter()
    gas = [ga for _, ga in corpora]
    meshes = [(f"{k} shards on {dev}", corpus_mesh((str(dev),) * k))
              for k in SHARD_COUNTS]
    if dev.type == "cuda" and torch.cuda.device_count() >= 2:
        meshes.append((f"every card ({torch.cuda.device_count()})",
                       corpus_mesh()))
    else:
        log("[shard] one card visible: the mesh over every card is not run")
    qspecs = []
    for kind in ("search_bm25", "filter_count", "phrase_count"):
        qspecs.append(next((k, kw) for k, kw in specs if k == kind))

    def unsharded(kind, kw):
        if kind in KIND_SCHEME:
            return batched_search(gb, kw["terms"], k=kw["k"],
                                  scheme=KIND_SCHEME[kind])
        return run_batched_query(gb, kind, **kw)

    runs = [(kind, m) for kind in ANALYTICS_KINDS for m in SHARD_METHODS]
    base, base_ms = {}, {}
    for kind, m in runs:
        t0 = time.perf_counter()
        base[(kind, m)] = run_batched(gb, kind, m, l=SEQ_L)
        base_ms[(kind, m)] = (time.perf_counter() - t0) * 1e3
    for kind, kw in qspecs:
        base[(kind, None)] = unsharded(kind, kw)
    log(f"[shard] unsharded pack of {gb.n}: {len(runs)} runs in "
        f"{sum(base_ms.values()):.1f} ms (host clock, plans memoized)")

    def exact(res, oracle_of, key, what):
        check(len(res) == len(corpora), f"{what}: {len(res)} results")
        for i, r in enumerate(res):
            assert_same(to_tuple(r), oracle_of(i), f"{what} corpus {i}")
            assert_same(to_tuple(r), to_tuple(base[key][i]),
                        f"{what} corpus {i} vs the unsharded pack")

    for label, mesh in meshes:
        t0 = time.perf_counter()
        sgb = shard_batch(gas, mesh)
        pack_ms = (time.perf_counter() - t0) * 1e3
        # two passes: the first builds the shards' plans, the second runs
        # on them as the unsharded pack's runs above do on its own
        first, times = {}, {}
        for rnd in (first, times):
            for kind, m in runs:
                t0 = time.perf_counter()
                res = run_batched(sgb, kind, m, l=SEQ_L)
                rnd[(kind, m)] = (time.perf_counter() - t0) * 1e3
                exact(res, lambda i: oracles[i][kind], (kind, m),
                      f"[shard] {label} {kind}/{m}")
        q_ms = []
        for kind, kw in qspecs:
            t0 = time.perf_counter()
            res = run_sharded(gas, kind, mesh=mesh, **kw)
            q_ms.append((time.perf_counter() - t0) * 1e3)
            exact(res, lambda i: serve_oracle(kind, kw, corpora[i][0],
                                              oracles[i]),
                  (kind, None), f"[shard] {label} {kind}")
        per_kind = ", ".join(
            f"{kind} {sum(times[(kind, m)] for m in SHARD_METHODS):.1f}/"
            f"{sum(base_ms[(kind, m)] for m in SHARD_METHODS):.1f}"
            for kind in ANALYTICS_KINDS)
        log(f"[shard] {label}: N={sgb.n} ({sgb.real} real, shards of "
            f"{sgb.shard_packs[0].n}) packed in {pack_ms:.1f} ms; "
            f"{len(runs)} runs exact and == unsharded, twice: "
            f"{sum(first.values()):.1f} ms with the shards' plan builds, "
            f"then {sum(times.values()):.1f} ms vs "
            f"{sum(base_ms.values()):.1f} ms unsharded (second pass per "
            f"kind over {len(SHARD_METHODS)} methods, sharded/unsharded "
            f"ms: {per_kind}); run_sharded "
            + ", ".join(f"{k} {t:.1f} ms" for (k, _), t in zip(qspecs, q_ms))
            + " (re-packs a call), exact")
        del sgb

    # the subset: per-file ELL rounds (kernel 3) and the kernel histogram
    mesh = meshes[0][1]
    ssub = shard_batch([ga for _, ga in sub_corpora], mesh)
    n_sub = 0
    for kind in PER_FILE_KINDS:
        for m in ("frontier_ell", "leveled_ell"):
            for i, r in enumerate(run_batched(ssub, kind, m)):
                assert_same(r, sub_oracles[i][kind],
                            f"[shard] subset {kind}/{m} corpus {i}")
            n_sub += 1
    for kind in ("word_count", "sort"):
        for i, r in enumerate(run_batched(ssub, kind, "frontier_fused",
                                          backend="kernel")):
            assert_same(r, sub_oracles[i][kind],
                        f"[shard] subset {kind}/kernel corpus {i}")
        n_sub += 1
    log(f"[shard] subset of {len(sub_corpora)} over {meshes[0][0]}: "
        f"{n_sub} runs (per-file ELL rounds, kernel histogram) exact")

    # the server over each mesh
    for label, mesh in meshes:
        srv = AnalyticsServer(method="frontier_fused", mesh=mesh,
                              shard_min_corpora=2, device=dev)
        for i, (_, ga) in enumerate(corpora):
            srv.register(f"p{i}", ga)
        t_srv, lat = time.perf_counter(), []
        for kind, kw in specs:
            t0 = time.perf_counter()
            res = srv.run([Query(f"p{i}", kind, **kw)
                           for i in range(len(corpora))])
            lat.append(f"{kind} {(time.perf_counter() - t0) * 1e3:.1f}")
            for i, r in enumerate(res):
                assert_same(to_tuple(r), serve_oracle(
                    kind, kw, corpora[i][0], oracles[i]),
                    f"[shard] server {label} p{i} {kind} {kw}")
        check(srv.stats.sharded_calls > 0,
              f"[shard] server {label}: no sharded call")
        log(f"[shard] server {label}: {len(specs)} queries x "
            f"{len(corpora)} corpora exact in "
            f"{(time.perf_counter() - t_srv) * 1e3:.1f} ms (ms a run, in "
            f"order, first calls: {', '.join(lat)}); sharded_calls "
            f"{srv.stats.sharded_calls} of batched_calls "
            f"{srv.stats.batched_calls}")
        mesh.close()
    log(f"[shard] phase done in {time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------------------- #
# Autotune (phase 8): the launch-shape sweeps                              #
# ----------------------------------------------------------------------- #
def autotune_phase(gb, sub, single, records, dev) -> None:
    """Phase 8: every kernel's launch shapes swept at the main path's
    shapes (kernels 1 and 2 at the pack, the subset and the single corpus;
    kernel 3 at the subset; kernel 4 at the pack's flat and batched
    histograms, the subset's and the single corpus's; kernel 5 at the
    single corpus's in-edge plan), each candidate exact against the plain
    version before its time counts, and the ``ell_vs_seg`` route at the
    pack and the subset; the table is written to a temporary file.
    Reloaded, the table gives ``ops`` a ``hit`` at every swept shape and
    the same answers.  Each record gains the tuned shape and device time
    at its main-path shape beside the default's."""
    import torch
    from repro_torch.core import batch as tb
    from repro_torch.core.traversal import device_pack
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import ops, ref
    from repro_torch.obs import global_registry

    t_phase = time.perf_counter()
    ga, sw = single
    spack = device_pack(ga, dev)

    def round_args(pack, w):
        src, freq, level, _ = pack.ell_plan()
        return w, (level == 1).to(torch.float32), src, freq

    def hist_args(pack, w):
        vals = pack.tw_cnt * torch.gather(w, 1, pack.tw_rule)
        return pack.tw_word, vals, pack.V_pad

    w_pack = tb.batched_top_down_weights(gb, "frontier")
    w_sub = tb.batched_top_down_weights(sub, "frontier")
    vsrc, vfreq, vlevel, _ = sub.ell_plan()
    W = tb.batched_per_file_weights(sub, "frontier")
    nonroot = (torch.arange(vsrc.shape[1], device=dev) > 0)[None, :]
    vargs = (W, ((vlevel == 1) & nonroot).to(torch.float32), vsrc, vfreq)
    n, V = gb.n, gb.V_pad
    ids_p, vals_p, _ = hist_args(gb, w_pack)
    offs = (torch.arange(n, device=dev) * V)[:, None]
    flat_ids = torch.where((ids_p >= 0) & (ids_p < V), ids_p + offs,
                           -1).reshape(-1).to(torch.int32)
    flat_vals = vals_p.reshape(-1).contiguous()
    sids, svals, _ = hist_args(spack, sw[None])
    rsrc, rfreq = ga.in_edges_ell_dense()
    rsrc = torch.as_tensor(rsrc, device=dev).to(torch.int32).contiguous()
    rfreq = torch.as_tensor(rfreq, device=dev).to(torch.float32).contiguous()
    sweeps = [
        ("ell_propagate_batched", "pack", at.tune_ell_batched,
         round_args(gb, w_pack), ops.ell_propagate_batched),
        ("ell_propagate_batched", "subset", at.tune_ell_batched,
         round_args(sub, w_sub), ops.ell_propagate_batched),
        ("ell_propagate_batched", "single", at.tune_ell_batched,
         round_args(spack, sw[None]), ops.ell_propagate_batched),
        ("ell_frontier_fused", "pack", at.tune_ell_fused, fused_args(gb),
         ops.ell_frontier_fused),
        ("ell_frontier_fused", "subset", at.tune_ell_fused, fused_args(sub),
         ops.ell_frontier_fused),
        ("ell_frontier_fused", "single", at.tune_ell_fused,
         fused_args(spack), ops.ell_frontier_fused),
        ("ell_propagate_vector", "subset", at.tune_ell_vector, vargs,
         ops.ell_propagate_vector),
        ("weighted_bincount", "pack", at.tune_bincount,
         (flat_ids, flat_vals, n * V), ops.weighted_bincount),
        ("weighted_bincount", "pack batched", at.tune_bincount,
         hist_args(gb, w_pack), ops.weighted_bincount_batched),
        ("weighted_bincount", "subset batched", at.tune_bincount,
         hist_args(sub, w_sub), ops.weighted_bincount_batched),
        ("weighted_bincount", "single", at.tune_bincount,
         (sids[0], svals[0], ga.vocab_size), ops.weighted_bincount),
        ("ell_row_sums", "single", at.tune_row_sums, (sw, rsrc, rfreq),
         ops.ell_row_sums),
    ]
    # the shape each record was timed at in the kernel phase
    main_shape = {"ell_propagate_batched": "pack",
                  "ell_frontier_fused": "pack",
                  "ell_propagate_vector": "subset",
                  "weighted_bincount": "pack", "ell_row_sums": "single"}
    by_name = {r["name"]: r for r in records}
    old_env = os.environ.get(at.CACHE_ENV)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "autotune.json")
        os.environ[at.CACHE_ENV] = path
        at.reset_table()
        try:
            entries = []
            for name, label, tune, args, _ in sweeps:
                t0 = time.perf_counter()
                e = tune(*args)
                entries.append(e)
                table = ", ".join(f"{c} {us / 1e3:.5g}"
                                  for c, us in e["table_us"].items())
                ratio = e["default_us"] / max(e["us"], 1e-9)
                log(f"[autotune] {name} {label}: winner {e['winner']} "
                    f"{e['blocks']} {e['us'] / 1e3:.5g} ms vs default "
                    f"{e['default_us'] / 1e3:.5g} ms ({ratio:.3f}x); "
                    f"device ms a call by candidate: {table}; every "
                    f"candidate exact ({time.perf_counter() - t0:.1f} s)")
                if label == main_shape[name]:
                    by_name[name].update({
                        "tuned_shape": e["blocks"],
                        "tuned_device_ms": e["us"] / 1e3,
                        "default_sweep_device_ms": e["default_us"] / 1e3,
                        "sweep_device_ms": {c: us / 1e3 for c, us
                                            in e["table_us"].items()}})
            routes = {}
            for label, pack in (("pack", gb), ("subset", sub)):
                untuned = tb.resolve_batch_method(pack, "auto")
                e = at.tune_ell_vs_seg(pack)
                routes[label] = e
                log(f"[autotune] ell_vs_seg {label}: "
                    f"{e['winner']} (segment_sum "
                    f"{e['table_us']['segment_sum'] / 1e3:.5g} ms, ELL "
                    f"{e['table_us']['ell'] / 1e3:.5g} ms a frontier "
                    f"traversal, CUDA events); auto resolved to {untuned} "
                    f"without the table")
            at.save_table()

            # reload: ops takes the tuned shapes and routes, same answers
            at.reset_table()
            check(len(at.load_table()) == len(entries) + len(routes),
                  "[autotune] the reloaded table lost entries")
            fam = global_registry().counter(
                "repro_kernel_tuned_table_total", "", ("kind", "result"))
            hits0 = {k: c.value for k, c in
                     ((k, fam.labels(k, "hit")) for k in
                      ("ell_batched", "ell_fused", "ell_vector", "bincount",
                       "row_sums"))}
            plain = {ops.ell_propagate_batched: ref.ell_propagate_batched_ref,
                     ops.ell_frontier_fused: ref.ell_frontier_fused_ref,
                     ops.ell_propagate_vector: ref.ell_propagate_vector_ref,
                     ops.weighted_bincount: ref.weighted_bincount_ref,
                     ops.weighted_bincount_batched:
                     ref.weighted_bincount_ref,
                     ops.ell_row_sums: ref.ell_row_sums_ref}
            for name, label, _, args, op in sweeps:
                kw = ({"with_rounds": True}
                      if op is ops.ell_frontier_fused else {})
                got, want = op(*args, **kw), plain[op](*args)
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                check(all(torch.equal(g, p) for g, p in zip(got, want)),
                      f"[autotune] {name} {label}: the tuned launch "
                      f"differs from the plain version")
            hits = {k: fam.labels(k, "hit").value - v
                    for k, v in hits0.items()}
            check(all(v > 0 for v in hits.values()),
                  f"[autotune] ops missed the tuned table: hits {hits}")
            for label, pack in (("pack", gb), ("subset", sub)):
                m = tb.resolve_batch_method(pack, "auto")
                check((m == "frontier") == routes[label]["use_ref"],
                      f"[autotune] auto at the {label} resolved to {m} "
                      f"against the tuned route {routes[label]['winner']}")
                w = tb.batched_top_down_weights(pack, "auto")
                check(torch.equal(w, tb.batched_top_down_weights(
                    pack, "frontier")),
                      f"[autotune] tuned route changed the {label} weights")
            log(f"[autotune] reloaded table of {len(at.load_table())} "
                f"entries: ops hits {hits}, every tuned launch == its "
                f"plain version; auto follows the tuned routes; phase done "
                f"in {time.perf_counter() - t_phase:.1f} s")
        finally:
            if old_env is None:
                os.environ.pop(at.CACHE_ENV, None)
            else:
                os.environ[at.CACHE_ENV] = old_env
            at.reset_table()


def run(dev, n_corpora=N_CORPORA, n_files=N_FILES,
        tokens_per_file=TOKENS_PER_FILE, vocab=VOCAB,
        single_files=SINGLE_FILES):
    """Phases 2-5 on ``dev``; returns the kernels' JSON records."""
    from repro_torch.core import GrammarBatch
    from repro_torch.kernels import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    corpora = make_corpora(n_corpora, n_files, tokens_per_file, vocab)
    log(f"[data] {n_corpora} corpora x {n_files} files x {tokens_per_file} "
        f"tokens (vocab {vocab}) compressed in "
        f"{time.perf_counter() - t0:.1f} s; rules per corpus "
        f"{[ga.num_rules for _, ga in corpora]}")
    n = fit_scalar_pack(corpora)
    log(f"[data] corpus count used: {n} of {n_corpora}")
    corpora = corpora[:n]
    gb = GrammarBatch.build([ga for _, ga in corpora], device=dev)
    src, freq, level, num_levels = gb.ell_plan()
    log(f"[data] pack: N={gb.n} R_pad={gb.R_pad} E_pad={gb.E_pad} "
        f"K={gb.ell_plan_width()} F_pad={gb.F_pad} V_pad={gb.V_pad} "
        f"levels={num_levels}; pack {pack_bytes(gb)} B, ELL plan "
        f"{nbytes(src, freq, level)} B on {dev}")
    sub_corpora = fit_vector_subset(corpora, vocab)
    sub = GrammarBatch.build([ga for _, ga in sub_corpora], device=dev)
    log(f"[data] per-file subset: N={sub.n} files={len(sub_corpora[0][0])} "
        f"R_pad={sub.R_pad} K={sub.ell_plan_width()} F_pad={sub.F_pad}")
    sfiles = corpus_files("single", single_files, tokens_per_file, vocab,
                          SINGLE_SEED)
    t0 = time.perf_counter()
    oracles = [oracle(files, vocab) for files, _ in corpora]
    sub_oracles = [oracle(files, vocab) for files, _ in sub_corpora]
    log(f"[data] oracle built in {time.perf_counter() - t0:.1f} s")

    # the main path: counts zeroed just before, read just after
    reset_launch_counts()
    t0 = time.perf_counter()
    run_engine(gb, oracles, "pack")
    run_engine(sub, sub_oracles, "subset")
    single, scc, swant = single_phase(sfiles, vocab, dev)
    counts = launch_counts()
    log(f"[engine] main path done in {time.perf_counter() - t0:.1f} s; "
        f"launches {counts}")

    # the serving path: counts zeroed just before, read just after
    sets = {"pack": [(f"p{i}", ga, files, o) for i, ((files, ga), o)
                     in enumerate(zip(corpora, oracles))],
            "subset": [(f"s{i}", ga, files, o) for i, ((files, ga), o)
                       in enumerate(zip(sub_corpora, sub_oracles))],
            "single": [("single", scc, sfiles, swant)]}
    reset_launch_counts()
    specs = serve_phase(sets, vocab, dev)
    serve_counts = launch_counts()
    log(f"[serve] launches {serve_counts}")

    # checkpoint and sharding: counts zeroed just before, read just after
    reset_launch_counts()
    ckpt_phase(sfiles, vocab, scc, swant, dev)
    ckpt_counts = launch_counts()
    log(f"[ckpt] launches {ckpt_counts}")
    reset_launch_counts()
    shard_phase(corpora, oracles, sub_corpora, sub_oracles, gb, specs, dev)
    shard_counts = launch_counts()
    log(f"[shard] launches {shard_counts}")

    records = kernel_phase(gb, sub, single, dev)
    reset_launch_counts()
    if dev.type == "cuda":
        autotune_phase(gb, sub, single, records, dev)
    else:
        log("[autotune] skipped: the sweeps time the kernels on a card")
    tune_counts = launch_counts()
    log(f"[autotune] launches {tune_counts}")
    for r in records:
        r["launches"] = counts.get(r["name"], 0)
        r["serve_launches"] = serve_counts.get(r["name"], 0)
        r["ckpt_launches"] = ckpt_counts.get(r["name"], 0)
        r["shard_launches"] = shard_counts.get(r["name"], 0)
        r["autotune_launches"] = tune_counts.get(r["name"], 0)
    return records


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    src = os.path.join(REPO, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    from repro_torch.kernels import _common

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    dev = _common.resolve_device(None)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(dev)}")
    t0 = time.perf_counter()
    lib = _common.build_library(verbose=True)
    log(f"[build] {lib.name} built in {time.perf_counter() - t0:.1f} s")

    # no tuned table reaches the measured phases: they launch the shipped
    # shapes (the autotune phase writes and reads its own temporary table)
    from repro_torch.kernels import autotune
    with tempfile.TemporaryDirectory() as tmp:
        os.environ[autotune.CACHE_ENV] = os.path.join(tmp, "no_table.json")
        autotune.reset_table()
        records = run(dev)
    for field, path, needed in (
            ("launches", "the main path", None),
            ("serve_launches", "the serving path", SERVE_KERNELS),
            ("ckpt_launches", "the checkpoint phase", CKPT_KERNELS),
            ("shard_launches", "the sharding phase", SHARD_KERNELS),
            ("autotune_launches", "the autotune phase", None)):
        missing = [r["name"] for r in records if r[field] <= 0
                   and (needed is None or r["name"] in needed)]
        if missing:
            print(f"chip_smoke: FAILED: {path} never launched {missing}",
                  file=sys.stderr)
            return 1
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
