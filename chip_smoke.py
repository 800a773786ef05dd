#!/usr/bin/env python3
"""Drive the PyTorch port's analytics engines once on one NVIDIA H100.

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
4. Kernels: each kernel at the main path's shapes against its plain torch
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
    return ga, w


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


def run(dev, n_corpora=N_CORPORA, n_files=N_FILES,
        tokens_per_file=TOKENS_PER_FILE, vocab=VOCAB,
        single_files=SINGLE_FILES):
    """Phases 2-4 on ``dev``; returns the kernels' JSON records."""
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
    single = single_phase(sfiles, vocab, dev)
    counts = launch_counts()
    log(f"[engine] main path done in {time.perf_counter() - t0:.1f} s; "
        f"launches {counts}")

    records = kernel_phase(gb, sub, single, dev)
    for r in records:
        r["launches"] = counts.get(r["name"], 0)
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

    records = run(dev)
    missing = [r["name"] for r in records if r["launches"] <= 0]
    if missing:
        print(f"chip_smoke: FAILED: the main path never launched {missing}",
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
