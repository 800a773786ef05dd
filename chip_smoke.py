#!/usr/bin/env python3
"""Drive the PyTorch port's analytics engines, its analytics server, its
LM serving, training and distribution paths and its dry run once on one
NVIDIA H100.

    python3 chip_smoke.py

run from the root of a checkout, on a machine with one Hopper card and the
CUDA toolkit.  Phases:

1. Set-up: print the card's name and power limit (nvidia-smi), build the
   six CUDA kernels from ``src/repro_torch/kernels/csrc`` and print the
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
   printed.  Kernels 1, 2, 3 and 6 must each launch here (``serve_launches``
   in each record).
5. Checkpoint, with launch counts zeroed just before and read just after:
   the single corpus built from 75% of its files and grown by one append
   (epoch 1) is snapshot with ``save_corpus`` into a temporary directory
   and restored; every field and the epoch survive, an append of the
   remaining files after the restore equals the same append on the
   unbroken store and a build of all files, and the restored corpus's six
   analytics (``frontier_fused``, kernel histogram) are exact against the
   oracle.  Kernels 2, 4 and 6 must launch here.
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
   Kernels 1-4 and 6 must launch here.
7. Kernels: each kernel at the main path's shapes against its plain torch
   version on the same card inputs (exact equality: all values are
   integer-valued float32 below 2^24), timed with CUDA events around one
   wrapper call (``ms``, median of 20 runs after warm-up) beside its bound
   (bytes over 3.35 TB/s or float32 operations over 67 TFLOP/s) and, for
   the histogram, the row sums and the ``delta`` of kernels 1 and 3 (an
   ``embedding_bag`` over the table with the mask folded in), a library
   yardstick the port never calls.  Each record splits that time: ``device_ms`` is the device's own
   time a call (the kernels and memsets the call launches, from
   ``torch.profiler``; ``device_ops`` lists them) and ``host_us`` the
   wrapper's host cost a call (200 calls back to back on the host clock).
   The histogram is also timed in the engine's batched call
   (``batched_*`` fields).  The fused frontier kernel is timed at the pack
   and again on the single corpus's N=1 plan (extra ``single_*`` fields of
   its record), each with the grid of its cooperative launch and a
   breakdown (the kernel cut to one round against the whole loop).  The
   file ranking (kernel 6) ranks the word-major term vectors the engine
   builds for the pack (64 files a word: a warp a word), and again for the
   subset (a group of lanes a word) and the single corpus (256 files:
   extra ``subset_*`` and ``single_*`` fields of its record).
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

9. LM serving (``[lm]``), counts zeroed just before and read just after
   (the LM path has no kernel of its own: attention, the MoE dispatch and
   the SSD scan are plain PyTorch, as they are plain ``jnp`` in the JAX
   package).  ``qwen2-0.5b`` at its published widths and all 24 layers in
   float32 (matmuls without TF32), random weights from a fixed seed drawn
   on the host: ``apply_lm`` logits of a B=2, S=8 prompt on the card
   within 1e-4 * max(1, max|cpu|) of the same weights' on the CPU, and on
   the card ``decode_step`` fed the prompt token by token within 3e-3 *
   max(1, max|full|) of ``apply_lm`` (the JAX package's bound), with the
   greedy tokens equal wherever the two paths' top-2 margin exceeds it.
   The ten archs at their reduced float32 widths pass the same two checks.
   Then ``qwen2-0.5b`` in bf16 at full width serves B=8: prefill ms of 8
   x 16 tokens (``make_prefill_step``, CUDA events), decode ms a step
   (median of 32 on the host clock) and tokens/s, peak memory, parameter
   bytes and one decode step's device time (``torch.profiler``) beside
   its host time; logits finite, tokens valid ids; then the launcher
   ``repro_torch.launch.serve --no-reduced`` the same way a user calls it.
   Last, ``masked_top_k`` (search's ranking and the MoE router's top-k)
   at the search shape and the full-width router shape against
   ``torch.topk``.  Every number is printed beside the card's name and
   power limit.
10. LM training (``[train]``), counts zeroed just before and read just
   after (no kernel on this path either).  (a) ``qwen2-0.5b`` at its
   published widths with two layers in float32 (no TF32), the same
   host-drawn weights on the card and the CPU, B=2, S=64: the loss
   (``remat=True``) within 1e-5 relative, every gradient leaf within
   1e-4 * max(1, max|cpu leaf|), the parameters after one AdamW step
   (lr 1e-2, two microbatches) within 5e-3 (the JAX package's
   microbatch bound); ``topk_compress`` (k 1%) and ``int8_roundtrip`` of
   the CPU's gradients equal on both devices.  (b) The published
   widths and depth in bf16 over a store built here (32 files x 16,384
   tokens, vocab 20,000, seed 17) through ``BatchPipeline`` (B=2, S=4096,
   two microbatches, remat, AdamW lr 1e-3 with warmup 2), 20 steps of
   the driver ``train``: every loss finite, the mean of the last 4 below
   the first.  (d) Its numbers: a step's ms on the host clock (median of
   the steady steps), tokens/s, the model-FLOP share of the bf16 spec
   peak, peak memory (remat on; at S=1024 remat on and off), a step's
   device time and operations (``torch.profiler``) and the device's busy
   share.  (c) Under deterministic algorithms (``CUBLAS_WORKSPACE_CONFIG``
   is set at the top of this script), a run crashed at step 12 by the
   ``FailureInjector`` and resumed from its step-8 checkpoint must give
   losses 8-19 bit-equal to an uncrashed run's.  (e) The launcher
   ``repro_torch.launch.train`` for 4 steps at the same widths.
11. LM distribution (``[dist]``), counts zeroed just before and read just
   after (no kernel on this path).  (a) Each arch's parameter and AdamW
   moment bytes a card under the sharding rules on the 16x16 production
   mesh (shapes only).  (b) The launcher at ``[train]``'s shape for 4
   steps under deterministic algorithms, plain and with ``--mesh 1x1``
   (NCCL, a world of one; it leaves the process group on return): the
   losses bit-equal.  (c) One step of each, plain and on a 1x1 NCCL mesh
   (parameters, moments and batch as DTensors): host-clock ms, device ms
   and operations (``torch.profiler``), the busy share.  (d) GPipe: 4
   stand-in stages on the card of 6 ``qwen2-0.5b`` bf16 layers each, 8
   microbatches of 1 x 1024 tokens, bit-equal to the 24 layers applied in
   order to each microbatch, both timed.  (e) ``qwen2-moe-a2.7b`` at its
   published widths (d_model 2048, 60 experts top-4, expert d_ff 1408,
   shared 5632, vocab 151,936), its 24 layers cut to 2 (the launcher's
   ``--num-layers``), bf16, B=1 x 1024: the launcher for 3 steps plain
   and on a 1x1 NCCL mesh under deterministic algorithms, the losses
   bit-equal (the routed experts through ``local_map``), then a step of
   each, host and device ms, as in (c).
12. Dry run (``[dryrun]``), counts zeroed just before and read just
   after: ``launch/dryrun.run_cell`` of four cells on the 16x16 mesh
   (``qwen2-0.5b``/``train_4k``, ``yi-9b``/``decode_32k``,
   ``whisper-large-v3``/``train_4k``, ``qwen2-moe-a2.7b``/``train_4k``)
   at full width, each on a 256-rank fake process group (meta tensors,
   the host's work only): each status checked ``ok``, per-rank GiB,
   GFLOP, collective MB, the seconds, and the cell's roofline terms at
   the H100 constants.
13. Roofline (``[roofline]``), counts zeroed just before and read just
   after: one bf16 step of ``[train]``'s model and batch under the
   per-rank op counter (``utils/hlo_analysis.py``): FLOPs, bytes, the
   three terms at the H100 constants (``launch/roofline.py``), the
   dominant one, and the bound beside ``[train]``'s measured step.

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
# deterministic cuBLAS for the training phase's restart check; read when
# cuBLAS starts, so set before anything touches the card
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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
                 "ell_propagate_vector", "rank_files")

# the checkpoint phase (phase 5): the kernels its analytics must launch
CKPT_KERNELS = ("ell_frontier_fused", "weighted_bincount", "rank_files")
# the LM serving phase (phase 9): qwen2-0.5b at its published widths
LM_ARCH = "qwen2-0.5b"
LM_SEED = 0
LM_CHECK_B, LM_CHECK_S = 2, 8       # the float32 checks' prompt
LM_REDUCED_S = 10                   # the ten reduced archs' prompt
LM_CARD_TOL = 1e-4                  # card vs CPU: * max(1, max|cpu|)
LM_PARALLEL_TOL = 3e-3              # decode vs parallel: * max(1, max|full|)
LM_SERVE_B, LM_PROMPT, LM_STEPS = 8, 16, 32
LM_PROFILE_STEPS = 5
# masked_top_k: search's [corpora, files] scores, top 10; the full-width
# qwen2-moe-a2.7b router at the served batch, [8, 16, 60 experts], top 4
TOPK_SEARCH_SHAPE, TOPK_SEARCH_K = (16, 64), 10
TOPK_ROUTER_SHAPE, TOPK_ROUTER_K = (8, 16, 60), 4
# the sharding phase (phase 6): shard counts on the one card, methods, and
# the kernels it must launch
SHARD_COUNTS = (2, 3)
SHARD_METHODS = ("frontier", "frontier_ell", "frontier_fused")
SHARD_KERNELS = ("ell_propagate_batched", "ell_frontier_fused",
                 "ell_propagate_vector", "weighted_bincount", "rank_files")
# the autotune phase (phase 8): the kernels with launch shapes to sweep
# (the file ranking has none)
TUNED_KERNELS = ("ell_propagate_batched", "ell_frontier_fused",
                 "ell_propagate_vector", "weighted_bincount", "ell_row_sums")

# the training phase (phase 10): qwen2-0.5b; (a) float32, published
# widths, two layers, card vs CPU; (b) bf16, published widths and depth,
# train_4k's per-chip share twice over; (c) a crash and a resume; (e) the
# launcher
TRAIN_ARCH = "qwen2-0.5b"
TRAIN_CHECK_LAYERS, TRAIN_CHECK_B, TRAIN_CHECK_S = 2, 2, 64
TRAIN_CHECK_LR = 1e-2
TRAIN_LOSS_RTOL = 1e-5              # card vs CPU loss, relative
TRAIN_GRAD_TOL = 1e-4               # card vs CPU gradients: * max(1, max|cpu|)
TRAIN_STEP_TOL = 5e-3               # parameters after a step (the JAX
                                    # package's microbatch bound)
TRAIN_TOPK_FRAC = 0.01
TRAIN_FILES, TRAIN_FILE_TOKENS, TRAIN_VOCAB, TRAIN_SEED = 32, 16384, 20000, 17
TRAIN_B, TRAIN_S, TRAIN_MICROBATCHES = 2, 4096, 2
TRAIN_SHORT_S = 1024                # peak memory with remat on and off
TRAIN_LR, TRAIN_WARMUP = 1e-3, 2
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_CRASH = 20, 8, 12
TRAIN_LOG_EVERY = 5
TRAIN_PROFILE_STEPS = 2
TRAIN_LAUNCH_STEPS = 4
BF16_PEAK = 989.4e12                # H100 SXM, bf16 dense, spec sheet

# the distribution phase (phase 11): the launcher's 1x1 mesh (NCCL) and
# its plain path at [train]'s shape; a step of each on the host clock and
# under the profiler; GPipe over stand-in stages of qwen2-0.5b's layers
DIST_STEPS = 4
DIST_TIMED_STEPS = 3
DIST_PROFILE_STEPS = 2
GPIPE_STAGES, GPIPE_LAYERS = 4, 6          # 4 stages of 6 layers: all 24
GPIPE_M, GPIPE_MB, GPIPE_S = 8, 1, 1024    # 8 microbatches of 1 x 1024
GPIPE_REPS = 3
# (e) a MoE arch at its published widths with its depth cut, through the
# launcher plain and on a 1x1 mesh (NCCL), under deterministic algorithms
DIST_MOE_ARCH, DIST_MOE_LAYERS = "qwen2-moe-a2.7b", 2
DIST_MOE_B, DIST_MOE_S, DIST_MOE_STEPS = 1, 1024, 3

# the dry-run phase (phase 12): full-width cells on a 256-rank fake
# process group each (meta tensors on the host; no device work): the
# dense train step, and attention whose heads ``model`` splits unevenly
# (yi: 32 query heads over 4 kv heads; whisper: 20 heads, self and cross
# attention) or where torch 2.11 cannot flatten a split (qwen2-moe)
DRYRUN_CELLS = (("qwen2-0.5b", "train_4k"), ("yi-9b", "decode_32k"),
                ("whisper-large-v3", "train_4k"),
                ("qwen2-moe-a2.7b", "train_4k"))
DRYRUN_MESH, DRYRUN_RANKS = "single", 256
# then one layer of these cells (arch, shape, mesh) at full width on its
# fake group: the blocks that run one shard a rank, forward and backward,
# each within DRYRUN_SHARE_TOL of the plain block's FLOPs over the ranks
# that share them (the MoE's shared expert and whole layer; mamba's in
# and out projections on the 512-rank mesh, where torch 2.11 and 2.13
# both gave every ``model`` rank their whole weight and input gradients)
DRYRUN_SHARE_CELLS = (("qwen2-moe-a2.7b", "train_4k", "single"),
                      ("mamba2-2.7b", "train_4k", "multi"))
DRYRUN_SHARE_TOL = 0.01

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
    from repro_torch.core.traversal import device_pack, per_file_weights
    from repro_torch.kernels import ops, ref

    out = []
    src, freq, level, num_levels = gb.ell_plan()
    w = tb.batched_top_down_weights(gb, "frontier")
    n, R, K = src.shape

    def record(name, cu, replaces, got, want, fn, plain_ms, b, lib_ms=None,
               ms=None, lib_note=None):
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
        if lib_note:
            out[-1]["library_note"] = lib_note
        log(f"[kernel] {name}: exact; {ms:.5g} ms (device {dev_ms} ms: "
            f"{dev_ops}; host {host_us} us a call; plain {plain_ms:.5g} ms, "
            f"bound {b[0]:.5g} ms by {b[1]}"
            + (f", library {lib_ms:.5g} ms" if lib_ms is not None else "")
            + (f" ({lib_note})" if lib_note else "") + ")")

    def delta_bag(W, active, src, freq):
        """The library's yardstick for a masked round's ``delta``: the
        mask folded into the table (``W * active``, one row a source of
        every corpus) and the plan's sources offset into it, outside the
        timed call; then one ``embedding_bag`` of ``freq``-weighted sums a
        row.  Returns the call and its ``delta`` check."""
        n_, R_, K_ = src.shape
        table = (W * (active if W.dim() == 2 else active[..., None])
                 ).reshape(n_ * R_, -1)
        idx = (src + (torch.arange(n_, device=src.device, dtype=src.dtype)
                      * R_)[:, None, None]).reshape(n_ * R_, K_)
        wts = freq.reshape(n_ * R_, K_)

        def bag():
            return torch.nn.functional.embedding_bag(
                idx, table, per_sample_weights=wts, mode="sum")
        return bag, bag().reshape(W.shape)
    BAG_NOTE = "delta only, one call after folding the mask"

    # 1. one frontier round: the level-1 parents active, real weights
    active = (level == 1).to(torch.float32)
    args = (w, active, src, freq)
    got = ops.ell_propagate_batched(*args)
    want = ref.ell_propagate_batched_ref(*args)
    edges = int((freq != 0).sum())
    bag, bag_delta = delta_bag(*args)
    check(torch.equal(bag_delta, want[0]),
          "ell_propagate_batched: embedding_bag yardstick disagrees")
    del bag_delta
    record("ell_propagate_batched", "propagate_batched.cu",
           "src/repro/kernels/propagate_batched.py:96", got, want,
           lambda: ops.ell_propagate_batched(*args),
           time_ms(lambda: ref.ell_propagate_batched_ref(*args), dev),
           bound(plan_read_bytes(src, freq, active, 4) + 2 * n * R * 4,
                 4 * edges), time_ms(bag, dev), lib_note=BAG_NOTE)
    del bag
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
    vbag, vbag_delta = delta_bag(*vargs)
    check(torch.equal(vbag_delta, want[0]),
          "ell_propagate_vector: embedding_bag yardstick disagrees")
    record("ell_propagate_vector", "propagate_vector.cu",
           "src/repro/kernels/propagate_vector.py:111", got, want,
           lambda: ops.ell_propagate_vector(*vargs),
           time_ms(lambda: ref.ell_propagate_vector_ref(*vargs), dev),
           bound(plan_read_bytes(vsrc, vfreq, vactive, 4 * F)
                 + vn * vR * (F + 1) * 4, 3 * vedges * F),
           time_ms(vbag, dev), lib_note=BAG_NOTE)
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

    # 6. each word's files ranked, on the word-major term vector the
    #    engine builds (batched_ranked_inverted_index)
    def rank_case(pack, Wf):
        tv = tb.word_major_term_vector(pack, Wf)
        nf, vs = pack.num_files, pack.vocab_sizes
        got = [t for pair in ops.rank_files(tv, nf, vs) for t in pair]
        want = [t for pair in ref.rank_files_ref(tv, nf, vs) for t in pair]
        real = sum(int(v) * int(f) for v, f in zip(vs, nf))
        # each real count read once, each id and count written once
        return (list(tv.shape), real, got, want,
                lambda: ops.rank_files(tv, nf, vs),
                time_ms(lambda: ref.rank_files_ref(tv, nf, vs), dev),
                bound(12 * real, 0))
    shape, real, got, want, fn, plain_ms, b = rank_case(
        gb, tb.batched_per_file_weights(gb, "frontier"))
    record("rank_files", "rank_files.cu",
           "src/repro/core/batch.py:997 (jnp.argsort, no Pallas kernel)",
           got, want, fn, plain_ms, b)
    log(f"[kernel] rank_files pack shape: {shape} (N, V_pad, F_pad), "
        f"{real} real entries")
    for label, pack, Wf in (("subset", sub, W),
                            ("single", device_pack(ga, dev),
                             per_file_weights(ga, device=dev)[None])):
        shape, real, got, want, fn, plain_ms, b = rank_case(pack, Wf)
        check(all(torch.equal(g, p) for g, p in zip(got, want)),
              f"rank_files {label}: kernel differs from its plain version")
        ms = time_ms(fn, dev)
        dev_ms, host_us, dev_ops = device_split(fn, dev)
        out[-1].update({f"{label}_shape": shape, f"{label}_ms": ms,
                        f"{label}_device_ms": dev_ms,
                        f"{label}_host_us": host_us,
                        f"{label}_plain_ms": plain_ms,
                        f"{label}_bound_ms": b[0]})
        log(f"[kernel] rank_files {label}: exact; {ms:.5g} ms (device "
            f"{dev_ms} ms: {dev_ops}; host {host_us} us a call; plain "
            f"{plain_ms:.5g} ms, bound {b[0]:.5g} ms by {b[1]}); shape "
            f"{shape}, {real} real entries")
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


# ----------------------------------------------------------------------- #
# LM serving (phase 9): the model zoo, KV-cache decode, the serve launcher #
# ----------------------------------------------------------------------- #
def lm_scaled_err(got, want) -> float:
    """max |got - want| / max(1, max |want|)."""
    return max_abs_err(got, want) / max(1.0, float(want.abs().max()))


def lm_check(cfg, dev, label: str, B: int, S: int) -> None:
    """Card logits against the CPU's (same weights) within
    LM_CARD_TOL * max(1, max|cpu|); on the card, ``decode_step`` fed the
    prompt token by token against ``apply_lm`` within
    LM_PARALLEL_TOL * max(1, max|full|), and the greedy tokens equal
    wherever the two paths' top-2 margin exceeds that bound."""
    import torch
    from repro_torch import models as tm
    from repro_torch.serving import make_prefill_step
    t0 = time.perf_counter()
    # the same random weights, drawn on the host, on the CPU and the card
    cpu = tm.init_lm(cfg, torch.Generator().manual_seed(LM_SEED),
                     device="cpu")
    card = tm.lm_from_params(cfg, tm.lm_to_params(cpu), device=dev)
    rng = np.random.default_rng(LM_SEED)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    extra = None
    if cfg.family == "encdec":
        extra = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model))
    elif cfg.family == "vlm":
        extra = rng.normal(size=(B, cfg.num_patches, cfg.d_model))
    extra = None if extra is None else extra.astype(np.float32)
    prefill = make_prefill_step(cfg)
    want = prefill(cpu, toks, extra_embeds=extra)
    full = prefill(card, toks, extra_embeds=extra)
    del cpu
    check(bool(torch.isfinite(full).all()), f"[lm] {label}: logits not "
          f"finite")
    card_err = lm_scaled_err(full.cpu(), want)
    check(card_err <= LM_CARD_TOL, f"[lm] {label}: card logits differ from "
          f"the CPU's by {card_err:.3g} of scale (bound {LM_CARD_TOL})")
    cache = tm.init_cache(cfg, B, S, device=dev)
    outs = []
    with torch.no_grad():
        if cfg.family == "encdec":
            cache = tm.prefill_cross(cfg, card, cache, extra)
        for t in range(S):
            lg, cache = tm.decode_step(cfg, card, cache, toks[:, t:t + 1])
            outs.append(lg)
    dec = torch.cat(outs, dim=1)
    # pixtral's parallel path puts its patches in front; decode has none
    full_text = prefill(card, toks) if cfg.family == "vlm" else full
    dec_err = lm_scaled_err(dec, full_text)
    check(dec_err <= LM_PARALLEL_TOL, f"[lm] {label}: decode differs from "
          f"parallel by {dec_err:.3g} of scale (bound {LM_PARALLEL_TOL})")
    bound_abs = LM_PARALLEL_TOL * max(1.0, float(full_text.abs().max()))
    flips = []
    for logits in (full_text, dec):
        top2 = torch.topk(logits, 2, dim=-1).values
        flips.append(top2[..., 0] - top2[..., 1])
    margin = torch.minimum(*flips)
    differ = full_text.argmax(-1) != dec.argmax(-1)
    for b, s in differ.nonzero().tolist():
        m = float(margin[b, s])
        log(f"[lm] {label}: greedy token differs at (batch {b}, position "
            f"{s}), top-2 margin {m:.4g} (bound {bound_abs:.4g})")
        check(m < bound_abs, f"[lm] {label}: greedy token flips at ({b}, "
              f"{s}) with a top-2 margin {m:.4g} above the bound")
    log(f"[lm] {label}: card vs CPU {card_err:.3g} of scale (bound "
        f"{LM_CARD_TOL}), decode vs parallel {dec_err:.3g} (bound "
        f"{LM_PARALLEL_TOL}), {int(differ.sum())} greedy flips below the "
        f"margin, B={B} S={S}, {time.perf_counter() - t0:.1f} s")


def device_mean(fn, dev, calls: int):
    """``(device ms, device ops)`` a call of ``fn``: the summed durations
    of every activity ``calls`` calls put on the card
    (``torch.profiler``), divided by ``calls``.  Unlike
    :func:`device_split` it needs no fixed activity count a call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    # a trace now and then comes back without the device's activities;
    # such a trace is taken again, as in device_split
    for _ in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize(dev)
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
        if evs:
            break
        log(f"trace of {calls} calls held no device activity; tracing "
            f"again")
    check(bool(evs), f"the profiler traced no device activity in "
          f"{PROFILE_ATTEMPTS} traces")
    total_us = sum(e.time_range.elapsed_us() for e in evs)
    return total_us / calls / 1e3, len(evs) / calls


def topk_records(dev, smi: str):
    """``masked_top_k`` (plain torch, a stable sort) at the search shape
    and the full-width MoE router shape, against ``torch.topk``."""
    import torch
    from repro_torch.kernels import ops
    out = []
    for label, shape, k in (("search", TOPK_SEARCH_SHAPE, TOPK_SEARCH_K),
                            ("router", TOPK_ROUTER_SHAPE, TOPK_ROUTER_K)):
        g = torch.Generator(device=dev).manual_seed(LM_SEED)
        scores = torch.rand(shape, generator=g, device=dev)
        valid = torch.rand(shape, generator=g, device=dev) < 0.9
        vals, idx = ops.masked_top_k(scores, valid, k)
        ref = torch.topk(torch.where(valid, scores, float("-inf")), k,
                         dim=-1)
        check(torch.equal(vals, ref.values), f"[lm] masked_top_k {label}: "
              f"values differ from torch.topk")
        ms = time_ms(lambda: ops.masked_top_k(scores, valid, k), dev)
        def library():
            return torch.topk(torch.where(valid, scores, float("-inf")), k,
                              dim=-1)
        lib_ms = time_ms(library, dev)
        lib_device_ms, _ = device_mean(library, dev, TIMING_REPS)
        device_ms, dev_ops = device_mean(
            lambda: ops.masked_top_k(scores, valid, k), dev, TIMING_REPS)
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            ops.masked_top_k(scores, valid, k)
        host_us = (time.perf_counter() - t0) / HOST_CALLS * 1e6
        torch.cuda.synchronize(dev)
        rows = scores.numel() // shape[-1]
        b = bound(nbytes(scores, valid) + rows * k * 8, 0)
        rec = {"name": f"masked_top_k ({label})", "shape": list(shape),
               "k": k, "ms": ms, "device_ms": device_ms, "host_us": host_us,
               "device_ops_a_call": dev_ops, "bound_ms": b[0],
               "bound_by": b[1], "library_ms": lib_ms,
               "library_device_ms": lib_device_ms}
        log(f"[lm] masked_top_k {label} {list(shape)} k={k}: {ms:.5g} ms, "
            f"device {device_ms:.5g} ms ({dev_ops:g} device ops a call), "
            f"host {host_us:.4g} us, bound {b[0]:.5g} ms ({b[1]}); "
            f"torch.topk {lib_ms:.5g} ms, device {lib_device_ms:.5g} ms "
            f"({smi})")
        out.append(rec)
    return out


def lm_phase(dev, smi: str, cut=None):
    """Phase 9; returns ``masked_top_k``'s records.  ``cut``: config
    overrides for a CPU rehearsal (depth and vocabulary), which skips the
    launcher and the timings of ``masked_top_k``; the card runs the
    published widths and depth."""
    import dataclasses
    import torch
    from repro_torch import models as tm
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch import serve
    from repro_torch.serving import make_prefill_step, make_serve_step
    t_phase = time.perf_counter()
    # float32 checks need full-precision matmuls (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cut = cut or {}

    # full-width qwen2-0.5b in float32: card == CPU, decode == parallel
    cfg32 = dataclasses.replace(get_config(LM_ARCH), dtype="float32", **cut)
    lm_check(cfg32, dev, f"{LM_ARCH} float32 ({cfg32.num_layers} layers, "
             f"vocab {cfg32.vocab_size})", LM_CHECK_B, LM_CHECK_S)
    # every family at its reduced widths
    for arch in ARCH_IDS:
        over = {}
        if get_config(arch).moe_num_experts:
            over["moe_capacity_factor"] = 4.0     # no drops: decode == par.
        lm_check(tm.reduced(get_config(arch), dtype="float32", **over), dev,
                 f"{arch} reduced", LM_CHECK_B, LM_REDUCED_S)

    # served numbers: bf16 at the published widths
    cfg = dataclasses.replace(get_config(LM_ARCH), **cut)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)    # by the earlier phases
    model = tm.init_lm(cfg, torch.Generator().manual_seed(LM_SEED),
                       device=dev)
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    rng = np.random.default_rng(LM_SEED)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LM_SERVE_B, LM_PROMPT)).astype(np.int32)).to(dev)
    prefill = make_prefill_step(cfg)
    logits = prefill(model, prompts)
    check(bool(torch.isfinite(logits).all()), "[lm] bf16 prefill logits "
          "not finite")
    prefill_ms = time_ms(lambda: prefill(model, prompts), dev)
    cache = tm.init_cache(cfg, LM_SERVE_B, LM_PROMPT + LM_STEPS +
                          LM_PROFILE_STEPS, device=dev)
    step = make_serve_step(cfg)
    for t in range(LM_PROMPT):
        tok, cache, logits = step(model, cache, prompts[:, t:t + 1])
    step_ms, gen = [], []
    for _ in range(LM_STEPS):
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        tok, cache, logits = step(model, cache, tok)
        if cuda:
            torch.cuda.synchronize(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        check(bool(torch.isfinite(logits).all()), "[lm] bf16 decode logits "
              "not finite")
        gen.append(tok)
    gen = torch.cat(gen, dim=1)
    check(bool(((gen >= 0) & (gen < cfg.vocab_size)).all()),
          "[lm] bf16 greedy tokens are not valid ids")
    decode_ms = statistics.median(step_ms)
    log(f"[lm] {LM_ARCH} bf16 served, B={LM_SERVE_B}, prompt {LM_PROMPT}, "
        f"{LM_STEPS} steps, {cfg.num_layers} layers, vocab "
        f"{cfg.vocab_size} ({smi}):")
    log(f"[lm]   prefill {prefill_ms:.5g} ms (B={LM_SERVE_B} x {LM_PROMPT}, "
        f"median of {TIMING_REPS}) ({smi})")
    log(f"[lm]   decode {decode_ms:.5g} ms a step (median of {LM_STEPS}, "
        f"host clock), {LM_SERVE_B / decode_ms * 1e3:.6g} tokens/s ({smi})")
    log(f"[lm]   parameters {param_bytes} B ({smi})")
    if cuda:
        state = [tok, cache]

        def one_step():
            state[0], state[1], _ = step(model, state[1], state[0])
        dev_ms, ops_a_step = device_mean(one_step, dev, LM_PROFILE_STEPS)
        peak = torch.cuda.max_memory_allocated(dev)
        log(f"[lm]   peak memory {peak - held} B above the {held} B the "
            f"earlier phases hold (torch.cuda.max_memory_allocated) ({smi})")
        log(f"[lm]   decode step device_ms {dev_ms:.5g} (torch.profiler, "
            f"mean of {LM_PROFILE_STEPS}, {ops_a_step:g} device ops a step) "
            f"against {decode_ms:.5g} ms on the host clock: the card is "
            f"busy {dev_ms / decode_ms:.1%} of the step ({smi})")
    del model, cache

    records = []
    if cuda:
        # the launcher a user calls, at the same widths
        served = serve.main(["--arch", LM_ARCH, "--no-reduced", "--batch",
                             str(LM_SERVE_B), "--prompt-len", str(LM_PROMPT),
                             "--steps", str(LM_STEPS), "--device", str(dev)])
        check(all(0 <= i < cfg.vocab_size for i in served["ids"]),
              "[lm] the launcher served invalid ids")
        log(f"[lm]   launcher: {served['tok_s']:.6g} tok/s ({smi})")
        records = topk_records(dev, smi)
    log(f"[lm] phase done in {time.perf_counter() - t_phase:.1f} s")
    return records


# ----------------------------------------------------------------------- #
# LM training (phase 10): AdamW, remat, microbatches, the driver, resume   #
# ----------------------------------------------------------------------- #
def _tree_to(tree, dev):
    """A copy of a nested dict / list tree of tensors on ``dev``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)


def train_check(cfg, dev, B: int, S: int) -> None:
    """(a): float32 training on the card against the CPU, the same
    host-drawn weights: the loss (``remat=True``) within TRAIN_LOSS_RTOL,
    every gradient leaf within TRAIN_GRAD_TOL * max(1, max|cpu leaf|),
    the parameters after one AdamW step (two microbatches) within
    TRAIN_STEP_TOL; then ``topk_compress`` and ``int8_roundtrip`` of the
    CPU's gradients on both devices, which must be equal."""
    import torch
    from repro_torch import models as tm
    from repro_torch import training as tt
    from repro_torch.checkpoint import flatten_with_paths
    t0 = time.perf_counter()
    cpu = tm.init_lm(cfg, torch.Generator().manual_seed(LM_SEED),
                     device="cpu")
    card = tm.lm_from_params(cfg, tm.lm_to_params(cpu), device=dev)
    rng = np.random.default_rng(LM_SEED)
    batch = {k: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32))
        for k in ("tokens", "labels")}
    loss_fn = tt.make_loss_fn(cfg, remat=True)
    losses, grads = [], []
    for model in (cpu, card):
        model.requires_grad_(True)
        loss, _ = loss_fn(model, _tree_to(batch, model.device))
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append(tm.lm_grads(model))
        model.zero_grad(set_to_none=True)
    loss_err = abs(losses[1] - losses[0]) / abs(losses[0])
    check(loss_err <= TRAIN_LOSS_RTOL, f"[train] card loss {losses[1]} vs "
          f"CPU {losses[0]}: {loss_err:.3g} relative (bound "
          f"{TRAIN_LOSS_RTOL})")
    want = flatten_with_paths(grads[0])
    got = dict(flatten_with_paths(grads[1]))
    grad_err = max(lm_scaled_err(got[k].cpu(), v) for k, v in want)
    check(grad_err <= TRAIN_GRAD_TOL, f"[train] card gradients differ from "
          f"the CPU's by {grad_err:.3g} of scale (bound {TRAIN_GRAD_TOL})")

    opt = tt.AdamW(lr=TRAIN_CHECK_LR)
    stepped = []
    for model in (cpu, card):
        step = tt.make_train_step(cfg, opt, remat=True,
                                  microbatches=TRAIN_MICROBATCHES)
        model, _, met = step(model, opt.init(tm.lm_to_params(model)),
                             _tree_to(batch, model.device))
        check(bool(np.isfinite(float(met["loss"]))), "[train] float32 step "
              "loss not finite")
        stepped.append(flatten_with_paths(tm.lm_to_params(model)))
    step_err = max(max_abs_err(g.cpu(), w) for (_, g), (_, w)
                   in zip(stepped[1], stepped[0]))
    check(step_err <= TRAIN_STEP_TOL, f"[train] card parameters after one "
          f"AdamW step differ from the CPU's by {step_err:.3g} (bound "
          f"{TRAIN_STEP_TOL})")
    del cpu, card, stepped

    g_card = _tree_to(grads[0], dev)
    for name, fn in (("topk_compress", lambda g: tt.topk_compress(
            g, tt.init_error(g), TRAIN_TOPK_FRAC)),
            ("int8_roundtrip", tt.int8_roundtrip)):
        want = flatten_with_paths(fn(grads[0]))
        got = flatten_with_paths(fn(g_card))
        for (k, w), (_, g) in zip(want, got):
            check(torch.equal(g.cpu(), w), f"[train] {name} on the card "
                  f"differs from the CPU's at {k}")
    log(f"[train] {cfg.name} float32 ({cfg.num_layers} layers, vocab "
        f"{cfg.vocab_size}, B={B} S={S}, remat, {TRAIN_MICROBATCHES} "
        f"microbatches): card vs CPU loss {loss_err:.3g} relative (bound "
        f"{TRAIN_LOSS_RTOL}), gradients {grad_err:.3g} of scale (bound "
        f"{TRAIN_GRAD_TOL}), parameters after one AdamW step "
        f"{step_err:.3g} (bound {TRAIN_STEP_TOL}); topk_compress (k "
        f"{TRAIN_TOPK_FRAC:.0%}) and int8_roundtrip equal on both; "
        f"{time.perf_counter() - t0:.1f} s")


def train_phase(dev, smi: str, cut=None, seq_len=TRAIN_S,
                files=TRAIN_FILES, tokens_per_file=TRAIN_FILE_TOKENS,
                short_seq=TRAIN_SHORT_S):
    """Phase 10.  ``cut``, ``seq_len``, ``files``, ``tokens_per_file``,
    ``short_seq``: a CPU rehearsal's smaller sizes (it skips the device
    measurements and the launcher); the card runs the published widths
    and depth at the defaults.  Returns the store it trained on and the
    step's host-clock ms (None on the CPU)."""
    import dataclasses
    import torch
    from repro_torch import models as tm
    from repro_torch import training as tt
    from repro_torch.configs import get_config
    from repro_torch.data import BatchPipeline, CompressedCorpus
    from repro_torch.launch import train as launcher
    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    # the float32 check needs full-precision matmuls (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cut = cut or {}

    # (a) float32, published widths, two layers: card == CPU
    train_check(dataclasses.replace(get_config(TRAIN_ARCH), dtype="float32",
                                    num_layers=TRAIN_CHECK_LAYERS,
                                    **{k: v for k, v in cut.items()
                                       if k != "num_layers"}),
                dev, TRAIN_CHECK_B, TRAIN_CHECK_S)

    # (b) bf16 at the published widths and depth over a compressed store
    t0 = time.perf_counter()
    cc = CompressedCorpus.build(
        corpus_files("train", files, tokens_per_file, TRAIN_VOCAB,
                     TRAIN_SEED), vocab_size=TRAIN_VOCAB)
    log(f"[train] store: {files} files x {tokens_per_file} tokens (vocab "
        f"{TRAIN_VOCAB}, seed {TRAIN_SEED}) built in "
        f"{time.perf_counter() - t0:.1f} s: {cc.stats()}")
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), **cut)
    if cuda:
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated(dev)
    model = tm.init_lm(cfg, torch.Generator().manual_seed(LM_SEED),
                       device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    with torch.no_grad():
        init = [p.detach().clone() for p in model.parameters()]

    def fresh():
        with torch.no_grad():
            for p, p0 in zip(model.parameters(), init):
                p.copy_(p0)
        return model

    opt = tt.AdamW(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP)
    step_fn = tt.make_train_step(cfg, opt, remat=True,
                                 microbatches=TRAIN_MICROBATCHES)
    pipe = BatchPipeline(cc, global_batch=TRAIN_B, seq_len=seq_len,
                         prefetch=2)
    times = []

    class StepTimes(tt.StragglerWatchdog):
        """The driver's watchdog, keeping every step's seconds."""
        def observe(self, step, dt):
            times.append(dt)
            return super().observe(step, dt)

    watchdog = StepTimes(on_straggler=lambda s, dt, ema: log(
        f"[train] straggler at step {s}: {dt * 1e3:.1f} ms against an EMA "
        f"of {ema * 1e3:.1f} ms"))

    def run(**kw):
        return tt.train(cfg, fresh(), opt, pipe, steps=TRAIN_STEPS,
                        ckpt_every=TRAIN_CKPT_EVERY, train_step=step_fn,
                        log_every=TRAIN_LOG_EVERY, log=log, **kw)["history"]

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    hist = run(watchdog=watchdog)
    run_s = time.perf_counter() - t0
    check(all(np.isfinite(hist)), f"[train] a loss is not finite: {hist}")
    tail = float(np.mean(hist[-4:]))
    check(tail < hist[0], f"[train] the loss did not fall: first "
          f"{hist[0]:.4f}, mean of the last 4 {tail:.4f}")
    tokens = TRAIN_B * seq_len
    step_ms = statistics.median(times[TRAIN_WARMUP:]) * 1e3
    log(f"[train] {cfg.name} {cfg.dtype} ({cfg.num_layers} layers, "
        f"{n_params} parameters), B={TRAIN_B} S={seq_len}, remat, "
        f"{TRAIN_MICROBATCHES} microbatches, AdamW lr {TRAIN_LR} warmup "
        f"{TRAIN_WARMUP}: {TRAIN_STEPS} steps in {run_s:.1f} s, loss "
        f"{hist[0]:.4f} -> {hist[-1]:.4f} (mean of the last 4 {tail:.4f}), "
        f"{watchdog.events} stragglers ({smi})")
    log(f"[train]   losses {hist}")
    if cuda:
        peak = torch.cuda.max_memory_allocated(dev)
        flop = 6 * n_params * tokens
        log(f"[train]   step {step_ms:.5g} ms (host clock, median of steps "
            f"{TRAIN_WARMUP}-{TRAIN_STEPS - 1}), {tokens / step_ms * 1e3:.6g} "
            f"tokens/s, model FLOP share {flop / (step_ms / 1e3) / BF16_PEAK:.2%}"
            f" (6 x {n_params} parameters x {tokens} tokens a step over "
            f"{BF16_PEAK / 1e12:g} TFLOP/s, the H100 SXM bf16 dense spec "
            f"figure) ({smi})")
        log(f"[train]   peak memory {peak - held} B above the {held} B the "
            f"earlier phases hold, remat on, S={seq_len} "
            f"(torch.cuda.max_memory_allocated) ({smi})")

    # (d) peak memory at a shorter sequence, remat on and off; a step's
    # device time (torch.profiler) against its host time
    x, y = pipe.batch_at(0)
    for remat in (True, False):
        fn = tt.make_train_step(cfg, opt, remat=remat,
                                microbatches=TRAIN_MICROBATCHES)
        short = {"tokens": torch.from_numpy(x[:, :short_seq]).to(dev),
                 "labels": torch.from_numpy(y[:, :short_seq]).to(dev)}
        state = opt.init(tm.lm_to_params(fresh()))
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        _, state, met = fn(model, state, short)
        check(bool(np.isfinite(float(met["loss"]))), f"[train] loss at "
              f"S={short_seq}, remat {remat}, not finite")
        if cuda:
            log(f"[train]   peak memory {torch.cuda.max_memory_allocated(dev) - held}"
                f" B above the earlier phases', S={short_seq}, remat "
                f"{'on' if remat else 'off'} ({smi})")
        del state
    if cuda:
        state = [opt.init(tm.lm_to_params(fresh()))]
        full = {"tokens": torch.from_numpy(x).to(dev),
                "labels": torch.from_numpy(y).to(dev)}

        def one_step():
            _, state[0], met = step_fn(model, state[0], full)
            float(met["loss"])
        one_step()
        dev_ms, ops_a_step = device_mean(one_step, dev, TRAIN_PROFILE_STEPS)
        log(f"[train]   step device_ms {dev_ms:.5g} (torch.profiler, mean "
            f"of {TRAIN_PROFILE_STEPS}, {ops_a_step:g} device ops a step) "
            f"against {step_ms:.5g} ms on the host clock: the card is busy "
            f"{dev_ms / step_ms:.1%} of the step ({smi})")
        del state

    # (c) restart exactness: a crash at TRAIN_CRASH and a resume from the
    # step-TRAIN_CKPT_EVERY checkpoint against the run without the crash,
    # deterministic algorithms on (the embedding's backward accumulates
    # with atomics otherwise)
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            ref = run()
            try:
                run(ckpt_dir=tmp, injector=tt.FailureInjector(TRAIN_CRASH))
            except RuntimeError as e:
                check(f"injected failure at step {TRAIN_CRASH}" in str(e),
                      f"[train] the crashed run failed otherwise: {e}")
            else:
                check(False, "[train] the injected failure did not fire")
            ck = os.path.join(tmp, f"step_{TRAIN_CKPT_EVERY:09d}")
            ck_bytes = sum(os.path.getsize(os.path.join(ck, f))
                           for f in os.listdir(ck))
            # every TRAIN_STEPS + 1 steps: the resumed run writes nothing
            resumed = tt.train(cfg, fresh(), opt, pipe, steps=TRAIN_STEPS,
                               ckpt_dir=tmp, ckpt_every=TRAIN_STEPS + 1,
                               train_step=step_fn,
                               log_every=TRAIN_LOG_EVERY, log=log)["history"]
            det_s = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    check(len(resumed) == TRAIN_STEPS - TRAIN_CKPT_EVERY,
          f"[train] the resumed run took {len(resumed)} steps")
    diff = max(abs(a - b) for a, b in zip(resumed, ref[TRAIN_CKPT_EVERY:]))
    check(resumed == ref[TRAIN_CKPT_EVERY:], f"[train] losses after the "
          f"resume differ from the run without the crash by up to {diff:.3g}:"
          f" {resumed} vs {ref[TRAIN_CKPT_EVERY:]}")
    log(f"[train] restart: crash at step {TRAIN_CRASH}, resume from the "
        f"step-{TRAIN_CKPT_EVERY} checkpoint ({ck_bytes} B on disk): losses "
        f"{TRAIN_CKPT_EVERY}-{TRAIN_STEPS - 1} bit-equal to the run without "
        f"the crash (deterministic algorithms; three runs in {det_s:.1f} s)")
    pipe.close()
    del model, init, step_fn
    if cuda:
        torch.cuda.empty_cache()

        # (e) the launcher a user calls, at the same widths
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "train_store.npz")
            cc.save(path)
            t0 = time.perf_counter()
            out = launcher.main([
                "--arch", TRAIN_ARCH, "--corpus", path, "--steps",
                str(TRAIN_LAUNCH_STEPS), "--global-batch", str(TRAIN_B),
                "--seq-len", str(seq_len), "--microbatches",
                str(TRAIN_MICROBATCHES), "--device", str(dev)])
        check(len(out["history"]) == TRAIN_LAUNCH_STEPS
              and all(np.isfinite(out["history"])),
              f"[train] the launcher's losses: {out['history']}")
        log(f"[train]   launcher: {TRAIN_LAUNCH_STEPS} steps in "
            f"{time.perf_counter() - t0:.1f} s with its set-up, losses "
            f"{out['history']} ({smi})")
        del out
        torch.cuda.empty_cache()
    log(f"[train] phase done in {time.perf_counter() - t_phase:.1f} s")
    return cc, (step_ms if cuda else None)


# ----------------------------------------------------------------------- #
# LM distribution (phase 11): rules, the launcher's mesh, GPipe            #
# ----------------------------------------------------------------------- #
def rules_bytes(smi: str) -> None:
    """(a) Each arch's parameter and AdamW-moment bytes a card under the
    sharding rules on the 16x16 production mesh (shapes only: ``meta``
    tensors and the rules' shard shapes)."""
    import math
    from repro_torch import models as tm
    from repro_torch.checkpoint import flatten_with_paths
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.distributed import default_rules, param_shardings
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh()
    rules = default_rules(mesh)
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        params, axes = tm.lm_skeleton(cfg)
        sh = dict(flatten_with_paths(param_shardings(axes, params, mesh,
                                                     rules)))
        full = local = moments = 0
        for k, t in flatten_with_paths(params):
            n = math.prod(sh[k].shard_shape(tuple(t.shape)))
            full += t.numel() * t.element_size()
            local += n * t.element_size()
            moments += 2 * 4 * n                  # mu and nu, float32
        log(f"[dist] {arch} ({cfg.dtype}) on a "
            f"{'x'.join(map(str, mesh.shape.values()))} mesh: parameters "
            f"{local} B a card of {full} B ({full / max(local, 1):.1f}x "
            f"less), AdamW moments {moments} B a card, together "
            f"{(local + moments) / 1e9:.3f} GB a card (rules, shapes only)")


def mesh_step_numbers(cfg, dev, smi: str, batch,
                      microbatches=TRAIN_MICROBATCHES) -> None:
    """(c) One bf16 step of the plain path and of the same weights placed
    on a 1x1 NCCL mesh, from one process group: host-clock ms (median of
    DIST_TIMED_STEPS after a warm step), device ms and ops a step
    (``torch.profiler``), the busy share."""
    import socket
    import torch
    import torch.distributed as dist
    from repro_torch import models as tm
    from repro_torch import training as tt
    from repro_torch.distributed import default_rules, distribute_lm
    from repro_torch.launch.mesh import make_host_mesh
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0, device_id=dev)
    try:
        mesh = make_host_mesh(1, 1, device_type="cuda")
        opt = tt.AdamW(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP)
        step_fn = tt.make_train_step(cfg, opt, remat=True,
                                     microbatches=microbatches)
        for label in ("plain", "mesh 1x1"):
            model = tm.init_lm(cfg, torch.Generator().manual_seed(LM_SEED),
                               device=dev)
            if label != "plain":
                distribute_lm(model, mesh, default_rules(mesh))
            state = [opt.init(tm.lm_to_params(model))]
            b = batch if label == "plain" else {
                k: _replicated(v, mesh) for k, v in batch.items()}

            def one_step():
                _, state[0], met = step_fn(model, state[0], b)
                return float(met["loss"])
            one_step()
            times = []
            for _ in range(DIST_TIMED_STEPS):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                one_step()
                times.append(time.perf_counter() - t0)
            step_ms = statistics.median(times) * 1e3
            dev_ms, ops = device_mean(one_step, dev, DIST_PROFILE_STEPS)
            log(f"[dist]   {cfg.name} {label}: step {step_ms:.5g} ms "
                f"(host clock, median of {DIST_TIMED_STEPS}), device_ms "
                f"{dev_ms:.5g} "
                f"({ops:g} device ops a step, torch.profiler, mean of "
                f"{DIST_PROFILE_STEPS}): busy {dev_ms / step_ms:.1%} of the "
                f"step ({smi})")
            del model, state
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def _replicated(t, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def gpipe_check(cfg, dev, smi: str, stages=GPIPE_STAGES,
                layers=GPIPE_LAYERS, M=GPIPE_M, mb=GPIPE_MB,
                seq=GPIPE_S) -> None:
    """(d) GPipe over ``stages`` stand-in stages on ``dev`` of ``layers``
    layers each against the same layers applied in order to each
    microbatch: bit-equal, times beside each other."""
    import torch
    from repro_torch import models as tm
    from repro_torch.distributed.pipeline import gpipe, make_pp_mesh
    from repro_torch.models.layers import stack_trees
    model = tm.init_lm(cfg, torch.Generator().manual_seed(LM_SEED),
                       device=dev)
    check(cfg.num_layers == stages * layers, f"[dist] {cfg.num_layers} "
          f"layers do not make {stages} stages of {layers}")
    trees = [tm.param_tree(model)["layers"][i] for i in range(cfg.num_layers)]
    with torch.no_grad():
        stacked = stack_trees([stack_trees(trees[i * layers:(i + 1) * layers],
                                           torch.stack)
                               for i in range(stages)], torch.stack)

        def stage_fn(p, x):
            for j in range(layers):
                x = tm.apply_layer(cfg, {k: _index(v, j) for k, v in
                                         p.items()}, x)
            return x
        run = gpipe(stage_fn, make_pp_mesh(stages, (dev,) * stages), stages)
        g = torch.Generator().manual_seed(LM_SEED)
        tokens = torch.randint(0, cfg.vocab_size, (M, mb, seq), generator=g)
        x = torch.nn.functional.embedding(tokens.to(dev), model.embed)

        def sequential():
            outs = []
            for m in x:
                for lp in model.layers:
                    m = tm.apply_layer(cfg, lp, m)
                outs.append(m)
            return torch.stack(outs)
        timed = {}
        for label, fn in (("gpipe", lambda: run(stacked, x)),
                          ("sequential", sequential)):
            out = fn()
            ts = []
            for _ in range(GPIPE_REPS):
                _sync(dev)
                t0 = time.perf_counter()
                fn()
                _sync(dev)
                ts.append(time.perf_counter() - t0)
            timed[label] = (out, statistics.median(ts) * 1e3)
    got, want = timed["gpipe"][0], timed["sequential"][0]
    check(bool(torch.isfinite(got.float()).all()), "[dist] GPipe output not "
          "finite")
    check(torch.equal(got, want), f"[dist] GPipe differs from the layers in "
          f"order by {max_abs_err(got.float(), want.float()):.3g}")
    log(f"[dist] GPipe: {stages} stand-in stages on {dev} x {layers} "
        f"{cfg.name} {cfg.dtype} layers, {M} microbatches of {mb} x {seq} "
        f"tokens ({M + stages - 1} ticks): output {tuple(got.shape)} "
        f"bit-equal to the {cfg.num_layers} layers in order; "
        f"{timed['gpipe'][1]:.5g} ms against {timed['sequential'][1]:.5g} "
        f"ms sequential (host clock, median of {GPIPE_REPS}, no_grad) "
        f"({smi})")


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _index(tree, j):
    if isinstance(tree, dict):
        return {k: _index(v, j) for k, v in tree.items()}
    return tree[j]


def dist_phase(dev, smi: str, cc, cut=None, seq_len=TRAIN_S,
               gpipe_seq=GPIPE_S, moe_seq=DIST_MOE_S) -> None:
    """Phase 11.  ``cut``, ``seq_len``, ``gpipe_seq``: a CPU rehearsal's
    smaller sizes (its launcher trains ``--reduced`` and it skips the
    device measurements); the card runs the published widths and depth
    at the defaults."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launcher
    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    cut = cut or {}

    # (a) the rules at production size
    rules_bytes(smi)

    # (b) the launcher a user calls, plain and on a 1x1 mesh (NCCL on the
    # card), deterministic algorithms on: the losses bit for bit
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dist_store.npz")
        cc.save(path)
        argv = ["--arch", TRAIN_ARCH, "--corpus", path, "--steps",
                str(DIST_STEPS), "--global-batch", str(TRAIN_B),
                "--seq-len", str(seq_len), "--microbatches",
                str(TRAIN_MICROBATCHES), "--device", str(dev)]
        if not cuda:
            argv.append("--reduced")
        runs = {}
        torch.use_deterministic_algorithms(True)
        try:
            for label, extra in (("plain", []), ("mesh 1x1", ["--mesh",
                                                              "1x1"])):
                t0 = time.perf_counter()
                out = launcher.main(argv + extra)
                runs[label] = (out["history"], out["step_seconds"],
                               time.perf_counter() - t0)
                del out
                if cuda:
                    torch.cuda.empty_cache()
        finally:
            torch.use_deterministic_algorithms(False)
    check(not dist.is_initialized(), "[dist] the launcher left its process "
          "group behind")
    plain, mesh = runs["plain"][0], runs["mesh 1x1"][0]
    check(all(np.isfinite(plain)), f"[dist] plain losses {plain}")
    check(mesh == plain, f"[dist] the 1x1 mesh's losses {mesh} differ from "
          f"the plain path's {plain}")
    for label, (hist, secs, wall) in runs.items():
        log(f"[dist] launcher {label}: {DIST_STEPS} steps, losses {hist}, "
            f"steps 1-{DIST_STEPS - 1} "
            f"{statistics.median(secs[1:]) * 1e3:.5g} ms median (host "
            f"clock, deterministic algorithms), {wall:.1f} s with its "
            f"set-up ({smi})")
    log(f"[dist] the 1x1 {'NCCL' if cuda else 'gloo'} mesh's {DIST_STEPS} "
        f"losses are bit-equal to the plain path's")

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), **cut)
    if cuda:
        # (c) a step's numbers, plain and on the mesh
        pipe_x, pipe_y = _first_batch(cc, seq_len)
        mesh_step_numbers(cfg, dev, smi, {
            "tokens": torch.from_numpy(pipe_x).to(dev),
            "labels": torch.from_numpy(pipe_y).to(dev)})
        check(not dist.is_initialized(), "[dist] the process group is left")

    # (d) GPipe over stand-in stages
    gpipe_check(cfg, dev, smi, seq=gpipe_seq,
                layers=cfg.num_layers // GPIPE_STAGES)
    if cuda:
        torch.cuda.empty_cache()

    # (e) the MoE dispatch on a mesh
    moe_check(dev, smi, cc, seq_len=moe_seq)
    log(f"[dist] phase done in {time.perf_counter() - t_phase:.1f} s")


def moe_check(dev, smi: str, cc, seq_len=DIST_MOE_S) -> None:
    """(e) ``qwen2-moe-a2.7b`` at its published widths, its depth cut to
    DIST_MOE_LAYERS (the launcher's ``--num-layers``), through the
    launcher for DIST_MOE_STEPS steps plain and on a 1x1 mesh under
    deterministic algorithms: the losses bit-equal (the routed experts
    run through ``local_map`` on the mesh).  Then a step of each, host
    and device ms (:func:`mesh_step_numbers`).  On the CPU it trains the
    reduced config and skips the device numbers."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launcher
    cuda = dev.type == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "moe_store.npz")
        cc.save(path)
        argv = ["--arch", DIST_MOE_ARCH, "--num-layers",
                str(DIST_MOE_LAYERS), "--corpus", path, "--steps",
                str(DIST_MOE_STEPS), "--global-batch", str(DIST_MOE_B),
                "--seq-len", str(seq_len), "--device", str(dev)]
        if not cuda:
            argv.append("--reduced")
        runs = {}
        torch.use_deterministic_algorithms(True)
        try:
            for label, extra in (("plain", []), ("mesh 1x1", ["--mesh",
                                                              "1x1"])):
                out = launcher.main(argv + extra)
                runs[label] = (out["history"], out["step_seconds"])
                del out
                if cuda:
                    torch.cuda.empty_cache()
        finally:
            torch.use_deterministic_algorithms(False)
    check(not dist.is_initialized(), "[dist] the MoE launcher left its "
          "process group behind")
    plain, mesh = runs["plain"][0], runs["mesh 1x1"][0]
    check(all(np.isfinite(plain)), f"[dist] MoE plain losses {plain}")
    check(mesh == plain, f"[dist] the MoE 1x1 mesh's losses {mesh} differ "
          f"from the plain path's {plain}")
    full = get_config(DIST_MOE_ARCH)
    cfg = dataclasses.replace(full, num_layers=DIST_MOE_LAYERS)
    what = (f"at its published widths (d_model {cfg.d_model}, "
            f"{cfg.moe_num_experts} experts top-{cfg.moe_top_k}, expert "
            f"d_ff {cfg.moe_d_ff}, shared {cfg.moe_shared_d_ff}, vocab "
            f"{cfg.vocab_size}), num_layers cut from {full.num_layers} to "
            f"{DIST_MOE_LAYERS} (--num-layers), {cfg.param_count()} "
            f"parameters, {cfg.dtype}" if cuda else
            "reduced, float32 (CPU rehearsal)")
    log(f"[dist] {DIST_MOE_ARCH} {what}, B={DIST_MOE_B} x {seq_len}: the "
        f"1x1 {'NCCL' if cuda else 'gloo'} mesh's {DIST_MOE_STEPS} losses "
        f"{mesh} are bit-equal to the plain path's ({smi})")
    for label, (hist, secs) in runs.items():
        log(f"[dist]   {DIST_MOE_ARCH} launcher {label}: steps "
            f"1-{DIST_MOE_STEPS - 1} {statistics.median(secs[1:]) * 1e3:.5g}"
            f" ms median (host clock, deterministic algorithms) ({smi})")
    if cuda:
        x, y = _first_batch(cc, seq_len, DIST_MOE_B)
        mesh_step_numbers(cfg, dev, smi, {
            "tokens": torch.from_numpy(x).to(dev),
            "labels": torch.from_numpy(y).to(dev)}, microbatches=1)
        check(not dist.is_initialized(), "[dist] the process group is left")
        torch.cuda.empty_cache()


def _first_batch(cc, seq_len, batch=TRAIN_B):
    from repro_torch.data import BatchPipeline
    return BatchPipeline(cc, global_batch=batch, seq_len=seq_len,
                         prefetch=0).batch_at(0)


# ----------------------------------------------------------------------- #
# The dry run (phase 12) and the roofline of a train step (phase 13)       #
# ----------------------------------------------------------------------- #
def dryrun_phase(smi: str, cut=None) -> None:
    """Phase 12: ``run_cell`` of each of DRYRUN_CELLS at full width on a
    DRYRUN_RANKS-rank fake process group (meta tensors: the host's work
    only), each cell's status checked, and its roofline terms at the H100
    constants; then :func:`share_check` of each of DRYRUN_SHARE_CELLS.
    ``cut``: a CPU rehearsal's smaller configs (each key a config
    uses)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, roofline
    t_phase = time.perf_counter()
    for arch, shape in DRYRUN_CELLS:
        cfg = get_config(arch)
        cfg = dataclasses.replace(cfg, **{k: v for k, v in (cut or {}).items()
                                          if getattr(cfg, k)})
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            with dryrun.fake_world(DRYRUN_RANKS):
                rec = dryrun.run_cell(arch, shape, DRYRUN_MESH, out_dir=tmp,
                                      force=True, cfg=cfg)
        secs = time.perf_counter() - t0
        check(rec["status"] == "ok", f"[dryrun] {arch} {shape} "
              f"{DRYRUN_MESH}: {rec.get('error')}\n{rec.get('trace')}")
        a = roofline.analyze(rec)
        log(f"[dryrun] {arch} ({cfg.num_layers} layers) {shape} "
            f"{DRYRUN_MESH} on {rec['devices']} fake ranks (torch "
            f"{torch.__version__}): status {rec['status']}, "
            f"{rec['memory']['argument_bytes'] / 2**30:.4f} GiB/dev "
            f"(arguments, the rules' shards), "
            f"{rec['cost']['flops_per_device'] / 1e9:.1f} GFLOP/dev, "
            f"{rec['cost']['bytes_per_device'] / 1e9:.1f} GB/dev accessed, "
            f"collective {rec['collective_bytes_per_device'] / 1e6:.1f} "
            f"MB/dev "
            f"{json.dumps({k: v['count'] for k, v in rec['collectives'].items()})}"
            f", ops {json.dumps(rec['ops'])}; {secs:.1f} s (build "
            f"{rec['lower_s']} s, counted step {rec['compile_s']} s, host "
            f"CPU); at the H100 constants compute "
            f"{a['compute_s'] * 1e3:.5g} ms, memory "
            f"{a['memory_s'] * 1e3:.5g} ms, collective "
            f"{a['collective_s'] * 1e3:.5g} ms a step, {a['dominant']}-bound"
            f", useful {a['useful_flop_ratio']:.3f} (counted, not measured; "
            f"{smi})")
    log(f"[dryrun] the {len(DRYRUN_CELLS)} cells: "
        f"{time.perf_counter() - t_phase:.1f} s (host CPU)")
    for arch, shape, mesh_kind in DRYRUN_SHARE_CELLS:
        share_check(arch, shape, mesh_kind, smi, cut)


def _fwd_bwd_flops(fn, params, x, loss):
    """Per-rank FLOPs of ``fn(params, x)`` and of its backward from
    ``loss`` of its (first) output."""
    from repro_torch.utils import hlo_analysis as ha
    with ha.count_ops() as fwd:
        y = fn(params, x)
    y = y[0] if isinstance(y, tuple) else y
    with ha.count_ops() as bwd:
        loss(y).backward()
    return fwd.flops, bwd.flops


def share_check(arch: str, shape: str, mesh_kind: str, smi: str,
                cut=None) -> None:
    """One layer of the cell (``arch``, ``shape``, ``mesh_kind``) on its
    fake group, its parameters placed by the rules and its input as the
    cell's activation policy places the residual stream, meta tensors at
    full width: the per-rank GFLOP, forward and backward, of each block
    that runs one shard a rank beside its split count, the plain block's
    FLOPs on global meta tensors over the ranks that share them (every
    rank; the MoE router only the batch rows' ranks).  Fails when they
    differ by more than DRYRUN_SHARE_TOL."""
    import dataclasses
    import math
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.distributed import default_rules, param_shardings
    from repro_torch.distributed.sharding import NamedSharding, mesh_axes
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import LM_SHAPES, moe, ssm
    from repro_torch.models.layers import _dtype, apply_ffn, unbox
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, **{k: v for k, v in (cut or {}).items()
                                      if getattr(cfg, k)})
    spec = LM_SHAPES[shape]
    shape_mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    rules = default_rules(shape_mesh)
    act = dryrun.make_activation_policy(cfg, shape, shape_mesh,
                                        rules)["act_btd"]
    sizes = mesh_axes(shape_mesh)
    ranks = math.prod(sizes.values())
    rows = ranks // sizes["model"]
    dt = _dtype(cfg.dtype)
    B, S, d = spec.global_batch, spec.seq_len, cfg.d_model
    if cfg.moe_num_experts:
        params, axes = unbox(moe.init_moe(None, cfg))
        blocks = (("shared expert", d,
                   lambda p, x: apply_ffn(p["shared"], x, "swiglu")),
                  ("MoE layer (router, routed and shared experts)", d,
                   lambda p, x: moe.apply_moe(p, x, cfg)))
    else:
        params, axes = unbox(ssm.init_mamba(None, cfg))
        blocks = (("in_proj", d, lambda p, x: ssm._project(
            x, p["in_proj"], "out")),
                  ("out_proj", cfg.ssm_expand * d, lambda p, x: ssm._project(
                      x, p["out_proj"], "in")))

    def plain_meta(tree):
        if isinstance(tree, dict):
            return {k: plain_meta(v) for k, v in tree.items()}
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta",
                           requires_grad=True)

    def leaves(tree):
        return ([t for v in tree.values() for t in leaves(v)]
                if isinstance(tree, dict) else [tree])
    t0 = time.perf_counter()
    with dryrun.fake_world(ranks):
        mesh = init_device_mesh("cpu", tuple(sizes.values()),
                                mesh_dim_names=tuple(sizes))
        for name, width, fn in blocks:
            plain_p = plain_meta(params)
            plain_x = torch.empty((B, S, width), dtype=dt, device="meta",
                                  requires_grad=True)
            plain = _fwd_bwd_flops(fn, plain_p, plain_x, lambda y: y.sum())
            router = (0.0, 0.0)
            if name.startswith("MoE"):
                router = _fwd_bwd_flops(lambda p, x: moe._router_probs(p, x),
                                        plain_p, plain_x, lambda y: y.sum())
            tree = dryrun._place_tree(params, param_shardings(
                axes, params, mesh, rules))
            for t in leaves(tree):
                t.requires_grad_()
            x = dryrun._placed((B, S, width), dt, NamedSharding(mesh, act))
            x.requires_grad_()

            def loss(y):
                return y.redistribute(mesh, [
                    Replicate() if p.is_partial() else p
                    for p in y.placements]).to_local().sum()
            with implicit_replication():
                got = _fwd_bwd_flops(fn, tree, x, loss)
            split = [r / rows + (p - r) / ranks
                     for p, r in zip(plain, router)]
            log(f"[dryrun] {arch}/{shape}/{mesh_kind} one layer's {name} "
                f"on {ranks} fake ranks (torch {torch.__version__}): "
                f"forward {got[0] / 1e9:.1f} GFLOP/dev against the split "
                f"count {split[0] / 1e9:.1f}, backward {got[1] / 1e9:.1f} "
                f"against {split[1] / 1e9:.1f} (plain {plain[0] / 1e9:.1f} "
                f"+ {plain[1] / 1e9:.1f} GFLOP; counted, not measured; "
                f"{smi})")
            for g, want, pass_ in zip(got, split, ("forward", "backward")):
                check(want > 0 and abs(g - want) <= DRYRUN_SHARE_TOL * want,
                      f"[dryrun] {arch}/{shape}/{mesh_kind} {name} {pass_}: "
                      f"{g / 1e9:.1f} GFLOP/dev against a split count of "
                      f"{want / 1e9:.1f}")
    log(f"[dryrun] {arch}/{shape}/{mesh_kind} one layer's check: "
        f"{time.perf_counter() - t0:.1f} s (host CPU)")


def roofline_phase(dev, smi: str, cc, train_ms, cut=None,
                   seq_len=TRAIN_S) -> None:
    """Phase 13: one bf16 step of ``[train]``'s model and batch (B=2 x
    4096, two microbatches, remat, the card's world of one) under the
    per-rank counter (``utils/hlo_analysis.py``): its FLOPs and bytes,
    the roofline's three terms at the H100 constants
    (``launch/roofline.py``), the dominant one, and the bound beside
    ``[train]``'s measured step.  ``cut``/``seq_len``: a CPU rehearsal's
    smaller sizes (no measured step to compare)."""
    import dataclasses
    import torch
    from repro_torch import models as tm
    from repro_torch import training as tt
    from repro_torch.configs import get_config
    from repro_torch.launch import roofline
    from repro_torch.utils import hlo_analysis as ha
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), **(cut or {}))
    model = tm.init_lm(cfg, torch.Generator().manual_seed(LM_SEED),
                       device=dev)
    opt = tt.AdamW(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP)
    step_fn = tt.make_train_step(cfg, opt, remat=True,
                                 microbatches=TRAIN_MICROBATCHES)
    x, y = _first_batch(cc, seq_len)
    batch = {"tokens": torch.from_numpy(x).to(dev),
             "labels": torch.from_numpy(y).to(dev)}
    state = opt.init(tm.lm_to_params(model))
    _, state, met = step_fn(model, state, batch)          # warm
    with ha.count_ops() as counted:
        _, state, met = step_fn(model, state, batch)
        loss = float(met["loss"])
    check(bool(np.isfinite(loss)), f"[roofline] the counted step's loss "
          f"{loss} is not finite")
    tokens = TRAIN_B * seq_len
    n_active = cfg.active_param_count()
    a = roofline.analyze({
        "status": "ok", "arch": cfg.name, "shape": "train_4k", "mesh": "1",
        "devices": 1,
        "cost": {"flops_per_device": counted.flops,
                 "bytes_per_device": counted.bytes},
        "collective_bytes_per_device": ha.total_collective_bytes(counted),
        "model_flops_total": 6.0 * n_active * tokens,
        "params_active": n_active,
        "memory": {"argument_bytes": 0, "temp_bytes": None}})
    vs = (f"{a['bound_s'] * 1e3 / train_ms:.4f} of [train]'s measured "
          f"step {train_ms:.5g} ms" if train_ms else "no measured step")
    log(f"[roofline] {cfg.name} {cfg.dtype} ({cfg.num_layers} layers), "
        f"B={TRAIN_B} x {seq_len}, {TRAIN_MICROBATCHES} microbatches, "
        f"remat, one step counted on {dev}: {counted.flops:.6g} FLOP, "
        f"{counted.bytes:.6g} B accessed, "
        f"{ha.total_collective_bytes(counted):g} B collective, "
        f"{sum(counted.ops.values())} ATen ops, dots "
        f"{ha.op_histogram(counted)['dot']}; at {roofline.PEAK_FLOPS:g} "
        f"FLOP/s, {roofline.HBM_BW:g} B/s, {roofline.LINK_BW:g} B/s: "
        f"compute {a['compute_s'] * 1e3:.5g} ms, memory "
        f"{a['memory_s'] * 1e3:.5g} ms, collective "
        f"{a['collective_s'] * 1e3:.5g} ms, {a['dominant']}-bound; "
        f"bound {a['bound_s'] * 1e3:.5g} ms = {vs}; useful "
        f"{a['useful_flop_ratio']:.4f} (6 x {n_active} x {tokens} over the "
        f"counted FLOPs) ({smi})")
    del model, state
    if dev.type == "cuda":
        torch.cuda.empty_cache()


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
            ("autotune_launches", "the autotune phase", TUNED_KERNELS)):
        missing = [r["name"] for r in records if r[field] <= 0
                   and (needed is None or r["name"] in needed)]
        if missing:
            print(f"chip_smoke: FAILED: {path} never launched {missing}",
                  file=sys.stderr)
            return 1
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    topk = lm_phase(dev, smi)
    log(f"[lm] launches {launch_counts()} (the LM path has no kernel of "
        f"its own)")
    log("[lm] masked_top_k " + json.dumps(topk))
    reset_launch_counts()
    cc, train_ms = train_phase(dev, smi)
    log(f"[train] launches {launch_counts()} (the training path has no "
        f"kernel of its own)")
    reset_launch_counts()
    dist_phase(dev, smi, cc)
    log(f"[dist] launches {launch_counts()} (the distribution layer has no "
        f"kernel of its own)")
    reset_launch_counts()
    dryrun_phase(smi)
    log(f"[dryrun] launches {launch_counts()} (host tooling, no kernel)")
    reset_launch_counts()
    roofline_phase(dev, smi, cc, train_ms)
    log(f"[roofline] launches {launch_counts()} (the training path has no "
        f"kernel of its own)")
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
