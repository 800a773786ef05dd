"""Numpy-seeded inputs shared by the port's differential tests (the CPU
suites feed them to both packages; the card suite to kernel and plain
version).  Integer-valued float32 everywhere unless a test asks for
arbitrary floats, so sums are exact in any order."""

from __future__ import annotations

import importlib.util
import pathlib
from typing import List, Tuple

import numpy as np


def plan_inputs(rng, n: int, rows: int, k: int, R: int,
                integer: bool = True):
    """(weights [n, R], active [n, R], src [n, rows, k], freq) for one ELL
    round; ~1/3 of the plan entries are padding (freq == 0)."""
    src = rng.integers(0, R, (n, rows, k)).astype(np.int32)
    freq = rng.integers(0, 3, (n, rows, k)).astype(np.float32)
    if integer:
        w = rng.integers(0, 1000, (n, R)).astype(np.float32)
    else:
        w = rng.normal(size=(n, R)).astype(np.float32)
    a = (rng.random((n, R)) < 0.5).astype(np.float32)
    return w, a, src, freq


def vector_inputs(rng, n: int, R: int, k: int, F: int,
                  integer: bool = True):
    """(W [n, R, F], active [n, R], src [n, R, k], freq) for one
    vector-payload round."""
    if integer:
        W = rng.integers(0, 5, (n, R, F)).astype(np.float32)
    else:
        W = rng.normal(size=(n, R, F)).astype(np.float32)
    a = (rng.random((n, R)) < 0.4).astype(np.float32)
    src = rng.integers(0, R, (n, R, k)).astype(np.int32)
    freq = rng.integers(0, 3, (n, R, k)).astype(np.float32)
    return W, a, src, freq


#: Id distributions of :func:`bincount_inputs` beyond the uniform one.
BINCOUNT_CASES = ("zipf", "padding_rows", "out_of_range")


def bincount_inputs(rng, n: int, nbins: int, integer: bool = True,
                    case: str = "uniform", rows: int = 0):
    """(ids int32 with ~10% out of range, vals float32), [n] — or
    [rows, n] where ``rows`` is given.  ``case``:

    - ``uniform``: ids uniform over [-2, nbins + 2);
    - ``zipf``: Zipf-skewed ids (a few hot bins take most entries, as the
      engine's word tables do), ~10% of them -1 padding;
    - ``padding_rows``: ``zipf``, with every other row (or, in 1-D, the
      second half) all -1 padding and a tenth of the values zero;
    - ``out_of_range``: ids from -3 to 2 * nbins, so many are >= nbins.
    """
    shape = (rows, n) if rows else (n,)
    if case == "uniform":
        ids = rng.integers(-2, nbins + 2, shape)
    elif case in ("zipf", "padding_rows"):
        ids = (rng.zipf(1.3, shape) - 1) % nbins
        ids[rng.random(shape) < 0.1] = -1
        if case == "padding_rows":
            if rows:
                ids[1::2] = -1
            else:
                ids[n // 2:] = -1
    elif case == "out_of_range":
        ids = rng.integers(-3, 2 * nbins, shape)
    else:
        raise ValueError(f"unknown bincount case {case!r}")
    if integer:
        vals = rng.integers(0, 50, shape).astype(np.float32)
    else:
        vals = rng.normal(size=shape).astype(np.float32)
    if case == "padding_rows":
        vals[rng.random(shape) < 0.1] = 0.0
    return ids.astype(np.int32), vals


#: Vector-round plans of :func:`vector_case`.
VECTOR_CASES = ("wide_interleaved", "long_rows", "hot_sources",
                "all_inactive")


def vector_case(rng, case: str, n: int, R: int, k: int, F: int,
                integer: bool = True):
    """(W [n, R, F], active [n, R], src [n, R, k], freq) of one vector
    round on a wide plan, like the engine's (K=128 with 1-4 real entries a
    row), whose real entries sit at random positions among the padding:

    - ``wide_interleaved``: 0-4 real entries a row;
    - ``long_rows``: as above, and a tenth of the rows with 33 to 3k/4
      real entries (more than one warp's ballot);
    - ``hot_sources``: half the real entries point at one of three hot
      sources, shared by many rows;
    - ``all_inactive``: as ``wide_interleaved`` with every source inactive.

    ``active`` is 0, 1/4, 1/2 or 1 (fractional, yet every sum exact);
    ``freq`` 1-3 on real entries; padding has a random in-range ``src``.
    """
    if case not in VECTOR_CASES:
        raise ValueError(f"unknown vector case {case!r}")
    live = rng.integers(0, 5, (n, R))
    if case == "long_rows":
        hit = rng.random((n, R)) < 0.1
        live[hit] = rng.integers(33, max(34, 3 * k // 4) + 1, int(hit.sum()))
    live = np.minimum(live, k)
    # the live entries of a row: its `live` smallest random keys
    keys = rng.random((n, R, k))
    kth = np.sort(keys, axis=-1)
    thr = np.take_along_axis(kth, np.maximum(live - 1, 0)[..., None], -1)
    real = (keys <= thr) & (live[..., None] > 0)
    freq = np.where(real, rng.integers(1, 4, (n, R, k)), 0).astype(np.float32)
    src = rng.integers(0, R, (n, R, k)).astype(np.int32)
    if case == "hot_sources":
        hot = real & (rng.random((n, R, k)) < 0.5)
        src[hot] = rng.integers(0, min(3, R), int(hot.sum()))
    active = rng.choice(np.array([0.0, 0.0, 0.25, 0.5, 1.0], np.float32),
                        (n, R))
    if case == "all_inactive":
        active[:] = 0.0
    if integer:
        W = rng.integers(0, 5, (n, R, F)).astype(np.float32)
    else:
        W = rng.normal(size=(n, R, F)).astype(np.float32)
    return W, active.astype(np.float32), src, freq


def _dag(rng, R: int, k: int, parents):
    """A rule DAG in ELL form with rule indices in topological order: rule
    r >= 1 takes the parents ``parents(r)`` (earlier rules) with
    frequencies 1-3, or the root alone where the weight would reach 2^22.
    Returns (src, freq, in_deg, exact weights, depth)."""
    src = np.zeros((R, k), np.int32)
    freq = np.zeros((R, k), np.float32)
    in_deg = np.zeros(R, np.int32)
    w = np.zeros(R, np.float64)
    lvl = np.zeros(R, np.int64)
    w[0] = 1.0
    for r in range(1, R):
        ps = parents(r)
        fs = rng.integers(1, 4, size=len(ps))
        if float((fs * w[ps]).sum()) > (1 << 22):
            ps, fs = np.array([0]), np.array([1])       # keep w < 2^23
        d = len(ps)
        src[r, :d] = ps
        freq[r, :d] = fs
        in_deg[r] = d
        w[r] = float((fs * w[ps]).sum())
        lvl[r] = 1 + int(lvl[ps].max())
    return src, freq, in_deg, w.astype(np.float32), int(lvl.max())


def random_dag(rng, R: int, max_deg: int):
    """A random rule DAG of in-degree 1..max_deg (see :func:`_dag`)."""
    return _dag(rng, R, max_deg, lambda r: rng.choice(
        r, size=int(rng.integers(1, min(max_deg, r) + 1)), replace=False))


def _stack(parts):
    """(w0, in_deg float32, src, freq, exact weights, max depth) of DAGs
    from :func:`_dag` on one [n, R, K] plan, the root weighing 1."""
    n, R = len(parts), parts[0][0].shape[0]
    w0 = np.zeros((n, R), np.float32)
    w0[:, 0] = 1.0
    return (w0, np.stack([p[2] for p in parts]).astype(np.float32),
            np.stack([p[0] for p in parts]), np.stack([p[1] for p in parts]),
            np.stack([p[3] for p in parts]), max(p[4] for p in parts))


def batch_dags(rng, R: int, max_deg: int, n: int):
    """n random DAGs on one [n, R, K] plan (see :func:`_stack`)."""
    return _stack([random_dag(rng, R, max_deg) for _ in range(n)])


def skewed_dag(rng, R: int, k: int, n_long: int, long_deg: Tuple[int, int],
               hubs: int):
    """A rule DAG whose rows are short and skewed, like the engine's plans:
    rules 1..hubs hang off the root, most later rules have 1-3 parents, and
    ``n_long`` of them have ``long_deg`` (lo, hi) parents among the hubs
    (see :func:`_dag`)."""
    long_rows = set(rng.choice(np.arange(hubs + 1, R), size=n_long,
                               replace=False).tolist())

    def parents(r):
        if r <= hubs:
            return np.array([0])
        if r in long_rows:
            return rng.choice(np.arange(1, hubs + 1), replace=False,
                              size=int(rng.integers(long_deg[0],
                                                    long_deg[1] + 1)))
        return rng.choice(r, replace=False,
                          size=int(rng.integers(1, min(3, r) + 1)))
    return _dag(rng, R, k, parents)


def skewed_dags(rng, R: int, k: int, n: int, n_long: int,
                long_deg: Tuple[int, int], hubs: int):
    """n skewed DAGs on one [n, R, k] plan (see :func:`_stack`)."""
    return _stack([skewed_dag(rng, R, k, n_long, long_deg, hubs)
                   for _ in range(n)])


def widen(src, freq, k: int):
    """The [n, R, K] plan widened to k >= K entries a row (padding
    appended)."""
    n, R, k0 = src.shape
    wide_src = np.zeros((n, R, k), np.int32)
    wide_freq = np.zeros((n, R, k), np.float32)
    wide_src[:, :, :k0] = src
    wide_freq[:, :, :k0] = freq
    return wide_src, wide_freq


def interleave_padding(rng, src, freq, k: int):
    """The [n, R, K] plan widened to k >= K entries a row, then each row's
    entries shuffled, so the real entries sit among the padding."""
    n, R, _ = src.shape
    wide_src, wide_freq = widen(src, freq, k)
    perm = np.argsort(rng.random((n, R, k)), axis=-1)
    wide_src = np.take_along_axis(wide_src, perm, axis=-1)
    wide_freq = np.take_along_axis(wide_freq, perm, axis=-1)
    # padding gets a random in-range src: nothing may read through it
    pad = wide_freq == 0
    wide_src[pad] = rng.integers(0, R, int(pad.sum()))
    return wide_src, wide_freq


def raise_in_deg(rng, in_deg, share: float):
    """in_deg with ``share`` of the non-root rules asking for one more
    parent than the plan gives them: those rules never become ready."""
    out = in_deg.copy()
    hit = rng.random(out.shape) < share
    hit[:, 0] = False
    out[hit] += 1.0
    return out


#: The plans the fused frontier kernel must treat exactly like its plain
#: version, beyond well-formed left-packed ones (see :func:`fused_case`).
FUSED_CASES = ("interleaved_padding", "skewed_rows", "cut_max_rounds",
               "inconsistent_in_deg")


def fused_case(rng, case: str, n: int, R: int, k: int):
    """(w0, in_deg, src, freq, max_rounds) of one fused-traversal case on
    an [n, R, k] plan:

    - ``interleaved_padding``: random DAGs of in-degree <= k // 2 whose real
      entries are shuffled among the padding of each row;
    - ``skewed_rows``: mostly 1-3 parents a rule and a few rules with
      3/5 to 2/3 of k parents (:func:`skewed_dags`);
    - ``cut_max_rounds``: ``max_rounds`` half the DAGs' depth, so the loop
      is cut before the frontier empties;
    - ``inconsistent_in_deg``: a tenth of the rules ask for one more parent
      than the plan gives them (:func:`raise_in_deg`).
    """
    if case not in FUSED_CASES:
        raise ValueError(f"unknown fused case {case!r}")
    if case == "skewed_rows":
        long_deg = (k * 3 // 5, k * 2 // 3)
        w0, ind, src, freq, _, depth = skewed_dags(
            rng, R, k, n, max(1, R // 200), long_deg, long_deg[1])
        return w0, ind, src, freq, depth + 1
    w0, ind, src, freq, _, depth = batch_dags(rng, R, max(1, k // 2), n)
    if case == "interleaved_padding":
        src, freq = interleave_padding(rng, src, freq, k)
    else:
        src, freq = widen(src, freq, k)
    if case == "cut_max_rounds":
        return w0, ind, src, freq, max(1, depth // 2)
    if case == "inconsistent_in_deg":
        ind = raise_in_deg(rng, ind, 0.1)
    return w0, ind, src, freq, depth + 1


def corpus_files(rng, vocab: int, n_files: int, size: int
                 ) -> List[np.ndarray]:
    """Files of ``size`` tokens mixing one repeated phrase with noise."""
    phrase = rng.integers(0, vocab, int(rng.integers(3, 9)))
    files = []
    for _ in range(n_files):
        parts, total = [], 0
        while total < size:
            p = (phrase if rng.random() < 0.5
                 else rng.integers(0, vocab, int(rng.integers(2, 12))))
            parts.append(p)
            total += len(p)
        files.append(np.concatenate(parts)[:size] if parts
                     else np.zeros(0, np.int64))
    return files


#: (vocab, files, tokens per file) of a ragged pack: wildly different
#: R / V / F, a single-file corpus and an empty one.
RAGGED_SPECS: Tuple[Tuple[int, int, int], ...] = (
    (7, 1, 40), (50, 4, 300), (400, 6, 900), (15, 2, 120), (30, 3, 0))


def ragged_corpora(seed: int = 1234) -> List[Tuple[List[np.ndarray], int]]:
    rng = np.random.default_rng(seed)
    return [(corpus_files(rng, v, nf, size), v)
            for (v, nf, size) in RAGGED_SPECS]


# ------------------------------------------------ search / query oracles --
# numpy over the raw token files: chip_smoke.py's own oracles (it cannot
# import tests/), loaded from the repo root so there is one copy; their
# float32 operation order is that of tests/_oracle.py, so the comparisons
# can demand bit equality.
def _load_smoke():
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_oracles",
        pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_SMOKE = _load_smoke()


def files_term_vector(files, vocab: int) -> np.ndarray:
    """[F, V] float32 per-file counts of the raw files."""
    return np.stack([np.bincount(np.asarray(f, np.int64), minlength=vocab)
                     for f in files]).astype(np.float32).reshape(
                         len(files), vocab)


def files_search(files, vocab: int, terms, k: int, scheme: str):
    """BM25 / TF-IDF top-k of the raw files: (ids int32, scores float32),
    ties toward the lower file id."""
    return _SMOKE.search_oracle(files_term_vector(files, vocab), terms, k,
                                scheme)


def files_filter(files, vocab: int, predicate) -> np.ndarray:
    """Ascending int32 ids of the files satisfying a canonical predicate."""
    return _SMOKE.filter_oracle(files_term_vector(files, vocab), predicate)


def files_agg(files, vocab: int, terms, op: str):
    """(per_file [F] float32, total float32) sum/max of the term counts."""
    return _SMOKE.agg_oracle(files_term_vector(files, vocab), terms, op)


def files_phrase(files, phrase) -> np.float32:
    """Occurrences of the phrase in the raw files (never across files)."""
    return _SMOKE.phrase_oracle(files, phrase)
