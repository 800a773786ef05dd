"""Numpy-seeded inputs shared by the port's differential tests (the CPU
suites feed them to both packages; the card suite to kernel and plain
version).  Integer-valued float32 everywhere unless a test asks for
arbitrary floats, so sums are exact in any order."""

from __future__ import annotations

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


def bincount_inputs(rng, n: int, nbins: int, integer: bool = True):
    """(ids [n] int32 with ~10% out of range, vals [n] float32)."""
    ids = rng.integers(-2, nbins + 2, n).astype(np.int32)
    if integer:
        vals = rng.integers(0, 50, n).astype(np.float32)
    else:
        vals = rng.normal(size=n).astype(np.float32)
    return ids, vals


def random_dag(rng, R: int, max_deg: int):
    """A random rule DAG in ELL form with rule indices in topological
    order; returns (src, freq, in_deg, exact weights, depth)."""
    src = np.zeros((R, max_deg), np.int32)
    freq = np.zeros((R, max_deg), np.float32)
    in_deg = np.zeros(R, np.int32)
    w = np.zeros(R, np.float64)
    lvl = np.zeros(R, np.int64)
    w[0] = 1.0
    for r in range(1, R):
        d = int(rng.integers(1, min(max_deg, r) + 1))
        ps = rng.choice(r, size=d, replace=False)
        fs = rng.integers(1, 4, size=d)
        if float((fs * w[ps]).sum()) > (1 << 22):
            ps, fs, d = np.array([0]), np.array([1]), 1   # keep w < 2^23
        src[r, :d] = ps
        freq[r, :d] = fs
        in_deg[r] = d
        w[r] = float((fs * w[ps]).sum())
        lvl[r] = 1 + int(lvl[ps].max())
    return src, freq, in_deg, w.astype(np.float32), int(lvl.max())


def batch_dags(rng, R: int, max_deg: int, n: int):
    """n random DAGs on one [n, R, K] plan: (w0, in_deg float32, src, freq,
    exact weights, max depth)."""
    parts = [random_dag(rng, R, max_deg) for _ in range(n)]
    src = np.stack([p[0] for p in parts])
    freq = np.stack([p[1] for p in parts])
    ind = np.stack([p[2] for p in parts]).astype(np.float32)
    want = np.stack([p[3] for p in parts])
    w0 = np.zeros((n, R), np.float32)
    w0[:, 0] = 1.0
    return w0, ind, src, freq, want, max(p[4] for p in parts)


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
