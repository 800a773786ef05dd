"""The plain reference: every analytic from the raw token files, in numpy.

Decompress-then-scan: nothing here reads what the program built (no
grammar, pack, plan or statistic); it counts the words of the files that
``corpus.py`` made.  The arithmetic is a frozen copy of ``chip_smoke.py``'s
``oracle``, so the answers are the ones the served path has to give,
exactly: counts are integer-valued float32 below 2**24.

``low=True`` gives the control: the same reference with every count held
in bfloat16, the precision below the float32 that the deployment states.
Each kind's module in ``kinds/`` builds its answer from a :class:`Partition`.
"""

from __future__ import annotations

from functools import cached_property
from typing import Dict, Sequence, Tuple

import numpy as np


def bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return u.view(np.float32)


class Partition:
    """One partition's raw files and the counts every kind starts from."""

    def __init__(self, files: Sequence[np.ndarray], vocab: int,
                 low: bool = False):
        self.files = [np.asarray(f, np.int64) for f in files]
        self.vocab = vocab
        self.low = low
        self._grams: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    def _held(self, x: np.ndarray) -> np.ndarray:
        return bf16(x) if self.low else x

    @cached_property
    def word_count(self) -> np.ndarray:
        return self._held(np.bincount(
            np.concatenate(self.files), minlength=self.vocab
        ).astype(np.float32))

    @cached_property
    def term_vector(self) -> np.ndarray:
        tv = np.zeros((len(self.files), self.vocab), np.float32)
        for i, f in enumerate(self.files):
            words, counts = np.unique(f, return_counts=True)
            tv[i, words] = counts
        return self._held(tv)

    def grams(self, l: int) -> Tuple[np.ndarray, np.ndarray]:
        """The distinct l-grams inside files (int32 [n, l], sorted) and
        their counts (float32 [n])."""
        if l not in self._grams:
            grams = [np.stack([f[i: len(f) - l + 1 + i] for i in range(l)],
                              axis=1)
                     for f in self.files if len(f) >= l]
            grams = (np.concatenate(grams) if grams
                     else np.zeros((0, l), np.int64))
            uniq, counts = np.unique(grams, axis=0, return_counts=True)
            self._grams[l] = (uniq.astype(np.int32),
                              self._held(counts.astype(np.float32)))
        return self._grams[l]


def sort_words(wc: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    order = np.argsort(-wc, kind="stable")
    return order.astype(np.int32), wc[order]


def ranked(tv: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per word, the files by descending count (ties to the lower file):
    ``(ranking [V, F] int32, counts [V, F])``.  A word that no file holds
    ranks the files in their order; only the others are sorted."""
    F, V = tv.shape
    rank = np.broadcast_to(np.arange(F, dtype=np.int32), (V, F)).copy()
    held = np.flatnonzero(tv.any(axis=0))
    rows = np.ascontiguousarray(tv[:, held].T)
    rank[held] = np.argsort(-rows, axis=1, kind="stable")
    counts = np.zeros((V, F), tv.dtype)
    counts[held] = np.take_along_axis(rows, rank[held].astype(np.int64),
                                      axis=1)
    return rank, counts


def bad_entries(got, want) -> int:
    """How many entries of a served answer differ from the reference's.
    A missing answer (None), or a wrong arity, shape or dtype, makes every
    entry of that part bad."""
    if got is None:
        return sum(max(np.asarray(w).size, 1) for w in
                   (want if isinstance(want, tuple) else (want,)))
    if isinstance(want, tuple):
        if not isinstance(got, (tuple, list)) or len(got) != len(want):
            return sum(max(np.asarray(w).size, 1) for w in want)
        return sum(bad_entries(g, w) for g, w in zip(got, want))
    g = np.asarray(got)
    if g.shape != want.shape or g.dtype != want.dtype:
        return max(want.size, 1)
    return int(np.count_nonzero(g != want))
