"""Synthetic corpora shaped like the paper's Table II datasets.

Real text compresses under Sequitur because of repeated phrases (boilerplate
headers, quoted passages, templated markup).  The generators here draw
Zipfian words and inject repeated phrases/motifs at controllable rates so
compression ratio, rule count and DAG depth land in realistic ranges.

``TABLE2`` mirrors the paper's datasets A–E *scaled down*:
same file-count/size relationships, 1e3–1e5 tokens instead of GBs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass(frozen=True)
class CorpusSpec:
    name: str
    n_files: int
    tokens_per_file: int
    vocab: int
    phrase_rate: float        # fraction of text drawn from repeated phrases
    n_phrases: int
    phrase_len: int
    seed: int = 0


# Scaled-down analogues of Table II (A: many small files; B: few big files;
# C: large; D: tiny single file; E: one big file).
TABLE2 = {
    "A": CorpusSpec("A", n_files=96, tokens_per_file=220, vocab=1200,
                    phrase_rate=0.55, n_phrases=40, phrase_len=8),
    "B": CorpusSpec("B", n_files=4, tokens_per_file=6000, vocab=2500,
                    phrase_rate=0.6, n_phrases=60, phrase_len=10),
    "C": CorpusSpec("C", n_files=24, tokens_per_file=4000, vocab=4000,
                    phrase_rate=0.6, n_phrases=80, phrase_len=10),
    "D": CorpusSpec("D", n_files=1, tokens_per_file=1500, vocab=400,
                    phrase_rate=0.5, n_phrases=20, phrase_len=6),
    "E": CorpusSpec("E", n_files=1, tokens_per_file=12000, vocab=3000,
                    phrase_rate=0.6, n_phrases=70, phrase_len=10),
}


def zipf_words(rng: np.random.Generator, n: int, vocab: int,
               a: float = 1.3) -> np.ndarray:
    """Zipf-distributed word ids clipped to the vocab."""
    w = rng.zipf(a, size=n)
    return np.minimum(w - 1, vocab - 1).astype(np.int64)


def make_corpus(spec: CorpusSpec) -> List[np.ndarray]:
    rng = np.random.default_rng(spec.seed)
    phrases = [zipf_words(rng, spec.phrase_len, spec.vocab)
               for _ in range(spec.n_phrases)]
    files: List[np.ndarray] = []
    for _ in range(spec.n_files):
        parts: List[np.ndarray] = []
        total = 0
        while total < spec.tokens_per_file:
            if rng.random() < spec.phrase_rate:
                p = phrases[int(rng.integers(spec.n_phrases))]
                # occasionally a multi-phrase motif (nested repetition)
                if rng.random() < 0.3:
                    p = np.concatenate(
                        [p, phrases[int(rng.integers(spec.n_phrases))]])
            else:
                p = zipf_words(rng, int(rng.integers(3, 15)), spec.vocab)
            parts.append(p)
            total += len(p)
        files.append(np.concatenate(parts)[: spec.tokens_per_file])
    return files


def make_table2_corpus(name: str) -> List[np.ndarray]:
    return make_corpus(TABLE2[name])
