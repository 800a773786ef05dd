"""The benchmark's text: seeded synthetic corpora, made in numpy alone.

A frozen copy of the generator that ``chip_smoke.py`` drives
(``repro_torch.data.synthetic.make_corpus`` with its corpus properties):
Zipfian words over a fixed vocabulary with a share of the tokens drawn
from a pool of repeated phrases, sometimes two phrases back to back
(nested repetition), so that Sequitur finds the rule counts and depths
that real text gives it.  It is copied here so that a later change to the
program cannot change the benchmark's data.

A deployment (a configuration file) names the partitions, their files and
tokens, and the text properties; ``partition_files`` makes one partition's
raw token files from the run's seed and the partition's index, the same on
every machine.
"""

from __future__ import annotations

from typing import List

import numpy as np


def zipf_words(rng: np.random.Generator, n: int, vocab: int,
               a: float = 1.3) -> np.ndarray:
    """Zipf-distributed word ids clipped to the vocab."""
    w = rng.zipf(a, size=n)
    return np.minimum(w - 1, vocab - 1).astype(np.int64)


def make_corpus(rng: np.random.Generator, n_files: int,
                tokens_per_file: int, vocab: int, phrase_rate: float,
                n_phrases: int, phrase_len: int) -> List[np.ndarray]:
    phrases = [zipf_words(rng, phrase_len, vocab) for _ in range(n_phrases)]
    files: List[np.ndarray] = []
    for _ in range(n_files):
        parts: List[np.ndarray] = []
        total = 0
        while total < tokens_per_file:
            if rng.random() < phrase_rate:
                p = phrases[int(rng.integers(n_phrases))]
                # occasionally a multi-phrase motif (nested repetition)
                if rng.random() < 0.3:
                    p = np.concatenate(
                        [p, phrases[int(rng.integers(n_phrases))]])
            else:
                p = zipf_words(rng, int(rng.integers(3, 15)), vocab)
            parts.append(p)
            total += len(p)
        files.append(np.concatenate(parts)[: tokens_per_file])
    return files


def partition_files(text: dict, seed: int, partition: int
                    ) -> List[np.ndarray]:
    """The raw token files of one partition of a deployment.

    ``text`` is the configuration's ``text`` block; each partition draws
    from its own stream of the run's seed, so partitions differ and any
    partition can be made alone."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, partition]))
    return make_corpus(rng, n_files=text["files_per_partition"],
                       tokens_per_file=text["tokens_per_file"],
                       vocab=text["vocab"],
                       phrase_rate=text["phrase_rate"],
                       n_phrases=text["n_phrases"],
                       phrase_len=text["phrase_len"])
