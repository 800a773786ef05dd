"""Word-level tokenizer (TADOC's dictionary conversion, paper §II-A Fig 1b).

TADOC encodes words as integers via a dictionary before grammar inference.
This tokenizer is that dictionary: split on whitespace/punctuation, map each
distinct word to an id.  ``from_tadoc_counts`` builds a frequency-ordered
vocab from counts produced by the compressed-domain ``word_count`` — the
framework's "vocab from compressed data" path.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List

import numpy as np

_SPLIT = re.compile(r"\w+|[^\w\s]", re.UNICODE)

UNK = 0


@dataclass
class Tokenizer:
    word_to_id: Dict[str, int] = field(default_factory=lambda: {"<unk>": UNK})
    id_to_word: List[str] = field(default_factory=lambda: ["<unk>"])
    frozen: bool = False

    @property
    def vocab_size(self) -> int:
        return len(self.id_to_word)

    def add(self, word: str) -> int:
        i = self.word_to_id.get(word)
        if i is None:
            if self.frozen:
                return UNK
            i = len(self.id_to_word)
            self.word_to_id[word] = i
            self.id_to_word.append(word)
        return i

    def encode(self, text: str) -> np.ndarray:
        return np.array([self.add(w) for w in _SPLIT.findall(text)],
                        dtype=np.int64)

    def decode(self, ids: Iterable[int]) -> str:
        return " ".join(self.id_to_word[int(i)] for i in ids)

    # ------------------------------------------------------------------ --
    @classmethod
    def build(cls, texts: Iterable[str]) -> "Tokenizer":
        tok = cls()
        for t in texts:
            tok.encode(t)
        tok.frozen = True
        return tok

    @classmethod
    def from_tadoc_counts(cls, words: List[str], counts: np.ndarray,
                          max_vocab: int | None = None) -> "Tokenizer":
        """Frequency-ordered vocab from compressed-domain word counts."""
        order = np.argsort(-np.asarray(counts), kind="stable")
        if max_vocab is not None:
            order = order[: max_vocab - 1]
        tok = cls()
        for i in order:
            tok.add(words[int(i)])
        tok.frozen = True
        return tok

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"words": self.id_to_word}, f)

    @classmethod
    def load(cls, path: str) -> "Tokenizer":
        with open(path) as f:
            words = json.load(f)["words"]
        tok = cls(word_to_id={w: i for i, w in enumerate(words)},
                  id_to_word=list(words), frozen=True)
        return tok
