"""Text → term-id frontend: queries arrive as raw strings.

A copy of the JAX package's ``query/frontend.py`` on the port's
tokenizer.  The serving layer speaks words; the engine speaks term ids.
This module bridges through
:class:`repro_torch.data.tokenizer.Tokenizer` — the same dictionary the
corpus was compressed with — WITHOUT mutating it: lookups on unknown words
map to ``UNK`` instead of growing the vocab (a query must never change the
compressed data's dictionary).

Filter expressions use a tiny grammar (uppercase keywords so corpus
words stay words)::

    expr := conj ("OR" conj)*
    conj := atom ("AND" atom)*
    atom := "(" expr ")" | WORD (">=" INT)?

``WORD`` alone means ``count(WORD) >= 1`` — presence.
"""

from __future__ import annotations

import re
from typing import List, Tuple

from repro_torch.data.tokenizer import UNK, Tokenizer

from .ops import normalize_phrase, normalize_predicate

__all__ = ["lookup_term", "terms_from_text", "phrase_from_text",
           "predicate_from_text"]

_LEX = re.compile(r"\(|\)|>=|\w+", re.UNICODE)
_WORD = re.compile(r"\w+", re.UNICODE)


def lookup_term(tok: Tokenizer, word: str) -> int:
    """The word's term id, ``UNK`` when absent — never grows the vocab."""
    return tok.word_to_id.get(word, UNK)


def terms_from_text(tok: Tokenizer, text: str) -> Tuple[int, ...]:
    """Term ids of every word in ``text``, in order (agg term sets)."""
    words = _WORD.findall(text)
    if not words:
        raise ValueError(f"no words in query text {text!r}")
    return tuple(lookup_term(tok, w) for w in words)


def phrase_from_text(tok: Tokenizer, text: str) -> Tuple[int, ...]:
    """Adjacent-token phrase from ``text`` (>= 2 words)."""
    return normalize_phrase(terms_from_text(tok, text))


def predicate_from_text(tok: Tokenizer, text: str):
    """Parse a filter expression into the canonical predicate tuples."""
    toks = _LEX.findall(text)
    pos = [0]

    def peek():
        return toks[pos[0]] if pos[0] < len(toks) else None

    def take():
        t = peek()
        if t is None:
            raise ValueError(f"unexpected end of filter expression {text!r}")
        pos[0] += 1
        return t

    def atom():
        t = take()
        if t == "(":
            node = expr()
            if take() != ")":
                raise ValueError(f"unbalanced parentheses in {text!r}")
            return node
        if t in (")", ">=", "AND", "OR"):
            raise ValueError(f"unexpected {t!r} in filter expression "
                             f"{text!r}")
        min_count = 1
        if peek() == ">=":
            take()
            n = take()
            if not n.isdigit():
                raise ValueError(f"'>=' wants an integer, got {n!r} "
                                 f"in {text!r}")
            min_count = int(n)
        return ("term", lookup_term(tok, t), min_count)

    def conj():
        kids: List = [atom()]
        while peek() == "AND":
            take()
            kids.append(atom())
        return kids[0] if len(kids) == 1 else ("and", tuple(kids))

    def expr():
        kids: List = [conj()]
        while peek() == "OR":
            take()
            kids.append(conj())
        return kids[0] if len(kids) == 1 else ("or", tuple(kids))

    node = expr()
    if peek() is not None:
        raise ValueError(f"trailing tokens {toks[pos[0]:]!r} in filter "
                         f"expression {text!r}")
    return normalize_predicate(node)
