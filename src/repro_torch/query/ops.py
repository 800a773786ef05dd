"""Composable query operators over compressed corpora — the operator IR.

A numpy copy of the JAX package's ``query/ops.py``: the same canonical
predicate encoding, so queries hash and group alike in both packages.

The query tier speaks three operator families (G-TADOC's sequence-support
argument promoted to a small SQL-ish surface, after the Microsoft
"GPU Acceleration of SQL Analytics on Compressed Data" direction):

* **filter** — ``files WHERE count(term) >= t``, with arbitrary AND/OR
  composition over term predicates;
* **aggregate** — per-file and cross-corpus ``sum``/``max`` of term
  counts over a term set;
* **phrase** — exact l-gram counts via the paper's sequence-support
  plans (``core/sequence.py``), never via decompression.

Predicates are canonicalized to nested tuples so they are hashable
(frozen ``Query`` dataclass fields and serving group keys want value
identity):

* ``("term", term_id, min_count)`` — leaf, true for files whose count of
  ``term_id`` is ``>= min_count``;
* ``("and", (child, ...))`` / ``("or", (child, ...))`` — composition,
  arbitrarily nested, at least one child each.

``predicate_leaves`` / ``predicate_structure`` split a canonical
predicate into its term/threshold table (device data) and its pure
combination tree with leaf slot indices (hashable) — the engine gathers
every leaf's counts in one vocab gather and folds the tree with torch
logical ops.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

__all__ = [
    "AGG_OPS", "term_pred", "and_", "or_", "normalize_predicate",
    "predicate_leaves", "predicate_structure", "predicate_mask",
    "normalize_agg", "normalize_phrase",
]

AGG_OPS = ("sum", "max")


# ----------------------------------------------------------------------- #
# Constructors (sugar over the canonical tuple encoding)                    #
# ----------------------------------------------------------------------- #
def term_pred(term: int, min_count: int = 1) -> Tuple:
    """``count(term) >= min_count`` over each file."""
    return normalize_predicate(("term", term, min_count))


def and_(*preds) -> Tuple:
    return normalize_predicate(("and", tuple(preds)))


def or_(*preds) -> Tuple:
    return normalize_predicate(("or", tuple(preds)))


# ----------------------------------------------------------------------- #
# Canonicalization / validation                                             #
# ----------------------------------------------------------------------- #
def normalize_predicate(pred) -> Tuple:
    """Canonical hashable nested-tuple form of a filter predicate.

    Accepts lists/tuples interchangeably and coerces numerics to ints;
    rejects malformed nodes, negative term ids, negative thresholds and
    empty AND/OR — a predicate that validates here is exactly one the
    engine (and the numpy oracle) can evaluate.
    """
    if not isinstance(pred, (tuple, list)) or not pred:
        raise ValueError(f"predicate nodes are tuples, got {pred!r}")
    tag = pred[0]
    if tag == "term":
        if len(pred) != 3:
            raise ValueError(f"term predicate wants (term, min_count), "
                             f"got {pred!r}")
        term, min_count = int(pred[1]), int(pred[2])
        if term < 0:
            raise ValueError(f"negative term id in predicate: {term}")
        if min_count < 0:
            raise ValueError(f"negative min_count in predicate: {min_count}")
        return ("term", term, min_count)
    if tag in ("and", "or"):
        if len(pred) != 2 or not isinstance(pred[1], (tuple, list)):
            raise ValueError(f"{tag!r} predicate wants a child sequence, "
                             f"got {pred!r}")
        kids = tuple(normalize_predicate(c) for c in pred[1])
        if not kids:
            raise ValueError(f"{tag!r} predicate needs at least one child")
        return (tag, kids)
    raise ValueError(f"unknown predicate node {tag!r}; "
                     f"expected 'term' / 'and' / 'or'")


def predicate_leaves(pred) -> List[Tuple[int, int]]:
    """``(term, min_count)`` leaves in left-to-right order — the slot
    order ``predicate_structure`` indexes into."""
    out: List[Tuple[int, int]] = []

    def walk(node):
        if node[0] == "term":
            out.append((node[1], node[2]))
        else:
            for c in node[1]:
                walk(c)

    walk(normalize_predicate(pred))
    return out


def predicate_structure(pred) -> Tuple:
    """The combination tree with leaves replaced by slot indices:
    ``("leaf", i)`` / ``("and", (...))`` / ``("or", (...))``.  Hashable;
    the engine folds the leaf masks along it."""
    counter = [0]

    def walk(node):
        if node[0] == "term":
            i = counter[0]
            counter[0] += 1
            return ("leaf", i)
        return (node[0], tuple(walk(c) for c in node[1]))

    return walk(normalize_predicate(pred))


def predicate_mask(pred, tv: np.ndarray) -> np.ndarray:
    """Evaluate a canonical predicate against a dense ``[F, V]`` term
    vector on host — bool ``[F]``.  Out-of-vocab terms count 0 (matching
    the batched program's padded-column gather); every comparison is on
    exact integer-valued float32, so this is bit-identical to the device
    path."""
    pred = normalize_predicate(pred)
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

    return ev(pred)


def normalize_agg(op) -> str:
    """Canonical aggregation op; ``None`` defaults to ``sum``."""
    if op is None:
        return "sum"
    if op not in AGG_OPS:
        raise ValueError(f"unknown aggregation {op!r}; "
                         f"expected one of {AGG_OPS}")
    return op


def normalize_phrase(phrase: Sequence[int]) -> Tuple[int, ...]:
    """Canonical phrase-token tuple: ints, order preserved, length >= 2
    (a 1-gram is a word count, not a sequence query)."""
    if phrase is None:
        raise ValueError("phrase queries need a token sequence")
    out = tuple(int(t) for t in phrase)
    if len(out) < 2:
        raise ValueError(f"phrase queries need at least 2 tokens, "
                         f"got {out!r}")
    if any(t < 0 for t in out):
        raise ValueError(f"negative token ids are invalid: {out}")
    return out
