"""Sequitur grammar inference (host side, numpy/python).

TADOC extends Sequitur [Nevill-Manning & Witten 1997] as its compression
algorithm (paper §II-A).  This is the classic online algorithm with the two
invariants:

  * digram uniqueness — no pair of adjacent symbols appears more than once
    in the grammar;
  * rule utility      — every rule (except the root) is referenced >= 2
    times.

Symbols are integers.  Terminals are ``0 .. num_terminals-1`` (this includes
the per-file splitter symbols TADOC inserts at file boundaries — splitters
are *unique*, so they never form repeated digrams and thus never end up
inside a rule).  Nonterminals are returned as ``num_terminals + rule_index``
in the exported grammar (root is rule 0).

This module is deliberately host-side: grammar inference is the *offline
compression* step of TADOC; the analytics (the paper's contribution) operate
on the flattened arrays produced by :mod:`repro_torch.core.grammar`.

A line-for-line copy of the JAX package's ``core/sequitur.py``: the two
packages must infer identical grammars from identical files, including
on the inputs where the live digram index drops an overlapping run
(the exported grammar still round-trips there).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.obs import global_registry

# Node storage: parallel lists (struct-of-arrays linked list).  A node is an
# index into these lists.  ``val`` >= 0 is a terminal; ``val`` < 0 encodes
# nonterminal rule ``-(val + 1)``; guards have ``val == GUARD`` and carry the
# owning rule id in ``guard_rule``.
GUARD = -(1 << 60)


def _rule_sym(rule_id: int) -> int:
    return -(rule_id + 1)


def _sym_rule(val: int) -> int:
    return -val - 1


def _is_rule(val: int) -> bool:
    # Guards use val <= GUARD (rule id encoded below GUARD); rule symbols are
    # small negatives strictly above GUARD.
    return val < 0 and val > GUARD


@dataclass
class Grammar:
    """Inferred grammar: ``rules[i]`` is the body of rule i (root == 0).

    Body symbols: ``0 <= s < num_terminals`` are terminals, otherwise
    ``s - num_terminals`` is a rule index.
    """

    num_terminals: int
    rules: List[np.ndarray] = field(default_factory=list)

    @property
    def num_rules(self) -> int:
        return len(self.rules)

    def expand(self, rule_id: int = 0, _memo: Dict[int, np.ndarray] | None = None) -> np.ndarray:
        """Decompress a rule to its terminal sequence (oracle for tests).

        Explicit-stack iterative: a chain grammar R0 -> R1 -> ... -> Rn is
        only log-deep when Sequitur built it, but nothing stops a caller
        (or a future parallel constructor) from handing this a chain deeper
        than Python's recursion limit — the recursive form died there.
        """
        if _memo is None:
            _memo = {}
        nt = self.num_terminals
        stack: List[int] = [rule_id]
        while stack:
            r = stack[-1]
            if r in _memo:
                stack.pop()
                continue
            missing = [int(s) - nt for s in self.rules[r]
                       if int(s) >= nt and (int(s) - nt) not in _memo]
            if missing:
                stack.extend(missing)
                continue
            out: List[np.ndarray] = []
            for s in self.rules[r]:
                s = int(s)
                if s < nt:
                    out.append(np.array([s], dtype=np.int64))
                else:
                    out.append(_memo[s - nt])
            _memo[r] = (np.concatenate(out) if out
                        else np.zeros(0, dtype=np.int64))
            stack.pop()
        return _memo[rule_id]


class _Sequitur:
    __slots__ = (
        "nxt", "prv", "val", "free",
        "digrams", "rule_guard", "rule_ref", "n_rules",
    )

    def __init__(self) -> None:
        self.nxt: List[int] = []
        self.prv: List[int] = []
        self.val: List[int] = []
        self.free: List[int] = []
        self.digrams: Dict[Tuple[int, int], int] = {}
        self.rule_guard: Dict[int, int] = {}
        self.rule_ref: Dict[int, int] = {}
        self.n_rules = 0

    # ------------------------------------------------------------- nodes --
    def _new_node(self, v: int) -> int:
        if self.free:
            n = self.free.pop()
            self.val[n] = v
            return n
        self.nxt.append(-1)
        self.prv.append(-1)
        self.val.append(v)
        return len(self.val) - 1

    def _free_node(self, n: int) -> None:
        self.free.append(n)

    def _is_guard(self, n: int) -> bool:
        return self.val[n] == GUARD or self.val[n] <= GUARD

    # ------------------------------------------------------------- rules --
    def new_rule(self) -> int:
        rid = self.n_rules
        self.n_rules += 1
        g = self._new_node(GUARD - (rid + 1))  # encode rule id in guard val
        self.nxt[g] = g
        self.prv[g] = g
        self.rule_guard[rid] = g
        self.rule_ref[rid] = 0
        return rid

    def _guard_rule(self, g: int) -> int:
        return -(self.val[g] - GUARD) - 1

    # ----------------------------------------------------------- digrams --
    def _digram_of(self, n: int) -> Tuple[int, int]:
        return (self.val[n], self.val[self.nxt[n]])

    def _remove_digram(self, n: int) -> None:
        """Remove the digram starting at n from the index, if n owns it."""
        m = self.nxt[n]
        if self._is_guard(n) or self._is_guard(m):
            return
        d = self._digram_of(n)
        if self.digrams.get(d) == n:
            del self.digrams[d]

    # ------------------------------------------------------------ splice --
    def _insert_after(self, pos: int, v: int) -> int:
        n = self._new_node(v)
        nn = self.nxt[pos]
        self.nxt[pos] = n
        self.prv[n] = pos
        self.nxt[n] = nn
        self.prv[nn] = n
        if _is_rule(v):
            self.rule_ref[_sym_rule(v)] += 1
        return n

    def _unlink(self, n: int) -> None:
        p, q = self.prv[n], self.nxt[n]
        self.nxt[p] = q
        self.prv[q] = p
        v = self.val[n]
        if _is_rule(v):
            self.rule_ref[_sym_rule(v)] -= 1
        self._free_node(n)

    # -------------------------------------------------------------- core --
    def append(self, rule_id: int, v: int) -> None:
        g = self.rule_guard[rule_id]
        last = self.prv[g]
        n = self._insert_after(last, v)
        self._check(self.prv[n])

    def _check(self, n: int) -> bool:
        """Enforce digram uniqueness for the digram starting at node n."""
        if n < 0 or self._is_guard(n):
            return False
        m = self.nxt[n]
        if self._is_guard(m):
            return False
        d = self._digram_of(n)
        other = self.digrams.get(d)
        if other is None:
            self.digrams[d] = n
            return False
        if other == n:
            return False
        # Overlapping occurrence (e.g. "aaa"): do nothing.
        if self.nxt[other] == n or self.nxt[n] == other:
            return False
        self._match(n, other)
        return True

    def _match(self, n: int, other: int) -> None:
        """Digram at n repeats the indexed digram at `other`."""
        og = self.prv[other]
        # Is `other` exactly a whole rule body of length 2?
        if (self._is_guard(self.prv[other])
                and self._is_guard(self.nxt[self.nxt[other]])):
            rid = self._guard_rule(self.prv[other])
            self._substitute(n, rid)
        else:
            rid = self.new_rule()
            a, b = self._digram_of(other)
            g = self.rule_guard[rid]
            n1 = self._insert_after(g, a)
            n2 = self._insert_after(n1, b)
            self.digrams[self._digram_of(n1)] = n1
            # Substitute the *indexed* occurrence first, then ours.
            self._substitute(other, rid)
            self._substitute(n, rid)

    def _substitute(self, n: int, rid: int) -> None:
        """Replace the digram starting at n with nonterminal `rid`."""
        m = self.nxt[n]
        prev = self.prv[n]
        # Remove index entries for digrams destroyed by the splice.
        self._remove_digram(prev)
        self._remove_digram(n)
        self._remove_digram(m)
        self._unlink(m)
        self._unlink(n)
        s = self._insert_after(prev, _rule_sym(rid))
        # Rule utility: a refcount may have dropped to 1 here.  We enforce
        # utility lazily — single-use rules are inlined once, at export()
        # (grammar stays semantically identical; canonical Sequitur inlines
        # eagerly, which only changes *which* equal-size grammar you get).
        if not self._check(prev):
            self._check(s)

    # ------------------------------------------------------------ export --
    def export(self, num_terminals: int) -> Grammar:
        """Inline single-use rules, renumber, and export flat bodies."""
        ref = dict(self.rule_ref)
        # root (rule 0) is always kept
        keep = [rid for rid in range(self.n_rules) if rid == 0 or ref.get(rid, 0) >= 2]
        single = {rid for rid in range(self.n_rules) if rid != 0 and ref.get(rid, 0) < 2}

        bodies: Dict[int, List[int]] = {}

        def raw_body(rid: int) -> List[int]:
            out: List[int] = []
            g = self.rule_guard[rid]
            n = self.nxt[g]
            while not self._is_guard(n):
                out.append(self.val[n])
                n = self.nxt[n]
            return out

        def body_of(rid: int) -> List[int]:
            """Body with single-use rules inlined (iterative: deeply nested
            single-use chains appear in highly repetitive corpora)."""
            if rid in bodies:
                return bodies[rid]
            # iterative post-order (two-phase stack) over the inline DAG
            stack = [(rid, 0)]
            opened = set()
            while stack:
                r, phase = stack.pop()
                if r in bodies:
                    continue
                if phase == 0:
                    if r in opened:
                        continue
                    opened.add(r)
                    stack.append((r, 1))
                    for v in raw_body(r):
                        if _is_rule(v) and _sym_rule(v) in single:
                            stack.append((_sym_rule(v), 0))
                else:
                    out: List[int] = []
                    for v in raw_body(r):
                        if _is_rule(v):
                            sub = _sym_rule(v)
                            if sub in single:
                                out.extend(bodies[sub])
                            else:
                                out.append(_rule_sym(sub))
                        else:
                            out.append(v)
                    bodies[r] = out
            return bodies[rid]

        renum = {rid: i for i, rid in enumerate(keep)}
        rules: List[np.ndarray] = []
        for rid in keep:
            b = body_of(rid)
            arr = np.array(
                [s if s >= 0 else num_terminals + renum[_sym_rule(s)] for s in b],
                dtype=np.int64,
            )
            rules.append(arr)
        return Grammar(num_terminals=num_terminals, rules=rules)


def compress(tokens: Sequence[int] | np.ndarray, num_terminals: int) -> Grammar:
    """Run Sequitur over a token stream; returns the inferred grammar.

    ``tokens`` must all be in ``[0, num_terminals)``.
    """
    sq = _Sequitur()
    root = sq.new_rule()
    assert root == 0
    for t in np.asarray(tokens, dtype=np.int64):
        v = int(t)
        if not (0 <= v < num_terminals):
            raise ValueError(f"token {v} outside [0, {num_terminals})")
        sq.append(root, v)
    return sq.export(num_terminals)


class IncrementalSequitur:
    """Live multi-file Sequitur state that absorbs appended files.

    Sequitur is an *online* algorithm: the grammar after consuming a stream
    depends only on the stream prefix, never on what follows.  Keeping the
    node store alive between files therefore makes multi-file compression
    incremental for free — appending file k+1 to a state that already
    consumed files 0..k performs exactly the operations a from-scratch run
    over all k+2 files would, so the resulting grammar is *identical*, not
    merely equivalent (tests/test_ingest.py holds this to bit-equality).

    Two properties make the append safe at file boundaries:

    * each file ends in a globally unique splitter terminal
      (``vocab_size + file_index``) that can never form a repeated digram,
      so no rule ever spans two files and appending cannot perturb digram
      uniqueness across the boundary;
    * rule symbols are stored as negative node values internally, so
      :meth:`export` can be re-invoked with a *larger* ``num_terminals``
      as files (and their splitter ids) accrue — export is read-only.
    """

    __slots__ = ("vocab_size", "n_files", "_sq")

    def __init__(self, vocab_size: int):
        if vocab_size < 1:
            raise ValueError(f"vocab_size must be >= 1, got {vocab_size}")
        self.vocab_size = int(vocab_size)
        self.n_files = 0
        self._sq = _Sequitur()
        root = self._sq.new_rule()
        assert root == 0

    @property
    def num_terminals(self) -> int:
        """Words ++ splitters: ``[0, vocab_size + n_files)``."""
        return self.vocab_size + self.n_files

    def append_file(self, tokens: Sequence[int] | np.ndarray) -> None:
        """Feed one file's word tokens, then its unique splitter.

        Word tokens must be in ``[0, vocab_size)`` — a word colliding with
        a splitter id would corrupt per-file ownership, so this validates
        strictly against the word range (empty files are fine: they
        contribute just their splitter)."""
        toks = np.asarray(tokens, dtype=np.int64)
        if toks.ndim != 1:
            raise ValueError(f"file must be a 1-D token array, "
                             f"got shape {toks.shape}")
        if toks.size and not (0 <= int(toks.min())
                              and int(toks.max()) < self.vocab_size):
            bad = toks[(toks < 0) | (toks >= self.vocab_size)][0]
            raise ValueError(f"token {int(bad)} outside word range "
                             f"[0, {self.vocab_size})")
        t0 = time.perf_counter()
        for t in toks:
            self._sq.append(0, int(t))
        self._sq.append(0, self.vocab_size + self.n_files)
        self.n_files += 1
        # ingest throughput: host-side Sequitur is the streaming tier's
        # bottleneck candidate, so appends are metered on the process
        # registry (wall time — compression runs outside any server clock)
        reg = global_registry()
        reg.counter("repro_ingest_files_total",
                    "files fed through IncrementalSequitur").inc()
        reg.counter("repro_ingest_tokens_total",
                    "word tokens fed through IncrementalSequitur"
                    ).inc(float(toks.size))
        reg.histogram("repro_ingest_append_seconds",
                      "wall seconds per IncrementalSequitur.append_file"
                      ).observe(time.perf_counter() - t0)

    def append_files(self, files: Sequence[np.ndarray]) -> None:
        for f in files:
            self.append_file(f)

    def export(self) -> Grammar:
        """Snapshot the current grammar (read-only; callable after every
        append — the live state is untouched)."""
        return self._sq.export(self.num_terminals)


def compress_files(
    files: Sequence[np.ndarray], vocab_size: int
) -> Tuple[Grammar, int]:
    """TADOC multi-file compression (paper §II-A).

    Inserts a *unique* splitter symbol after each file so rules never span
    file boundaries.  Terminal id space becomes
    ``[0, vocab_size)`` words ++ ``[vocab_size, vocab_size + n_files)``
    splitters.  Returns (grammar, num_files).

    Implemented on :class:`IncrementalSequitur` (one-shot build and
    streaming append are the same code path, so "incremental ==
    from-scratch" is structural, not coincidental).
    """
    inc = IncrementalSequitur(vocab_size)
    inc.append_files(files)
    return inc.export(), inc.n_files
