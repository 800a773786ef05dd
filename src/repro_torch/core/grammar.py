"""Flat (CSR/ELL) grammar arrays — the DAG that TADOC analytics traverse.

The paper (§II-A) views the Sequitur CFG as a DAG: nodes are rules, an edge
``parent -> child`` exists when ``child`` appears in ``parent``'s body, with
an edge *frequency* (occurrence count).  All G-TADOC phases operate on this
DAG.  On the device the DAG is laid out as dense, statically-shaped
arrays; this module performs that layout (host side, numpy) once per
corpus, exactly as the JAX package does:

  * rule bodies as CSR (``body`` / ``body_offsets``);
  * unique parent->child edges with frequencies (COO, sorted by child and by
    parent — the two traversal directions);
  * per-rule unique-word counts (the rules' *local word tables* of paper
    §IV-C, pre-planned instead of hashed);
  * per-file slices of the root (TADOC's file splitters partition the root
    body; per-file analytics need root-level ownership);
  * expansion lengths and topological levels (used by the memory planner,
    the sequence-support layout, and the *leveled* traversal variant).

Symbol encoding inside bodies: ``0..V-1`` words, ``V..V+F-1`` file
splitters, ``V+F+r`` rule ``r``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from .sequitur import Grammar


class StaleGrammarError(RuntimeError):
    """A derived artifact (memoized weights, a pack, a plan) was produced
    at an earlier corpus epoch than the grammar it is about to serve — the
    ingest tier's guard against serving a mutated corpus from stale caches
    (raised by ``data.store.CompressedCorpus.check_epoch``)."""


def pow2_bucket(x: int) -> int:
    """Smallest power of two >= max(x, 1): the ELL plan-width bucketing
    (shared with core/batch.py so batch packs agree on K; semantically
    identical to kernels._common.round_up_pow2 — kept separate only so the
    host-planning layer does not import the kernels package)."""
    return 1 << max(0, (max(int(x), 1) - 1).bit_length())


@dataclass(frozen=True)
class GrammarArrays:
    """Static flat layout of a TADOC grammar (all numpy, host-resident)."""

    vocab_size: int          # V: word terminals
    num_files: int           # F: splitter terminals V..V+F-1
    num_rules: int           # R (root == rule 0)

    body: np.ndarray         # [E_body] int32 symbols (encoding above)
    body_offsets: np.ndarray  # [R+1] int32

    # unique parent->child edges, COO; sorted by (parent, child)
    edge_parent: np.ndarray  # [E] int32
    edge_child: np.ndarray   # [E] int32
    edge_freq: np.ndarray    # [E] int32

    in_deg: np.ndarray       # [R] int32 unique-parent count (root: 0)
    out_deg: np.ndarray      # [R] int32 unique-child count

    # per-rule unique-word counts ("local word tables"), sorted by rule
    tw_rule: np.ndarray      # [T] int32
    tw_word: np.ndarray      # [T] int32
    tw_cnt: np.ndarray       # [T] int32

    # per-file ownership at the root (segments between splitters)
    fedge_file: np.ndarray   # [Ef] int32
    fedge_child: np.ndarray  # [Ef] int32
    fedge_freq: np.ndarray   # [Ef] int32
    fword_file: np.ndarray   # [Tf] int32
    fword_word: np.ndarray   # [Tf] int32
    fword_cnt: np.ndarray    # [Tf] int32

    exp_len: np.ndarray      # [R] int64 expansion length in terminals
    level: np.ndarray        # [R] int32 longest-path depth from root
    num_levels: int

    # ------------------------------------------------------------------ --
    @classmethod
    def from_numpy(cls, fields: Dict[str, object]) -> "GrammarArrays":
        """Build from a ``{field name: value}`` mapping of numpy arrays and
        ints — the layout's fields carried across from another producer
        of the same grammar (e.g. the JAX package's ``GrammarArrays``), so
        both engines can be fed the identical grammar."""
        names = [f.name for f in dataclasses.fields(cls)]
        missing = [n for n in names if n not in fields]
        if missing:
            raise ValueError(f"GrammarArrays fields missing: {missing}")
        vals = {}
        for n in names:
            v = fields[n]
            vals[n] = (int(v) if n in ("vocab_size", "num_files",
                                       "num_rules", "num_levels")
                       else np.array(v, copy=True))
        return cls(**vals)

    @property
    def num_terminals(self) -> int:
        return self.vocab_size + self.num_files

    @property
    def num_edges(self) -> int:
        return int(self.edge_parent.shape[0])

    def rule_body(self, r: int) -> np.ndarray:
        return self.body[self.body_offsets[r]: self.body_offsets[r + 1]]

    # ------------------------------------------------------- ELL layout --
    def in_edges_ell_dense(self, k: int | None = None
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """Dense per-rule in-edge plan: row r lists rule r's in-edges.

        Returns ``(src, freq)`` shaped ``[R, K]`` with K the max in-degree
        rounded up to a power of two (>= 1; pass ``k`` to pad to a shared
        batch width).  Padding entries are src=0 / freq=0: the root has no
        in-edges and ``freq == 0`` gates padding out of every kernel.

        There is no row splitting — the row index IS the destination rule,
        so a propagation round is a pure gather + row-sum with no scatter
        (kernels/propagate_batched.py).  The paper's 16x thread-group
        threshold for oversized rules (§IV-B) becomes the width gate in the
        traversal engines: grammars whose max in-degree exceeds
        ``kernels.ops.ELL_BATCH_MAX_WIDTH`` fall back to segment_sum
        instead of splitting rows.
        """
        R = self.num_rules
        deg = self.in_deg.astype(np.int64)
        kmax = int(deg.max(initial=0))
        if k is None:
            k = pow2_bucket(kmax)
        elif k < kmax:
            raise ValueError(f"k={k} narrower than max in-degree {kmax}")
        src = np.zeros((R, k), np.int32)
        freq = np.zeros((R, k), np.float32)
        if self.num_edges:
            order = np.argsort(self.edge_child, kind="stable")
            child = self.edge_child[order]
            starts = np.zeros(R + 1, np.int64)
            np.cumsum(deg, out=starts[1:])
            col = np.arange(self.num_edges) - starts[child]
            src[child, col] = self.edge_parent[order]
            freq[child, col] = self.edge_freq[order]
        return src, freq

    # ---------------------------------------------------- level buckets --
    def level_edge_slices(self) -> List[Tuple[int, int]]:
        """Edge ranges grouped by parent level, for the leveled traversal.

        Edges sorted by ``level[parent]``; returns per-level (start, end)
        offsets into that ordering.  Host-static: lets the optimized
        traversal touch each edge exactly once (vs. once per round in the
        paper-faithful masked variant).
        """
        lv = self.level[self.edge_parent]
        order = np.argsort(lv, kind="stable")
        lv_sorted = lv[order]
        slices = []
        for l in range(self.num_levels):
            s = int(np.searchsorted(lv_sorted, l, "left"))
            e = int(np.searchsorted(lv_sorted, l, "right"))
            slices.append((s, e))
        return slices, order

    def compression_ratio(self) -> float:
        """Terminals in the corpus stream per grammar body symbol."""
        total_terminals = float(self.exp_len[0])
        grammar_syms = float(self.body.shape[0])
        return total_terminals / max(grammar_syms, 1.0)


def flatten(g: Grammar, vocab_size: int, num_files: int) -> GrammarArrays:
    """Lay out an inferred grammar as flat arrays (one-time, host side)."""
    R = g.num_rules
    nt = g.num_terminals
    assert nt == vocab_size + num_files, (nt, vocab_size, num_files)

    body = np.concatenate([r for r in g.rules]) if R else np.zeros(0, np.int64)
    body_offsets = np.zeros(R + 1, np.int64)
    np.cumsum([len(r) for r in g.rules], out=body_offsets[1:])

    # unique parent->child edges with frequencies
    ep: List[np.ndarray] = []
    ec: List[np.ndarray] = []
    ef: List[np.ndarray] = []
    tw_r: List[np.ndarray] = []
    tw_w: List[np.ndarray] = []
    tw_c: List[np.ndarray] = []
    for r in range(R):
        b = g.rules[r]
        subs = b[b >= nt] - nt
        if len(subs):
            u, c = np.unique(subs, return_counts=True)
            ep.append(np.full(len(u), r))
            ec.append(u)
            ef.append(c)
        words = b[b < vocab_size]
        if len(words):
            u, c = np.unique(words, return_counts=True)
            tw_r.append(np.full(len(u), r))
            tw_w.append(u)
            tw_c.append(c)

    def _cat(xs, dtype=np.int32):
        return (np.concatenate(xs).astype(dtype) if xs else np.zeros(0, dtype))

    edge_parent = _cat(ep)
    edge_child = _cat(ec)
    edge_freq = _cat(ef)
    tw_rule, tw_word, tw_cnt = _cat(tw_r), _cat(tw_w), _cat(tw_c)

    in_deg = np.bincount(edge_child, minlength=R).astype(np.int32)
    out_deg = np.bincount(edge_parent, minlength=R).astype(np.int32)

    # per-file root segments
    root = g.rules[0]
    fe_f: List[int] = []
    fe_c: List[int] = []
    fe_q: List[int] = []
    fw_f: List[int] = []
    fw_w: List[int] = []
    fw_c: List[int] = []
    cur = 0
    seg_subs: Dict[int, int] = {}
    seg_words: Dict[int, int] = {}

    def _flush(fid: int) -> None:
        for k, v in sorted(seg_subs.items()):
            fe_f.append(fid)
            fe_c.append(k)
            fe_q.append(v)
        for k, v in sorted(seg_words.items()):
            fw_f.append(fid)
            fw_w.append(k)
            fw_c.append(v)
        seg_subs.clear()
        seg_words.clear()

    for s in root:
        s = int(s)
        if vocab_size <= s < nt:          # splitter == end of file `cur`
            _flush(cur)
            cur += 1
        elif s >= nt:
            seg_subs[s - nt] = seg_subs.get(s - nt, 0) + 1
        else:
            seg_words[s] = seg_words.get(s, 0) + 1
    if seg_subs or seg_words:             # trailing segment w/o splitter
        _flush(min(cur, max(num_files - 1, 0)))

    # expansion lengths (bottom-up over reverse topo order)
    exp_len = np.zeros(R, np.int64)
    level = np.zeros(R, np.int32)
    # topo order: repeated relaxation is O(R * depth); do DFS instead
    children = {r: g.rules[r][g.rules[r] >= nt] - nt for r in range(R)}
    state = np.zeros(R, np.int8)  # 0 new, 1 open, 2 done
    order: List[int] = []
    for start in range(R):
        if state[start]:
            continue
        stack = [(start, 0)]
        while stack:
            node, phase = stack.pop()
            if phase == 0:
                if state[node]:
                    continue
                state[node] = 1
                stack.append((node, 1))
                for ch in children[node]:
                    if not state[ch]:
                        stack.append((int(ch), 0))
            else:
                state[node] = 2
                order.append(node)
    for r in order:  # children complete before parents
        b = g.rules[r]
        n_term = int((b < nt).sum())
        sub = b[b >= nt] - nt
        exp_len[r] = n_term + int(exp_len[sub].sum())
    # levels: longest path from root, forward over reverse topo order
    for r in reversed(order):
        for ch in children[r]:
            level[ch] = max(level[ch], level[r] + 1)
    num_levels = int(level.max(initial=0)) + 1

    return GrammarArrays(
        vocab_size=vocab_size,
        num_files=num_files,
        num_rules=R,
        body=body.astype(np.int32),
        body_offsets=body_offsets.astype(np.int64),
        edge_parent=edge_parent, edge_child=edge_child, edge_freq=edge_freq,
        in_deg=in_deg, out_deg=out_deg,
        tw_rule=tw_rule, tw_word=tw_word, tw_cnt=tw_cnt,
        fedge_file=np.array(fe_f, np.int32), fedge_child=np.array(fe_c, np.int32),
        fedge_freq=np.array(fe_q, np.int32),
        fword_file=np.array(fw_f, np.int32), fword_word=np.array(fw_w, np.int32),
        fword_cnt=np.array(fw_c, np.int32),
        exp_len=exp_len, level=level, num_levels=num_levels,
    )


# --------------------------------------------------------- random access --
def expand_range(ga: GrammarArrays, start: int, length: int) -> np.ndarray:
    """Expand ``length`` terminals starting at global offset ``start``
    without decompressing anything outside the window (paper [3]'s random
    access, host side — the store's ``window`` reads use it).
    """
    out = np.empty(length, np.int64)
    n_out = 0
    # iterative descent: stack of (rule, body_idx, remaining-skip)
    skip = int(start)
    stack: List[Tuple[int, int]] = [(0, 0)]
    while stack and n_out < length:
        r, i = stack.pop()
        b = ga.rule_body(r)
        while i < len(b) and n_out < length:
            s = int(b[i])
            i += 1
            if s < ga.num_terminals:
                if skip > 0:
                    skip -= 1
                else:
                    out[n_out] = s
                    n_out += 1
            else:
                sub = s - ga.num_terminals
                l = int(ga.exp_len[sub])
                if skip >= l:
                    skip -= l
                else:
                    stack.append((r, i))
                    stack.append((sub, 0))
                    break
    return out[:n_out]
