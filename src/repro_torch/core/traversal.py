"""G-TADOC DAG traversals of one corpus (the paper's §IV-B engine).

The port of the JAX package's ``core/traversal.py``.  The paper assigns one
thread per rule with a per-rule ``mask``, in/out-edge counters, and a host
loop that relaunches the kernel until a stop flag says the DAG is exhausted
(Algorithms 1 and 2).  Here a round is one gather + ``index_add_`` over all
edges, gated by the mask, and the host loop reads ``mask.any()`` once per
round (the JAX package's ``while_loop``).

Engines (every name ``top_down_weights`` accepts):

* ``frontier`` (also ``top_down`` / ``bottom_up``: direction only shapes
  the analytics, the weight pass is always top-down) — masked rounds over
  the COO edges;
* ``leveled`` / ``leveled_ell`` — the static level schedule, each edge
  touched once (the dense plan only pays off batched, so the scalar
  ``leveled_ell`` runs this too);
* ``frontier_ell`` — masked rounds over the N=1 dense ELL plan, one kernel
  launch a round (kernels/propagate_batched.py);
* ``frontier_fused`` — the whole frontier loop in one kernel launch
  (kernels/propagate_fused.py).

The engines are the batched engine's loops (core/batch.py) at N=1, over
one unpadded ``GrammarBatch`` of the grammar, with the JAX package's width
and plan-size gates.  That pack (and its ELL plan) is memoized by
``(id(ga), device)`` and evicted when the grammar dies, so a CPU plan never
serves a CUDA call.  Every count is integer-valued float32 below 2**24, so
all engines agree bit for bit.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels._common import resolve_device

from . import batch as _batch
from .batch import GrammarBatch
from .grammar import GrammarArrays, pow2_bucket as _pow2_bucket

TOP_DOWN_METHODS = ("frontier", "top_down", "bottom_up", "leveled",
                    "leveled_ell", "frontier_ell", "frontier_fused")
_ENGINE_CACHE: Dict = {}


def device_pack(ga: GrammarArrays, dev: torch.device) -> GrammarBatch:
    """``ga`` as an unpadded one-corpus pack on ``dev``: the batched
    engine's layout, so every field is ``[1, ...]`` and ``ell_plan()`` is
    the N=1 dense plan.  Memoized per (grammar, device) and evicted when
    ``ga`` dies (``id`` values are recycled, and a same-id key must never
    serve another grammar's pack); the pack holds ``ga`` through a weak
    proxy, since a strong reference would keep both alive for good."""
    key = ("pack", id(ga), str(dev))
    gb = _ENGINE_CACHE.get(key)
    if gb is None:
        gb = GrammarBatch.build([ga], bucket=False, device=dev)
        gb = dataclasses.replace(gb, gas=(weakref.proxy(ga),))
        _ENGINE_CACHE[key] = gb
        weakref.finalize(ga, _ENGINE_CACHE.pop, key, None)
    return gb


# ----------------------------------------------------------------------- #
# Top-down: rule weights (occurrence counts of each rule in the corpus).   #
# ----------------------------------------------------------------------- #
def _top_down_frontier(ga: GrammarArrays, dev: torch.device
                       ) -> Tuple[torch.Tensor, int]:
    """Masked top-down rounds (paper Algorithm 1). Returns (weights,
    rounds)."""
    gb = device_pack(ga, dev)
    w, rounds = _batch._frontier_weights(gb.edge_parent, gb.edge_child,
                                         gb.edge_freq, gb.edge_valid,
                                         gb.in_deg)
    return w[0], rounds


def _ell_ok(ga: GrammarArrays) -> bool:
    """The dense plan's width and absolute-size gates (the JAX package's):
    skewed grammars take the COO frontier instead."""
    K = _pow2_bucket(int(ga.in_deg.max(initial=0)))
    return not (K > kops.ELL_BATCH_MAX_WIDTH
                or ga.num_rules * K > kops.ELL_PLAN_MAX_ENTRIES)


def _top_down_frontier_ell(ga: GrammarArrays,
                           dev: torch.device) -> torch.Tensor:
    """Masked frontier rounds over the N=1 ELL plan: the batched engine's
    loop, one gather kernel a round with no scatter."""
    if not _ell_ok(ga):
        return _top_down_frontier(ga, dev)[0]
    gb = device_pack(ga, dev)
    src, freq, _, _ = gb.ell_plan()
    w, _ = _batch._frontier_ell_weights(src, freq, gb.in_deg)
    return w[0]


def _top_down_frontier_fused(ga: GrammarArrays,
                             dev: torch.device) -> torch.Tensor:
    """The whole frontier loop in one launch over the N=1 ELL plan;
    ``ga.num_levels`` is the exact round bound.  Plans the dense layout
    refuses take the COO frontier; rule counts the fused gate refuses take
    the per-round ELL path."""
    if not _ell_ok(ga):
        return _top_down_frontier(ga, dev)[0]
    if not kops.ell_fused_use_kernel(ga.num_rules):
        return _top_down_frontier_ell(ga, dev)
    gb = device_pack(ga, dev)
    src, freq, _, num_levels = gb.ell_plan()
    return _batch._frontier_fused_weights(src, freq, gb.in_deg,
                                          num_levels)[0]


def _top_down_leveled(ga: GrammarArrays, dev: torch.device) -> torch.Tensor:
    """Leveled top-down: each edge processed exactly once (static
    schedule)."""
    gb = device_pack(ga, dev)
    return _batch._leveled_weights(gb.lv_parent, gb.lv_child, gb.lv_freq,
                                   gb.lv_slices, ga.num_rules)[0]


def top_down_weights(ga: GrammarArrays, method: str = "frontier",
                     device=None) -> torch.Tensor:
    """weights[r] == number of times rule r's expansion occurs in the
    corpus.  [R] float32 on ``device`` (the card unless ``"cpu"``)."""
    if method not in TOP_DOWN_METHODS:
        raise ValueError(f"unknown traversal method {method!r}")
    dev = resolve_device(device)
    if method in ("frontier", "top_down", "bottom_up"):
        return _top_down_frontier(ga, dev)[0]
    if method in ("leveled", "leveled_ell"):
        return _top_down_leveled(ga, dev)
    if method == "frontier_ell":
        return _top_down_frontier_ell(ga, dev)
    return _top_down_frontier_fused(ga, dev)


def resolve_single_method(ga: GrammarArrays, method: str,
                          per_file: bool = False) -> str:
    """The single-corpus engine's routing for ``method``: the N=1 analogue
    of ``batch.resolve_batch_method``.  Scalar ``leveled_ell`` always runs
    the N=1 leveled replay; everything else goes through the shared shape
    gates."""
    if method not in _batch.ELL_METHODS:
        return method
    if not per_file and method == "leveled_ell":
        return "leveled"
    K = _pow2_bucket(int(ga.in_deg.max(initial=0)))
    return _batch.resolve_traversal_method(
        method, n=1, rows=ga.num_rules, k=K, edges=ga.num_edges,
        per_file=per_file, f=ga.num_files)


# ----------------------------------------------------------------------- #
# Per-file top-down: weights of each rule w.r.t. each file.                #
# ----------------------------------------------------------------------- #
def per_file_weights(ga: GrammarArrays, method: str = "frontier",
                     device=None) -> torch.Tensor:
    """Wf[r, f] == occurrences of rule r inside file f. Shape [R, F].

    The root's processing is replaced by per-file initialization from the
    root-segment edge lists (splitters partition the root body), so edges
    out of the root are consumed by the init and masked out of the rounds.
    The ELL methods run the vector-payload rounds over the N=1 plan
    (kernels/propagate_vector.py) when the plan passes the shape gates, and
    their segment_sum bases otherwise; ``frontier_fused`` runs its
    per-round ELL base (the fused kernel is scalar-payload)."""
    if method not in TOP_DOWN_METHODS:
        raise ValueError(f"unknown traversal method {method!r}")
    dev = resolve_device(device)
    if method in _batch.ELL_METHODS:
        method = resolve_single_method(ga, method, per_file=True)
    F = ga.num_files
    if F == 0:
        # no file to attribute a rule to (the pack's per-file init would
        # scatter its padding entry out of an empty [R, 0] table)
        return torch.zeros((ga.num_rules, 0), dtype=torch.float32,
                           device=dev)
    gb = device_pack(ga, dev)
    fc, ff, fq = gb.fedge_child, gb.fedge_file, gb.fedge_freq
    if method in ("frontier_ell", "leveled_ell"):
        src, freq, level, num_levels = gb.ell_plan()
        if method == "frontier_ell":
            W, _ = _batch._per_file_frontier_ell_weights(
                src, freq, gb.in_deg, gb.root_seen, fc, ff, fq, F)
            return W[0]
        return _batch._per_file_leveled_ell_weights(
            src, freq, level, fc, ff, fq, num_levels, F)[0]
    if method == "leveled":
        return _batch._per_file_leveled_weights(
            gb.lv_parent, gb.lv_child, gb.lv_freq, fc, ff, fq, gb.lv_slices,
            ga.num_rules, F)[0]
    W, _ = _batch._per_file_frontier_weights(
        gb.edge_parent, gb.edge_child, gb.edge_freq, gb.edge_valid,
        gb.in_deg, gb.root_seen, fc, ff, fq, F)
    return W[0]


# ----------------------------------------------------------------------- #
# Bottom-up: local word tables merged leaves -> root (paper Algorithm 2).  #
# ----------------------------------------------------------------------- #
def _edges(ga: GrammarArrays, gb: GrammarBatch):
    """The pack's real edges ``(parent, child, freq)`` as [E] views, and
    the [R] out-degrees on the pack's device."""
    E = ga.num_edges
    out_deg = torch.as_tensor(ga.out_deg.astype(np.int32), device=gb.device)
    return (gb.edge_parent[0, :E], gb.edge_child[0, :E],
            gb.edge_freq[0, :E], out_deg)


def bottom_up_tables(ga: GrammarArrays, device=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense local tables C[r, v] = word counts of rule r's full expansion,
    plus the merged global result (the paper's ``reduceResultKernel``:
    root's own words + the root's children scaled by their frequencies).

    Dense [R, V] — for validation and small/medium corpora; the production
    word count is top-down weights + weighted bincount (the same numbers in
    O(R+T) memory).  Each round gathers only the rows of edges whose child
    is active (inactive edges add exactly zero), and accumulates into C in
    place: a rule that pushes this round has all its children done, so no
    row is both read and written in one round."""
    dev = resolve_device(device)
    gb = device_pack(ga, dev)
    R, V = ga.num_rules, ga.vocab_size
    ep, ec, ef, out_deg = _edges(ga, gb)
    C = torch.zeros(R * V, dtype=torch.float32, device=dev)
    C.index_add_(0, gb.tw_rule[0] * V + gb.tw_word[0], gb.tw_cnt[0])
    C = C.view(R, V)
    cur_out = torch.zeros_like(out_deg)
    mask = out_deg == 0                        # leaves
    ever = mask.clone()
    nonroot = ep != 0
    while bool(mask.any()):
        # Edges whose *child* is active push tables upward.  The paper does
        # NOT accumulate into the root ("the root contains file
        # information", §IV-B bottom-up): the root merge happens below.
        active_e = mask[ec] & nonroot
        idx = active_e.nonzero().squeeze(1)
        gathered = torch.index_select(C, 0, ec[idx])
        gathered.mul_(ef[idx, None])
        C.index_add_(0, ep[idx], gathered)
        del gathered
        cur_out = cur_out + torch.zeros_like(cur_out).index_add_(
            0, ep, active_e.to(torch.int32))
        mask = (cur_out == out_deg) & ~ever
        ever = ever | mask
    # reduceResultKernel: root own words + direct children x root freqs
    root_e = torch.as_tensor(np.flatnonzero(ga.edge_parent == 0),
                             device=dev)
    lvl2 = torch.index_select(C, 0, ec[root_e])
    lvl2.mul_(ef[root_e, None])
    return C, C[0] + lvl2.sum(dim=0)


def bottom_up_bounds(ga: GrammarArrays, device=None) -> torch.Tensor:
    """The paper's ``genLocTblBoundKernel``: upper bound on each rule's
    local table size — own unique words + sum of children's bounds (merging
    can only dedup).  Used by the memory planner (core/memory.py).  [R]
    float32; a bound never exceeds the rule's expansion length, so the
    float32 sums are exact."""
    dev = resolve_device(device)
    R = ga.num_rules
    ep, ec, _, out_deg = _edges(ga, device_pack(ga, dev))
    bound = torch.as_tensor(
        np.bincount(ga.tw_rule, minlength=R).astype(np.float32), device=dev)
    cur_out = torch.zeros_like(out_deg)
    mask = out_deg == 0
    ever = mask.clone()
    while bool(mask.any()):
        active_e = mask[ec]
        contrib = torch.where(active_e, bound[ec], 0.0)
        bound = bound + torch.zeros_like(bound).index_add_(0, ep, contrib)
        cur_out = cur_out + torch.zeros_like(cur_out).index_add_(
            0, ep, active_e.to(torch.int32))
        mask = (cur_out == out_deg) & ~ever
        ever = ever | mask
    return bound


def traversal_rounds(ga: GrammarArrays, device=None) -> int:
    """Number of masked rounds the frontier engine needs (== DAG
    depth + 1)."""
    return _top_down_frontier(ga, resolve_device(device))[1]
