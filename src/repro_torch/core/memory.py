"""Memory-pool planning (paper §IV-C), host numpy.

The port of the JAX package's ``core/memory.py``.  G-TADOC manages its own
GPU memory pool because (1) required sizes are unknown until runtime and
(2) per-thread malloc is slow.  Sizes are derived by a light-weight
bound-propagation pass (``genLocTblBoundKernel``, run on the device by
``traversal.bottom_up_bounds``) and the pool is carved once:
:class:`ArenaPlan` assigns every rule a [offset, offset+size) slice of one
flat buffer, from the per-rule table bounds and the head/tail bounds of
paper Equation 1.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .grammar import GrammarArrays
from .traversal import bottom_up_bounds


@dataclass(frozen=True)
class ArenaPlan:
    """One flat buffer; rule r owns [offsets[r], offsets[r] + sizes[r])."""
    sizes: np.ndarray     # [R] int64
    offsets: np.ndarray   # [R] int64
    total: int

    def slice_of(self, r: int) -> slice:
        return slice(int(self.offsets[r]), int(self.offsets[r] + self.sizes[r]))


def head_tail_upper_limit(ga: GrammarArrays, l: int) -> np.ndarray:
    """Paper Equation (1): per-rule junction-stream upper bound.

        upperLimit = wordSize + (l-1) * subRuleSize - (l-1)

    where wordSize counts terminal symbols in the body and subRuleSize the
    sub-rule occurrences.  (Our junction stream uses 2(l-1)+1 slots per
    sub-rule; :func:`stream_upper_limit` is the bound that dominates it.)
    """
    R = ga.num_rules
    word_size = np.zeros(R, np.int64)
    sub_size = np.zeros(R, np.int64)
    nt = ga.num_terminals
    for r in range(R):
        b = ga.rule_body(r)
        word_size[r] = int((b < nt).sum())
        sub_size[r] = int((b >= nt).sum())
    return word_size + (l - 1) * sub_size - (l - 1)


def stream_upper_limit(ga: GrammarArrays, l: int) -> np.ndarray:
    """Exact-dominating bound for our junction stream layout."""
    R = ga.num_rules
    nt = ga.num_terminals
    out = np.zeros(R, np.int64)
    for r in range(R):
        b = ga.rule_body(r)
        n_term = int((b < nt).sum())
        n_sub = int((b >= nt).sum())
        out[r] = n_term + (2 * (l - 1) + 1) * n_sub
    return out


def plan_local_tables(ga: GrammarArrays, device=None) -> ArenaPlan:
    """Arena for per-rule local word tables (bottom-up analytics).

    Sizes come from the paper's bound pass (own unique words + children's
    bounds, merging can only dedup) on ``device``, clamped by the
    vocabulary size.
    """
    bounds = bottom_up_bounds(ga, device).cpu().numpy().astype(np.int64)
    sizes = np.minimum(bounds, ga.vocab_size)
    offsets = np.zeros_like(sizes)
    np.cumsum(sizes[:-1], out=offsets[1:])
    return ArenaPlan(sizes=sizes, offsets=offsets, total=int(sizes.sum()))


def plan_streams(ga: GrammarArrays, l: int) -> ArenaPlan:
    """Arena for per-rule junction streams (sequence support)."""
    sizes = stream_upper_limit(ga, l)
    offsets = np.zeros_like(sizes)
    np.cumsum(sizes[:-1], out=offsets[1:])
    return ArenaPlan(sizes=sizes, offsets=offsets, total=int(sizes.sum()))
