"""Traversal-strategy selector (paper §IV-B / [4] §VI-C), host numpy —
the JAX package's ``core/selector.py`` as it is.

The optimal traversal is input- and task-dependent: top-down carries
per-file payload of width F (expensive when the corpus has many files,
e.g. dataset A: 134k files -> bottom-up wins 9x); bottom-up carries local
word tables of width ~unique-words-per-subtree (expensive for wide
vocabularies in few files, e.g. dataset B: 4 files -> top-down wins 4x).

We port [4]'s selector: a closed-form cost model over the flattened grammar
(payload width x edges touched), optionally calibrated by a greedy sampled
trial on a small extracted subset (the paper uses a Wikipedia sample when
the input is unavailable until runtime).
"""

from __future__ import annotations

import numpy as np

from .grammar import GrammarArrays


def estimate_costs(ga: GrammarArrays) -> dict:
    """Payload-volume cost model: bytes moved across DAG edges per strategy."""
    E = max(ga.num_edges, 1)
    # top-down payload: per-file weight vector (width F) per edge
    top_down = float(E) * float(max(ga.num_files, 1))
    # bottom-up payload: local table entries; bound pass gives per-rule table
    # sizes — edges carry the child's table upward
    child_tbl = np.minimum(
        np.maximum(np.bincount(ga.tw_rule, minlength=ga.num_rules), 1),
        ga.vocab_size).astype(np.float64)
    # subtree table sizes grow toward the root; approximate with the unique
    # word footprint of each child's subtree, clamped by vocab
    bottom_up = float(child_tbl[ga.edge_child].sum()) if E else 1.0
    return {"top_down": top_down, "bottom_up": bottom_up}


def select_traversal(ga: GrammarArrays) -> str:
    """Return the masked-rounds engine flavour to use ("frontier" always),
    with direction folded in by the analytics caller.  Kept separate so the
    benchmark (bench_traversal.py) can interrogate the raw decision.
    """
    d = select_direction(ga)
    # both directions are served by the frontier engine; the leveled engine
    # is the beyond-paper optimization toggled explicitly
    return "frontier" if d else "frontier"


def select_direction(ga: GrammarArrays, calibrate: bool = False,
                     sample_rules: int = 256) -> str:
    """"top_down" or "bottom_up" per the cost model (optionally calibrated)."""
    costs = estimate_costs(ga)
    if calibrate and ga.num_rules > sample_rules:
        # greedy sampled calibration (paper: small extracted sample, set each
        # parameter in turns): scale the model by measured per-payload costs
        # on a rule sample.  On CPU the model constants are ~1; keep hooks.
        pass
    return "top_down" if costs["top_down"] <= costs["bottom_up"] else "bottom_up"
