"""Sequence support (paper §IV-D): the host-side static plans.

The JAX package's ``core/sequence.py`` counts l-grams directly on the
grammar: each rule stores the head/tail buffers of its expansion (the first
and last ``l-1`` tokens), resolved in masked rounds, and every window that
crosses a junction between adjacent body symbols is counted by the rule
that owns the junction, scaled by the rule's top-down weight.

The static gather layouts are computed once per grammar on the host with
numpy — ``plan_head_tail`` (how each head/tail slot is filled) and
``plan_stream`` (the junction stream and its window index) — copied line
for line so both packages plan identically.  The device phases of one
corpus (``resolve_head_tail``, ``sequence_count``) run the packed engine's
batched phases (core/batch.py) at N=1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.kernels._common import resolve_device

from .grammar import GrammarArrays

_GAP = -1
_BREAK = -2

_K_LIT, _K_HEAD, _K_TAIL, _K_GAP, _K_BREAK = 0, 1, 2, 3, 4


# ----------------------------------------------------------------------- #
# Host-side static planning                                                #
# ----------------------------------------------------------------------- #
@dataclass(frozen=True)
class HeadTailPlan:
    """Static gather plan for resolving head/tail buffers on device."""
    h: int
    # head gather: head[r, t] = lit[r,t] if is_lit else head_src's buffer
    head_is_lit: np.ndarray   # [R, h] bool
    head_lit: np.ndarray      # [R, h] int32 (token or -1 pad)
    head_src: np.ndarray      # [R, h] int32 source rule
    head_idx: np.ndarray      # [R, h] int32 index into source head buffer
    head_dep: np.ndarray      # [R, Kd] int32 rules that must resolve first (pad -1)
    tail_is_lit: np.ndarray
    tail_lit: np.ndarray
    tail_src: np.ndarray
    tail_idx: np.ndarray
    tail_dep: np.ndarray
    head_len: np.ndarray      # [R] int32 = min(len, h)
    tail_len: np.ndarray


def plan_head_tail(ga: GrammarArrays, l: int) -> HeadTailPlan:
    h = l - 1
    R = ga.num_rules
    nt = ga.num_terminals
    lens = ga.exp_len

    head_is_lit = np.zeros((R, h), bool)
    head_lit = np.full((R, h), -1, np.int32)
    head_src = np.zeros((R, h), np.int32)
    head_idx = np.zeros((R, h), np.int32)
    tail_is_lit = np.zeros((R, h), bool)
    tail_lit = np.full((R, h), -1, np.int32)
    tail_src = np.zeros((R, h), np.int32)
    tail_idx = np.zeros((R, h), np.int32)
    head_dep: List[List[int]] = [[] for _ in range(R)]
    tail_dep: List[List[int]] = [[] for _ in range(R)]

    for r in range(R):
        b = ga.rule_body(r)
        # ---- head: walk prefix until h tokens are covered
        off = 0
        for s in b:
            if off >= h:
                break
            s = int(s)
            if s < nt:
                head_is_lit[r, off] = True
                head_lit[r, off] = s
                off += 1
            else:
                sub = s - nt
                c = int(min(lens[sub], h - off))
                head_is_lit[r, off: off + c] = False
                head_src[r, off: off + c] = sub
                head_idx[r, off: off + c] = np.arange(c)
                head_dep[r].append(sub)
                off += c
        # ---- tail: walk suffix backwards
        off = 0  # tokens collected from the end
        for s in b[::-1]:
            if off >= h:
                break
            s = int(s)
            if s < nt:
                tail_is_lit[r, h - 1 - off] = True
                tail_lit[r, h - 1 - off] = s
                off += 1
            else:
                sub = s - nt
                tl = int(min(lens[sub], h))      # sub's tail buffer length
                c = int(min(lens[sub], h - off))
                # we need the last c tokens of sub == tail[sub][tl-c : tl]
                # (sub tail buffer is left-aligned with tl valid entries)
                dst = slice(h - off - c, h - off)
                tail_is_lit[r, dst] = False
                tail_src[r, dst] = sub
                tail_idx[r, dst] = np.arange(tl - c, tl)
                tail_dep[r].append(sub)
                off += c
        # tail stored left-aligned: shift so valid tokens occupy [0, tlen)
        tlen = int(min(lens[r], h))
        shift = h - off
        if shift > 0 and off > 0:
            tail_is_lit[r, :off] = tail_is_lit[r, shift: shift + off]
            tail_lit[r, :off] = tail_lit[r, shift: shift + off]
            tail_src[r, :off] = tail_src[r, shift: shift + off]
            tail_idx[r, :off] = tail_idx[r, shift: shift + off]
            tail_is_lit[r, off:] = False
            tail_lit[r, off:] = -1

    Kd = max(1, max((len(d) for d in head_dep + tail_dep), default=1))

    def _pad_dep(dep):
        out = np.full((R, Kd), -1, np.int32)
        for r, d in enumerate(dep):
            u = sorted(set(d))[:Kd]
            out[r, :len(u)] = u
        return out

    return HeadTailPlan(
        h=h,
        head_is_lit=head_is_lit, head_lit=head_lit,
        head_src=head_src, head_idx=head_idx, head_dep=_pad_dep(head_dep),
        tail_is_lit=tail_is_lit, tail_lit=tail_lit,
        tail_src=tail_src, tail_idx=tail_idx, tail_dep=_pad_dep(tail_dep),
        head_len=np.minimum(lens, h).astype(np.int32),
        tail_len=np.minimum(lens, h).astype(np.int32),
    )


@dataclass(frozen=True)
class StreamPlan:
    """Static junction-stream layout + window index for one grammar."""
    l: int
    st_kind: np.ndarray    # [S] int8
    st_lit: np.ndarray     # [S] int32
    st_src: np.ndarray     # [S] int32
    st_idx: np.ndarray     # [S] int32
    st_symj: np.ndarray    # [S] int32 body-symbol ordinal within owner rule
    win_start: np.ndarray  # [Nw] int32 stream positions where a window fits
    win_rule: np.ndarray   # [Nw] int32 owner rule of each window


def plan_stream(ga: GrammarArrays, l: int) -> StreamPlan:
    h = l - 1
    nt = ga.num_terminals
    V = ga.vocab_size
    lens = ga.exp_len
    kinds: List[int] = []
    lits: List[int] = []
    srcs: List[int] = []
    idxs: List[int] = []
    symjs: List[int] = []
    win_start: List[int] = []
    win_rule: List[int] = []

    for r in range(ga.num_rules):
        b = ga.rule_body(r)
        seg_start = len(kinds)
        for j, s in enumerate(b):
            s = int(s)
            if s < V:                                   # word literal
                kinds.append(_K_LIT); lits.append(s)
                srcs.append(0); idxs.append(0); symjs.append(j)
            elif s < nt:                                # file splitter
                kinds.append(_K_BREAK); lits.append(_BREAK)
                srcs.append(0); idxs.append(0); symjs.append(j)
            else:
                sub = s - nt
                L = int(lens[sub])
                if L <= 2 * h:
                    # full expansion reconstructible from head ++ tail tail-end
                    hl = int(min(L, h))
                    for t in range(hl):
                        kinds.append(_K_HEAD); lits.append(-1)
                        srcs.append(sub); idxs.append(t); symjs.append(j)
                    rem = L - hl
                    tl = int(min(L, h))
                    for t in range(tl - rem, tl):
                        kinds.append(_K_TAIL); lits.append(-1)
                        srcs.append(sub); idxs.append(t); symjs.append(j)
                else:
                    for t in range(h):
                        kinds.append(_K_HEAD); lits.append(-1)
                        srcs.append(sub); idxs.append(t); symjs.append(j)
                    kinds.append(_K_GAP); lits.append(_GAP)
                    srcs.append(0); idxs.append(0); symjs.append(j)
                    for t in range(h):
                        kinds.append(_K_TAIL); lits.append(-1)
                        srcs.append(sub); idxs.append(t); symjs.append(j)
        # windows inside this rule's stream segment
        seg_len = len(kinds) - seg_start
        for p in range(seg_len - l + 1):
            win_start.append(seg_start + p)
            win_rule.append(r)

    return StreamPlan(
        l=l,
        st_kind=np.array(kinds, np.int8), st_lit=np.array(lits, np.int32),
        st_src=np.array(srcs, np.int32), st_idx=np.array(idxs, np.int32),
        st_symj=np.array(symjs, np.int32),
        win_start=np.array(win_start, np.int32),
        win_rule=np.array(win_rule, np.int32),
    )


# ----------------------------------------------------------------------- #
# Device phase 1: resolve head/tail (paper Fig. 7, masked rounds)          #
# ----------------------------------------------------------------------- #
def resolve_head_tail(ga: GrammarArrays, plan: HeadTailPlan, device=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The [R, h] head and tail buffers (int32, -1 past a short rule's
    end), filled in masked rounds: a rule resolves once every rule it
    copies from has resolved."""
    from .batch import _resolve_buffers_batched

    dev = resolve_device(device)

    def resolve(side: str) -> torch.Tensor:
        def put(name: str, dtype) -> torch.Tensor:
            a = np.asarray(getattr(plan, f"{side}_{name}"), dtype)
            return torch.as_tensor(a, device=dev)[None]
        return _resolve_buffers_batched(
            put("is_lit", bool), put("lit", np.int32), put("src", np.int64),
            put("idx", np.int64), put("dep", np.int64))[0]

    return resolve("head"), resolve("tail")


# ----------------------------------------------------------------------- #
# Device phase 2: gather streams, count windows (paper Fig. 8)             #
# ----------------------------------------------------------------------- #
def sequence_count(ga: GrammarArrays, l: int = 3, method: str = "frontier",
                   weights: torch.Tensor | None = None, device=None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Count all l-grams of the corpus directly on the grammar.

    Returns numpy (grams [U, l] int32, counts [U] float32) for the U
    distinct l-grams, sorted lexicographically.  File splitters break
    windows (sequences never span files).  ``weights`` lets callers reuse a
    memoized traversal on the same device (must equal
    ``top_down_weights(ga)``)."""
    from .batch import _count_windows_batched, distinct_grams
    from .traversal import top_down_weights

    if l < 2:
        raise ValueError("sequence_count needs l >= 2")
    dev = resolve_device(device)
    htp = plan_head_tail(ga, l)
    sp = plan_stream(ga, l)
    head, tail = resolve_head_tail(ga, htp, dev)
    if weights is None:
        weights = top_down_weights(ga, method=method, device=dev)
    elif weights.device != dev:
        raise ValueError(f"weights are on {weights.device}, expected {dev}")

    if sp.win_start.shape[0] == 0:
        return np.zeros((0, l), np.int32), np.zeros((0,), np.float32)

    def put(a, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype), device=dev)[None]

    return distinct_grams(*_count_windows_batched(
        head[None], tail[None], weights[None], put(sp.st_kind, np.int8),
        put(sp.st_lit, np.int32), put(sp.st_src, np.int64),
        put(sp.st_idx, np.int64), put(sp.st_symj, np.int32),
        put(sp.win_start, np.int64), put(sp.win_rule, np.int64),
        torch.ones((1, len(sp.win_start)), dtype=torch.bool, device=dev),
        l))[0]
