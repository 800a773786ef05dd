"""Mixture-of-Experts FFN with capacity-based sort dispatch, the port of
the JAX package's ``models/moe.py``.

Dispatch is GROUP-LOCAL (each batch row is a dispatch group) and
FLOP-faithful: each group's token-expert pairs are sorted by expert
(stable), ranked within their expert's segment, and scattered into an
``[E, C+1, d]`` buffer (capacity ``C = ceil(S*K/E * capacity_factor)``;
slot ``C`` takes the overflow and is dropped), so expert compute is E
batched matmuls over C tokens.  The router runs in float32; top-k keeps
``lax.top_k``'s tie order (equal values toward the lower index) through
the port's stable-sort primitive ``kernels.ops.masked_top_k``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import masked_top_k

from .layers import _dtype, dense_init


def init_moe(gen, cfg) -> Dict:
    d, E, ff = cfg.d_model, cfg.moe_num_experts, cfg.moe_d_ff
    dt = _dtype(cfg.dtype)
    p = {
        "router": dense_init(gen, (d, E), ("embed", "expert"), torch.float32),
        "wi": dense_init(gen, (E, d, ff), ("expert", "embed", "ffn"), dt),
        "wg": dense_init(gen, (E, d, ff), ("expert", "embed", "ffn"), dt),
        "wo": dense_init(gen, (E, ff, d), ("expert", "ffn", "embed"), dt),
    }
    if cfg.moe_shared_d_ff:
        sf = cfg.moe_shared_d_ff
        p["shared"] = {
            "wi": dense_init(gen, (d, sf), ("embed", "ffn"), dt),
            "wg": dense_init(gen, (d, sf), ("embed", "ffn"), dt),
            "wo": dense_init(gen, (sf, d), ("ffn", "embed"), dt),
        }
    return p


def capacity(S: int, cfg) -> int:
    """Slots per expert and group: ``ceil(S*K/E * capacity_factor)``."""
    N = S * cfg.moe_top_k
    return max(int(math.ceil(N / cfg.moe_num_experts *
                             cfg.moe_capacity_factor)), 1)


def moe_routing(p, x: torch.Tensor, cfg):
    """Router and dispatch plan of ``x [B, S, d]``.

    Returns ``(probs [B,S,E], idx [B,S,K] int64, plan)`` where ``plan =
    (se, st, sg, keep, slot)``, each ``[B, S*K]``: the pairs' experts,
    tokens and gates in expert-sorted order, whether each fits its
    expert's capacity, and its slot (``C`` when it overflows).
    """
    B, S, _ = x.shape
    E, K = cfg.moe_num_experts, cfg.moe_top_k
    N = S * K
    C = capacity(S, cfg)
    logits = torch.einsum("bsd,de->bse", x.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    gate, idx = masked_top_k(probs, torch.ones_like(probs, dtype=torch.bool),
                             K)
    idx = idx.long()
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    dev = x.device
    flat_e = idx.reshape(B, N)
    flat_t = torch.arange(S, device=dev).repeat_interleave(K)       # [N]
    flat_g = gate.reshape(B, N)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    st = flat_t[order]
    sg = torch.gather(flat_g, 1, order)
    experts = torch.arange(E, device=dev).expand(B, E).contiguous()
    seg_start = torch.searchsorted(se, experts, side="left")
    rank = torch.arange(N, device=dev) - torch.gather(seg_start, 1, se)
    keep = rank < C
    slot = torch.where(keep, rank, C)                               # overflow
    return probs, idx, (se, st, sg, keep, slot)


def apply_moe(p, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y, aux_loss)."""
    B, S, d = x.shape
    E, K = cfg.moe_num_experts, cfg.moe_top_k
    N = S * K
    C = capacity(S, cfg)
    probs, idx, (se, st, sg, keep, slot) = moe_routing(p, x, cfg)

    # load-balancing auxiliary loss (Switch-style, group-averaged)
    me = probs.mean(dim=(0, 1))
    ce = torch.zeros(E, device=x.device).index_put_(
        (idx.reshape(-1),), torch.ones(B * N, device=x.device),
        accumulate=True) / (B * N)
    aux = E * torch.sum(me * ce)

    rows = torch.arange(B, device=x.device)[:, None].expand(B, N)
    buf = torch.zeros((B, E, C + 1, d), dtype=x.dtype, device=x.device)
    buf.index_put_((rows, se, slot), x[rows, st], accumulate=True)
    xb = buf[:, :, :C, :]                                          # [B,E,C,d]

    h = F.silu(torch.einsum("becd,edf->becf", xb, p["wg"])) * \
        torch.einsum("becd,edf->becf", xb, p["wi"])
    yb = torch.einsum("becf,efd->becd", h, p["wo"])                # [B,E,C,d]

    # an overflowed pair reads slot C-1 (the JAX gather clamps) and is
    # dropped by the select
    picked = yb[rows, se, torch.clamp(slot, max=C - 1)].float()
    contrib = torch.where(keep[..., None], picked * sg[..., None], 0.0)
    y = torch.zeros((B, S, d), dtype=torch.float32, device=x.device)
    y.index_put_((rows, st), contrib, accumulate=True)
    y = y.to(x.dtype)

    if "shared" in p:
        sh = p["shared"]
        hs = F.silu(x @ sh["wg"]) * (x @ sh["wi"])
        y = y + hs @ sh["wo"]
    return y, aux
