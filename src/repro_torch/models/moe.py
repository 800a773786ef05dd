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

On a mesh (DTensor parameters, ``distributed.distribute_lm``) the
routing and dispatch run inside ``local_map``, each rank the plain code
on its own tensors, in the EP layout: a rank routes the batch rows it
holds over all E experts (the small float32 router gathered) and
dispatches and computes only the pairs of the experts it holds, so
``y`` is a partial sum over ``model`` (:func:`_dispatch_on_mesh`).  The
aux loss and the shared expert (TP over ``ffn``) are DTensor ops.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

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
    probs = _router_probs(p, x)
    return (probs,) + _plan(probs, cfg)


def _router_probs(p, x: torch.Tensor) -> torch.Tensor:
    logits = torch.einsum("bsd,de->bse", x.float(), p["router"])
    return torch.softmax(logits, dim=-1)


def _plan(probs: torch.Tensor, cfg):
    """``(idx, (se, st, sg, keep, slot))`` of the router's ``probs``."""
    B, S, _ = probs.shape
    E, K = cfg.moe_num_experts, cfg.moe_top_k
    N = S * K
    C = capacity(S, cfg)
    gate, idx = masked_top_k(probs, torch.ones_like(probs, dtype=torch.bool),
                             K)
    idx = idx.long()
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    dev = probs.device
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
    return idx, (se, st, sg, keep, slot)


def _dispatch(x: torch.Tensor, probs: torch.Tensor, wi: torch.Tensor,
              wg: torch.Tensor, wo: torch.Tensor, cfg, first: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed experts of one shard, on plain tensors: ``x [B, S, d]``
    routed by ``probs [B, S, E]`` over all E experts, of which ``wi``/
    ``wg`` ``[E_l, d, ff_l]`` and ``wo`` ``[E_l, ff_l, d]`` hold experts
    ``first .. first + E_l - 1`` (and a slice of their ``ffn`` dim).  Only
    the pairs of those experts are dispatched and computed; the rest go
    to the dropped overflow slot.  Returns ``(y [B, S, d], counts [E])``:
    those experts' share of the output and the number of pairs each
    expert was picked for.  With every expert here (``E_l = E``,
    ``first = 0``) this is the whole dispatch, op for op."""
    B, S, d = x.shape
    E, K = cfg.moe_num_experts, cfg.moe_top_k
    N = S * K
    C = capacity(S, cfg)
    idx, (se, st, sg, keep, slot) = _plan(probs, cfg)
    counts = torch.zeros(E, device=x.device).index_put_(
        (idx.reshape(-1),), torch.ones(B * N, device=x.device),
        accumulate=True)

    own = (se >= first) & (se < first + wi.shape[0])
    le = torch.where(own, se - first, 0)
    lslot = torch.where(own, slot, C)
    rows = torch.arange(B, device=x.device)[:, None].expand(B, N)
    buf = torch.zeros((B, wi.shape[0], C + 1, d), dtype=x.dtype,
                      device=x.device)
    buf.index_put_((rows, le, lslot), x[rows, st], accumulate=True)
    xb = buf[:, :, :C, :]                                        # [B,E_l,C,d]

    h = F.silu(torch.einsum("becd,edf->becf", xb, wg)) * \
        torch.einsum("becd,edf->becf", xb, wi)
    yb = torch.einsum("becf,efd->becd", h, wo)                   # [B,E_l,C,d]

    # an overflowed pair reads slot C-1 (the JAX gather clamps) and is
    # dropped by the select, as is a pair of another shard's expert
    picked = yb[rows, le, torch.clamp(lslot, max=C - 1)].float()
    contrib = torch.where((keep & own)[..., None], picked * sg[..., None],
                          0.0)
    y = torch.zeros((B, S, d), dtype=torch.float32, device=x.device)
    y.index_put_((rows, st), contrib, accumulate=True)
    return y.to(x.dtype), counts


def _dispatch_on_mesh(p, x: DTensor, probs: DTensor, cfg):
    """:func:`_dispatch` of DTensors, one shard a rank, by ``local_map``.

    Rows: a batch row is a dispatch group, so a rank routes and
    dispatches the rows it holds (``Shard(0)`` over the batch mesh dims
    when the batch divides them, as the rules place it) and no token
    crosses ranks.  Experts (the EP layout): the expert weights keep
    their placement on ``model`` and are gathered on the other dims.
    ``Shard(0)`` (the rules' ``"expert" -> "model"``) gives a rank E/m
    experts, whose pairs alone it dispatches; ``Shard`` of the ``ffn`` dim
    (E does not divide ``model``) gives it every expert and a slice of
    each one's hidden dim; on a ``model`` of one, or replicated, it runs
    every expert whole, the plain code.  Either split leaves each rank a
    partial sum of ``y`` (``Partial()`` on ``model``), summed where it is
    read; the counts are partial sums over the batch dims.  The router
    (``[d, E]`` float32) is gathered, so every ``model`` rank routes its
    rows over all E experts alike."""
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    names = mesh.mesh_dim_names or ()
    m_dim = names.index("model") if "model" in names else None
    b_dims = [i for i in range(mesh.ndim) if i != m_dim]
    n_rows = math.prod(mesh.size(i) for i in b_dims)
    split_rows = n_rows > 1 and x.shape[0] % n_rows == 0

    def at(model, rows, other=Replicate()):
        """Placements: ``model`` on the model dim, ``rows`` on the batch
        dims (``other`` there when the rows are not split)."""
        return tuple(model if i == m_dim else (rows if split_rows else other)
                     for i in range(mesh.ndim))

    # the model dim's split, read off wi: experts, ffn, or none
    wi_model = p["wi"].placements[m_dim] if m_dim is not None else \
        Replicate()
    E = cfg.moe_num_experts
    if wi_model == Shard(0):
        w_model = {"wi": Shard(0), "wg": Shard(0), "wo": Shard(0)}
    elif wi_model == Shard(2):
        w_model = {"wi": Shard(2), "wg": Shard(2), "wo": Shard(1)}
    else:
        w_model = {k: Replicate() for k in ("wi", "wg", "wo")}
    y_model = Replicate() if wi_model == Replicate() else Partial()
    first = 0
    if wi_model == Shard(0):
        first = mesh.get_local_rank(m_dim) * (E // mesh.size(m_dim))

    rows = at(Replicate(), Shard(0))
    w_in = [at(w_model[k], Replicate()) for k in ("wi", "wg", "wo")]
    args = [x.redistribute(mesh, rows), probs.redistribute(mesh, rows)]
    args += [p[k].redistribute(mesh, pl)
             for k, pl in zip(("wi", "wg", "wo"), w_in)]
    fn = local_map(
        functools.partial(_dispatch, cfg=cfg, first=first),
        out_placements=(at(y_model, Shard(0)), at(Replicate(), Partial())),
        in_placements=(rows, rows, *w_in),
        in_grad_placements=(at(y_model, Shard(0)), at(y_model, Shard(0)),
                            *(at(w_model[k], Partial())
                              for k in ("wi", "wg", "wo"))),
        device_mesh=mesh)
    return fn(*args)


def apply_moe(p, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y, aux_loss).  On DTensors the routed experts run
    one shard a rank (:func:`_dispatch_on_mesh`); the router, the aux
    loss and the shared expert are DTensor ops."""
    B, S, _ = x.shape
    E, K = cfg.moe_num_experts, cfg.moe_top_k
    N = S * K
    probs = _router_probs(p, x)
    if isinstance(p["wi"], DTensor):
        y, counts = _dispatch_on_mesh(p, x, probs, cfg)
    else:
        y, counts = _dispatch(x, probs, p["wi"], p["wg"], p["wo"], cfg)

    # load-balancing auxiliary loss (Switch-style, group-averaged)
    me = probs.mean(dim=(0, 1))
    ce = counts / (B * N)
    aux = E * torch.sum(me * ce)

    if "shared" in p:
        sh = p["shared"]
        hs = F.silu(x @ sh["wg"]) * (x @ sh["wi"])
        y = y + hs @ sh["wo"]
    return y, aux
