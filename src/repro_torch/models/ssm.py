"""Mamba2 (SSD — state-space duality, arXiv:2405.21060), the port of the
JAX package's ``models/ssm.py``.

Chunked SSD for prefill: the sequence is split into chunks of Q tokens;
within a chunk the dual quadratic form runs as matmuls
(``C B^T ⊙ decay``), across chunks a recurrent state [H, P, N] is carried
by a host loop over the chunks (the JAX package's ``lax.scan``).
Single-token decode keeps the state plus the depthwise-conv tail in the
serving cache and does the O(1) recurrence.

``decay = exp(a_q - a_k)`` is computed for every pair and the upper
triangle (which overflows) is then zeroed with ``where``, never by
multiplying with a mask (``inf * 0`` is NaN).

On DTensors the scan and the decode recurrence run one shard a rank
(:func:`_heads_per_rank`): both treat every (batch row, head) apart;
so do the in and out projections (:func:`_project`).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from .layers import (Boxed, _MeshLayout, _dtype, dense_init, ones_init,
                     rms_norm, zeros_init)


def init_mamba(gen, cfg) -> Dict:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    H = cfg.ssm_heads
    N = cfg.ssm_state
    G = cfg.ssm_groups
    dt = _dtype(cfg.dtype)
    conv_dim = di + 2 * G * N
    if gen is None:
        u = torch.empty(H)
    else:
        u = torch.rand(H, generator=gen) * (
            math.log(1e-1) - math.log(1e-3)) + math.log(1e-3)
    return {
        # order: [z | x | B | C | dt]
        "in_proj": dense_init(gen, (d, 2 * di + 2 * G * N + H),
                              ("embed", "ssm_inner"), dt),
        "conv_w": dense_init(gen, (cfg.ssm_conv, conv_dim),
                             (None, "ssm_inner"), dt, scale=0.5),
        "conv_b": zeros_init((conv_dim,), ("ssm_inner",), dt),
        # A_log, D and dt_bias stay float32 whatever cfg.dtype is
        "A_log": Boxed(torch.log(torch.linspace(1.0, 16.0, H)),
                       ("ssm_heads",)),
        "D": ones_init((H,), ("ssm_heads",), torch.float32),
        "dt_bias": Boxed(torch.log(torch.expm1(torch.exp(u))),
                         ("ssm_heads",)),
        "norm": ones_init((di,), ("ssm_inner",), dt),
        "out_proj": dense_init(gen, (di, d), ("ssm_inner", "embed"), dt),
    }


def _split_proj(cfg, zxbcdt):
    di = cfg.ssm_expand * cfg.d_model
    G, N = cfg.ssm_groups, cfg.ssm_state
    z = zxbcdt[..., :di]
    x = zxbcdt[..., di:2 * di]
    Bv = zxbcdt[..., 2 * di:2 * di + G * N]
    Cv = zxbcdt[..., 2 * di + G * N:2 * di + 2 * G * N]
    dtv = zxbcdt[..., 2 * di + 2 * G * N:]
    return z, x, Bv, Cv, dtv


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv1d. xbc: [B,S,C]; w: [K,C]. ``tail``: [B,K-1,C]
    carry-in for decode continuity."""
    K = w.shape[0]
    if tail is None:
        pad = torch.zeros((xbc.shape[0], K - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = tail.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)                 # [B, S+K-1, C]
    out = sum(xp[:, i:i + xbc.shape[1], :] * w[i] for i in range(K))
    return F.silu(out + b)


def apply_mamba(p, x_in: torch.Tensor, cfg, chunk: int = 64
                ) -> torch.Tensor:
    """Prefill path. x_in: [B, S, d] -> [B, S, d]."""
    Bb, S, d = x_in.shape
    di = cfg.ssm_expand * d
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups

    zxbcdt = _project(x_in, p["in_proj"], "out")
    z, xs, Bv, Cv, dtv = _split_proj(cfg, zxbcdt)
    xbc = torch.cat([xs, Bv, Cv], dim=-1)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs, Bv, Cv = (xbc[..., :di], xbc[..., di:di + G * N],
                  xbc[..., di + G * N:])

    Xh = xs.reshape(Bb, S, H, P)
    rep = H // G
    Bh = Bv.reshape(Bb, S, G, N).repeat_interleave(rep, dim=2)  # [B,S,H,N]
    Ch = Cv.reshape(Bb, S, G, N).repeat_interleave(rep, dim=2)

    dt_ = F.softplus(dtv.float() + p["dt_bias"])     # [B,S,H]
    A = -torch.exp(p["A_log"])                         # [H]
    dA = dt_ * A                                       # [B,S,H] log-decay

    y = _heads_per_rank(functools.partial(_ssd_chunked, Q=chunk), 2, 1,
                        Xh.float(), Bh.float(), Ch.float(), dt_, dA)
    y = y + Xh.float() * p["D"][None, None, :, None]
    y = y.reshape(Bb, S, di)
    y = rms_norm(y.to(x_in.dtype) * F.silu(z), p["norm"], cfg.norm_eps)
    return _project(y, p["out_proj"], "in")


def _project(x: torch.Tensor, w: torch.Tensor, split: str) -> torch.Tensor:
    """``x @ w``.  On DTensors whose ``model`` dim divides the split width,
    one shard a rank (``local_map``, :class:`~.layers._MeshLayout`): the
    in_proj (``split="out"``) takes ``w``'s columns over ``model`` and
    gathers the split output; the out_proj (``split="in"``) takes ``x``'s
    last dim and ``w``'s rows over ``model`` and returns a partial sum on
    ``model``.  ``w`` is gathered on the batch mesh dims, ``x`` takes its
    batch rows.  The gradients keep the operands' ``model`` placement
    (``x``'s partial for the in_proj), so no rank computes the whole
    weight gradient or the whole input gradient, whatever strategy
    DTensor would choose for the ``mm``."""
    if not any(isinstance(t, DTensor) for t in (x, w)):
        return x @ w
    lay = _MeshLayout(x, w)
    wdim = 1 if split == "out" else 0
    if lay.m == 1 or w.shape[wdim] % lay.m:
        return x @ w
    if split == "out":
        y = lay.run(torch.matmul, (lay.at(Shard(2)),),
                    (lay.at(Replicate()), lay.at(Shard(1), Replicate())),
                    (lay.at(Partial()), lay.at(Shard(1), Partial())), x, w)
        return y.redistribute(lay.mesh, lay.at(Replicate()))
    return lay.run(torch.matmul, (lay.at(Partial()),),
                   (lay.at(Shard(2)), lay.at(Shard(0), Replicate())),
                   (lay.at(Shard(2)), lay.at(Shard(0), Partial())), x, w)


def _ssd_chunked(X, B_, C_, dt_, dA, Q: int):
    """X:[B,S,H,P] B_,C_:[B,S,H,N] dt_,dA:[B,S,H] -> Y:[B,S,H,P] (f32)."""
    Bb, S, H, P = X.shape
    N = B_.shape[-1]
    if S % Q:
        pad = Q - S % Q
        X = F.pad(X, (0, 0, 0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, 0, 0, pad))
        dt_ = F.pad(dt_, (0, 0, 0, pad))
        dA = F.pad(dA, (0, 0, 0, pad))
    Sp = X.shape[1]
    qi = torch.arange(Q, device=X.device)
    causal = (qi[:, None] >= qi[None, :])[None, :, :, None]   # [1,Q,K,1]

    h = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=X.device)
    ys = []
    for c0 in range(0, Sp, Q):
        Xq, Bq, Cq = X[:, c0:c0 + Q], B_[:, c0:c0 + Q], C_[:, c0:c0 + Q]
        dtq, dAq = dt_[:, c0:c0 + Q], dA[:, c0:c0 + Q]
        a = torch.cumsum(dAq, dim=1)                  # [B,Q,H]
        a_last = a[:, -1:, :]                         # [B,1,H]
        # intra-chunk quadratic (the "dual" form)
        scores = torch.einsum("bqhn,bkhn->bhqk", Cq, Bq)
        decay = torch.exp(a[:, :, None, :] - a[:, None, :, :])  # [B,Q,K,H]
        L = torch.where(causal, decay, 0.0).permute(0, 3, 1, 2)  # [B,H,Q,K]
        dt_k = dtq.permute(0, 2, 1)[:, :, None, :]               # [B,H,1,K]
        M = scores * L * dt_k
        y_intra = torch.einsum("bhqk,bkhp->bqhp", M, Xq)
        # inter-chunk: contribution of the carried state
        y_inter = torch.einsum("bqhn,bhpn->bqhp", Cq,
                               h) * torch.exp(a)[..., None]
        # state update
        w = torch.exp(a_last - a) * dtq               # [B,Q,H]
        h = h * torch.exp(a_last).permute(0, 2, 1)[..., None] + \
            torch.einsum("bqhp,bqhn,bqh->bhpn", Xq, Bq, w)
        ys.append(y_intra + y_inter)
    Y = torch.cat(ys, dim=1)
    return Y[:, :S]


def _state_step(h, decay, Xh, Bh, Ch, dt_):
    """One recurrence step of every (row, head): the read-out ``y [B,H,P]``
    and the new state ``h [B,H,P,N]``."""
    h = h * decay[..., None, None] + \
        torch.einsum("bhp,bhn,bh->bhpn", Xh, Bh, dt_)
    return torch.einsum("bhn,bhpn->bhp", Ch, h), h


def _heads_per_rank(fn, head_dim: int, n_out: int, *args):
    """``fn(*args)``; on DTensors one shard a rank (``local_map``).  Each
    argument's dim 0 is the batch and its dim ``head_dim`` the heads, as
    are the ``n_out`` outputs'; ``fn`` treats every (row, head) apart.
    Rows go over the batch mesh dims where the batch divides them
    (:class:`~.layers._MeshLayout`), heads over ``model`` where their
    count divides it; every other dim is gathered (a split of the state's
    ``P`` on a narrow mesh included).  So no DTensor op inside flattens a
    split dim (torch 2.11 cannot) or lacks a sharding strategy (torch
    2.11 has none for the ``flip`` of ``cumsum``'s backward).  Gradients
    are placed as their inputs."""
    if not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    lay = _MeshLayout(*args)
    heads = (Shard(head_dim) if lay.m > 1
             and args[0].shape[head_dim] % lay.m == 0 else Replicate())
    pl = (lay.at(heads),) * len(args)
    return lay.run(fn, pl[:1] * n_out, pl, pl, *args)


def apply_mamba_decode(p, x_in: torch.Tensor, state: Dict, cfg
                       ) -> Tuple[torch.Tensor, Dict]:
    """One-token recurrence. x_in: [B, 1, d]; state: {"h": [B,H,P,N],
    "conv": [B,K-1,conv_dim]} -> (y [B,1,d], new state)."""
    Bb, _, d = x_in.shape
    di = cfg.ssm_expand * d
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    K = cfg.ssm_conv

    zxbcdt = _project(x_in, p["in_proj"], "out")
    z, xs, Bv, Cv, dtv = _split_proj(cfg, zxbcdt)
    xbc = torch.cat([xs, Bv, Cv], dim=-1)             # [B,1,conv_dim]
    conv_in = torch.cat([state["conv"].to(xbc.dtype), xbc], dim=1)
    out = sum(conv_in[:, i, :] * p["conv_w"][i] for i in range(K))
    xbc1 = F.silu(out + p["conv_b"])[:, None, :]
    new_conv = conv_in[:, 1:, :]

    xs, Bv, Cv = (xbc1[..., :di], xbc1[..., di:di + G * N],
                  xbc1[..., di + G * N:])
    Xh = xs.reshape(Bb, H, P).float()
    rep = H // G
    Bh = Bv.reshape(Bb, G, N).repeat_interleave(rep, dim=1).float()
    Ch = Cv.reshape(Bb, G, N).repeat_interleave(rep, dim=1).float()
    dt_ = F.softplus(dtv[:, 0, :].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt_ * A)                        # [B,H]

    y, h = _heads_per_rank(_state_step, 1, 2, state["h"], decay, Xh, Bh,
                           Ch, dt_)
    y = y + Xh * p["D"][None, :, None]
    y = y.reshape(Bb, 1, di)
    y = rms_norm(y.to(x_in.dtype) * F.silu(z), p["norm"], cfg.norm_eps)
    return _project(y, p["out_proj"], "in"), {"h": h, "conv": new_conv}


def init_mamba_state(cfg, batch: int, dtype=torch.float32,
                     device=None) -> Dict:
    di = cfg.ssm_expand * cfg.d_model
    conv_dim = di + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "h": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                          cfg.ssm_state), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
    }
