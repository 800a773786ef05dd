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
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .layers import Boxed, _dtype, dense_init, ones_init, rms_norm, zeros_init


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

    zxbcdt = x_in @ p["in_proj"]
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

    y = _ssd_chunked(Xh.float(), Bh.float(), Ch.float(), dt_, dA, chunk)
    y = y + Xh.float() * p["D"][None, None, :, None]
    y = y.reshape(Bb, S, di)
    y = rms_norm(y.to(x_in.dtype) * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"]


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


def apply_mamba_decode(p, x_in: torch.Tensor, state: Dict, cfg
                       ) -> Tuple[torch.Tensor, Dict]:
    """One-token recurrence. x_in: [B, 1, d]; state: {"h": [B,H,P,N],
    "conv": [B,K-1,conv_dim]} -> (y [B,1,d], new state)."""
    Bb, _, d = x_in.shape
    di = cfg.ssm_expand * d
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    K = cfg.ssm_conv

    zxbcdt = x_in @ p["in_proj"]
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

    h = state["h"] * decay[..., None, None] + \
        torch.einsum("bhp,bhn,bh->bhpn", Xh, Bh, dt_)
    y = torch.einsum("bhn,bhpn->bhp", Ch, h)
    y = y + Xh * p["D"][None, :, None]
    y = y.reshape(Bb, 1, di)
    y = rms_norm(y.to(x_in.dtype) * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"], {"h": h, "conv": new_conv}


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
