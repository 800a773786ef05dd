"""Core layers, the port of the JAX package's ``models/layers.py``.

Parameters keep the JAX package's layouts (``wq [d, H, hd]``,
``wo [H, hd, d]``, ``wi [d, ff]``, ...) and are applied with
``torch.einsum``, so carrying weights across is a copy, not a transpose.
During init each leaf is a ``Boxed(value, axes)``: ``axes`` are the
*logical* axis names the sharding layer maps to devices ("vocab",
"embed", "heads", "kv_heads", "head_dim", "ffn", "expert", "ssm_*", None
for a replicated dim); ``unbox`` splits a tree into (params, axes).

Init draws float32 normals on the host from an explicit
``torch.Generator`` (``None`` leaves the values unset, for a skeleton the
caller fills); it need not match ``jax.random``: the differential tests
carry the JAX package's weights across (``models/convert.py``).

Numerics mirror the JAX functions: norms in float32 and cast back,
population variance, interleaved-pair RoPE with ``inv_freq`` from float64
numpy, GELU with the tanh approximation (``jax.nn.gelu``'s default), and
attention masked with ``-1e30`` (not ``-inf``) in both branches.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass
class Boxed:
    value: Any
    axes: Tuple[Optional[str], ...]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def stack_trees(trees, stack):
    """Combine identically-structured trees leaf by leaf: ``stack`` turns
    the list of one leaf's values (one a tree) into the combined leaf."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees], stack) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_trees([t[i] for t in trees], stack)
                           for i in range(len(first)))
    return stack(trees)


def stack_boxed(trees):
    """Stack a list of identically-structured Boxed trees along a new
    leading "layers" axis (the JAX package's scan dimension)."""
    return stack_trees(trees, lambda bs: Boxed(
        torch.stack([b.value for b in bs]), ("layers",) + bs[0].axes))


def unbox(tree):
    return tree_map(lambda b: b.value, tree), tree_map(lambda b: b.axes,
                                                       tree)


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def _dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


# ------------------------------------------------------------------ init --
def dense_init(gen: Optional[torch.Generator], shape, axes, dtype,
               scale: float | None = None) -> Boxed:
    if gen is None:
        return Boxed(torch.empty(shape, dtype=dtype), axes)
    fan_in = shape[0] if len(shape) > 1 else 1
    scale = (1.0 / math.sqrt(fan_in)) if scale is None else scale
    v = torch.randn(shape, generator=gen, dtype=torch.float32) * scale
    return Boxed(v.to(dtype), axes)


def zeros_init(shape, axes, dtype) -> Boxed:
    return Boxed(torch.zeros(shape, dtype=dtype), axes)


def ones_init(shape, axes, dtype) -> Boxed:
    return Boxed(torch.ones(shape, dtype=dtype), axes)


# ----------------------------------------------------------------- norms --
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * scale.float() + bias.float()).to(dt)


# ------------------------------------------------------------------ rope --
def rope_frequencies(head_dim: int, fraction: float, theta: float
                     ) -> np.ndarray:
    rot = int(head_dim * fraction) // 2 * 2
    inv = 1.0 / (theta ** (np.arange(0, rot, 2, dtype=np.float64) / rot))
    return inv.astype(np.float32)  # [rot/2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S]; rotate the interleaved pairs of
    the first 2*len(inv_freq) channels (partial rotary when fraction < 1)."""
    rot = 2 * inv_freq.shape[0]
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    ang = positions[..., None].float() * inv_freq          # [B,S,rot/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr.to(x.dtype), xp], dim=-1)


# ------------------------------------------------------------------- ffn --
def init_ffn(gen, d_model: int, d_ff: int, act: str, dtype) -> Dict:
    if act == "swiglu":
        return {
            "wi": dense_init(gen, (d_model, d_ff), ("embed", "ffn"), dtype),
            "wg": dense_init(gen, (d_model, d_ff), ("embed", "ffn"), dtype),
            "wo": dense_init(gen, (d_ff, d_model), ("ffn", "embed"), dtype),
        }
    return {
        "wi": dense_init(gen, (d_model, d_ff), ("embed", "ffn"), dtype),
        "bi": zeros_init((d_ff,), ("ffn",), dtype),
        "wo": dense_init(gen, (d_ff, d_model), ("ffn", "embed"), dtype),
        "bo": zeros_init((d_model,), ("embed",), dtype),
    }


def apply_ffn(p, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wi"])
        return h @ p["wo"]
    h = F.gelu((x @ p["wi"]) + p["bi"], approximate="tanh")
    return h @ p["wo"] + p["bo"]


# ------------------------------------------------------------- attention --
def init_attention(gen, cfg) -> Dict:
    d, H, Hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    dt = _dtype(cfg.dtype)
    p = {
        "wq": dense_init(gen, (d, H, hd), ("embed", "heads", "head_dim"), dt),
        "wk": dense_init(gen, (d, Hkv, hd), ("embed", "kv_heads", "head_dim"),
                         dt),
        "wv": dense_init(gen, (d, Hkv, hd), ("embed", "kv_heads", "head_dim"),
                         dt),
        "wo": dense_init(gen, (H, hd, d), ("heads", "head_dim", "embed"), dt),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros_init((H, hd), ("heads", "head_dim"), dt)
        p["bk"] = zeros_init((Hkv, hd), ("kv_heads", "head_dim"), dt)
        p["bv"] = zeros_init((Hkv, hd), ("kv_heads", "head_dim"), dt)
    return p


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)`` as a matmul over the flattened
    heads x head_dim, unflattened.  On a mesh, DTensor may split that
    flattened dim of the output (free when ``w``'s heads are replicated)
    and of ``w``'s gradient over a mesh dim whose size the heads do not
    divide; such a split falls off head boundaries and cannot view back
    to heads.  So the output is gathered on that dim, and the flattened
    weight re-enters as a DTensor of its own placement, whose gradient
    DTensor returns to that placement."""
    from torch.distributed.tensor import DTensor, Replicate
    H, hd = w.shape[1], w.shape[2]
    w2 = w.flatten(1)
    if isinstance(w2, DTensor):
        w2 = DTensor.from_local(w2.to_local(), w2.device_mesh,
                                w2.placements, run_check=False)
    y = x @ w2
    if isinstance(y, DTensor):
        last = y.ndim - 1
        mesh = y.device_mesh
        pl = tuple(Replicate() if p.is_shard(last) and H % mesh.size(i)
                   else p for i, p in enumerate(y.placements))
        if pl != tuple(y.placements):
            y = y.redistribute(mesh, pl)
    return y.unflatten(-1, (H, hd))


def _qkv(p, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, ...]:
    q, k, v = (_heads(x, p[w]) for w in ("wq", "wk", "wv"))
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _mask(Sq: int, kv_pos: torch.Tensor, q_offset, causal: bool, kv_len
          ) -> torch.Tensor:
    """[Sq, len(kv_pos)] bool: causal against absolute query positions
    ``arange(Sq) + q_offset``, and kv positions below ``kv_len``."""
    mask = torch.ones((Sq, kv_pos.shape[0]), dtype=torch.bool,
                      device=kv_pos.device)
    if causal:
        q_pos = torch.arange(Sq, device=kv_pos.device) + q_offset
        mask &= q_pos[:, None] >= kv_pos[None, :]
    if kv_len is not None:
        mask &= kv_pos[None, :] < kv_len
    return mask


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, q_offset=0, kv_len=None,
                  chunk: int = 0) -> torch.Tensor:
    """q: [B,Sq,H,D], k/v: [B,Skv,Hkv,D].  GQA by head-group reshape:
    query head h reads kv head h // G.

    ``q_offset``: absolute position of q[0] (decode: cache length).
    ``kv_len``: valid kv prefix length (decode with pre-allocated cache).
    ``chunk`` > 0: loop over kv blocks with online softmax (bounded memory
    for long prefill).
    """
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    kf = k.float()
    vf = v.float()
    scale = 1.0 / math.sqrt(D)
    dev = q.device

    if chunk and Skv > chunk and Skv % chunk == 0:
        m = torch.full((B, Sq, Hkv, G), float("-inf"), device=dev)
        l = torch.zeros((B, Sq, Hkv, G), device=dev)
        acc = torch.zeros((B, Sq, Hkv, G, D), device=dev)
        for j in range(Skv // chunk):
            kj = kf[:, j * chunk:(j + 1) * chunk]
            vj = vf[:, j * chunk:(j + 1) * chunk]
            kv_pos = j * chunk + torch.arange(chunk, device=dev)
            s = torch.einsum("bqhgd,bkhd->bqhgk", qg, kj) * scale
            mask = _mask(Sq, kv_pos, q_offset, causal,
                         kv_len)[None, :, None, None, :]
            s = torch.where(mask, s, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # explicit re-mask: a fully-masked block would otherwise give
            # exp(-1e30 - (-1e30)) == 1 and corrupt the running sum
            p = torch.exp(s - m_new[..., None]) * mask
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqhgk,bkhd->bqhgd", p, vj)
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
    else:
        s = torch.einsum("bqhgd,bkhd->bqhgk", qg, kf) * scale
        mask = _mask(Sq, torch.arange(Skv, device=dev), q_offset, causal,
                     kv_len)
        s = torch.where(mask[None, :, None, None, :], s, -1e30)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bqhgk,bkhd->bqhgd", p, vf)

    return out.reshape(B, Sq, H, D).to(q.dtype)


def attn_out(p, ctx: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(ctx, DTensor):
        # the einsum flattens (b, s) and (h, k); DTensor (torch 2.11)
        # cannot flatten dims whose inner one is split, so a split of s
        # (the "attn_q" sequence split) or of k is gathered first
        pl = tuple(Replicate() if p.is_shard(1) or p.is_shard(3) else p
                   for p in ctx.placements)
        if pl != tuple(ctx.placements):
            ctx = ctx.redistribute(ctx.device_mesh, pl)
    return torch.einsum("bshk,hkd->bsd", ctx, p["wo"])
