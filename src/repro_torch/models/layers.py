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
import functools
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


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
    """The SwiGLU (``wi``, ``wg``, ``wo``) or GELU (``wi``, ``bi``, ``wo``,
    ``bo``) block.  On DTensors all but ``bo`` runs one shard a rank
    (:func:`_ffn_on_mesh`)."""
    second = p["wg"] if act == "swiglu" else p["bi"]
    core = (_ffn_on_mesh if any(isinstance(t, DTensor) for t in (x, p["wi"]))
            else _ffn_core)
    y = core(act, x, p["wi"], second, p["wo"])
    return y if act == "swiglu" else y + own_grad_placement(p["bo"])


def _ffn_core(act: str, x: torch.Tensor, wi: torch.Tensor,
              second: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """:func:`apply_ffn` before ``bo`` on plain tensors; ``second`` is
    ``wg`` (SwiGLU) or ``bi`` (GELU)."""
    if act == "swiglu":
        h = F.silu(x @ second) * (x @ wi)
    else:
        h = F.gelu((x @ wi) + second, approximate="tanh")
    return h @ wo


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


def own_grad_placement(w: torch.Tensor) -> torch.Tensor:
    """``w``; a DTensor re-entered as a DTensor of its own placement,
    whose gradient DTensor then returns to that placement, whatever
    placement the ops that read it give their gradient."""
    if not isinstance(w, DTensor):
        return w
    return DTensor.from_local(w.to_local(), w.device_mesh, w.placements,
                              run_check=False)


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)`` as a matmul over the flattened
    heads x head_dim, unflattened.  On DTensors whose ``model`` dim
    divides the heads (or is 1), one shard a rank (``local_map``,
    :class:`_MeshLayout`): a rank takes its batch rows (``x``'s
    ``model`` split gathered) and its heads (``w``'s dim 1), the output
    split on its heads dim, ``x``'s gradient a partial sum on ``model``
    and ``w``'s split as ``w`` is, so no ``model`` rank projects another
    rank's heads.  Where ``model`` does not divide the heads (the rules
    then keep ``w`` whole on ``model``), DTensor's own strategy splits
    the work (the query's sequence or the contraction), but it may split
    the flattened dim of the output and of ``w``'s gradient off head
    boundaries, which cannot view back to heads: so the output is
    gathered on that dim and the flattened weight's gradient returned
    to its placement (:func:`own_grad_placement`)."""
    if not any(isinstance(t, DTensor) for t in (x, w)):
        return _heads_core(x, w)
    lay = _MeshLayout(x, w)
    H, hd = w.shape[1], w.shape[2]
    if H % lay.m == 0:
        w_model = Shard(1) if lay.m > 1 else Replicate()
        return lay.run(_heads_core, (lay.at(Shard(2) if lay.m > 1
                                            else Replicate()),),
                       (lay.at(Replicate()), lay.at(w_model, Replicate())),
                       (lay.at(Partial() if lay.m > 1 else Replicate()),
                        lay.at(w_model, Partial())), x, w)
    y = x @ own_grad_placement(w.flatten(1))
    last = y.ndim - 1
    mesh = y.device_mesh
    pl = tuple(Replicate() if p.is_shard(last) and H % mesh.size(i)
               else p for i, p in enumerate(y.placements))
    if pl != tuple(y.placements):
        y = y.redistribute(mesh, pl)
    return y.unflatten(-1, (H, hd))


def _heads_core(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    H, hd = w.shape[1], w.shape[2]
    return (x @ w.flatten(1)).unflatten(-1, (H, hd))


def _qkv(p, x: torch.Tensor, cfg, kv_x: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, ...]:
    """The head projections (and biases) of ``x``; k and v of ``kv_x``
    when given (whisper's cross attention reads the encoder output)."""
    kv_x = x if kv_x is None else kv_x
    q, k, v = (_heads(src, p[w])
               for src, w in ((x, "wq"), (kv_x, "wk"), (kv_x, "wv")))
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
    for long prefill).  On DTensors the core runs one shard a rank
    (:func:`_attention_on_mesh`).
    """
    if any(isinstance(t, DTensor) for t in (q, k, v)):
        return _attention_on_mesh(q, k, v, causal, q_offset, kv_len, chunk)
    return _attention(q, k, v, causal, q_offset, kv_len, chunk)


def _attention(q, k, v, causal, q_offset, kv_len, chunk) -> torch.Tensor:
    """:func:`gqa_attention` on plain tensors: G = H // Hkv query heads a
    kv head."""
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



def _local_kv(kv: torch.Tensor, head0: int, H: int, G: int) -> torch.Tensor:
    """The kv heads that query heads ``head0 .. head0 + H - 1`` read (head
    h reads kv head h // G of ``kv [B, S, Hkv, D]``), laid out so that
    :func:`_attention`'s group reshape pairs them right: a slice where
    the H heads make whole groups or lie in one group (``head0`` is a
    multiple of H), else one kv head a query head."""
    if H % G == 0 or G % H == 0:
        lo = head0 // G
        return kv[:, :, lo:lo + max(H // G, 1)]
    return kv.index_select(2, torch.div(
        head0 + torch.arange(H, device=kv.device), G, rounding_mode="floor"))


class _MeshLayout:
    """Placements for a function run one shard a rank (``local_map``):
    the mesh's ``model`` dim, and the batch rows (dim 0 of ``first``)
    over its other dims, ``Shard(0)`` when the batch divides them, else
    every row on every rank.  Plain operands become replicated
    DTensors.  The one place that decides row and ``model`` placements
    for every block of the model that runs on a mesh: the embedding
    lookup, attention (projections, core, output), the FFN, the MoE
    router and dispatch, mamba's projections and scan."""

    def __init__(self, first: torch.Tensor, *others: torch.Tensor):
        mesh = next(t.device_mesh for t in (first,) + others
                    if isinstance(t, DTensor))
        self.mesh = mesh
        names = mesh.mesh_dim_names or ()
        self.m_dim = names.index("model") if "model" in names else None
        self.m = mesh.size(self.m_dim) if self.m_dim is not None else 1
        n_rows = math.prod(mesh.size(i) for i in range(mesh.ndim)
                           if i != self.m_dim)
        self.rows = (Shard(0) if n_rows > 1
                     and first.shape[0] % n_rows == 0 else Replicate())
        self.n_rows = n_rows if self.rows.is_shard() else 1

    def placed(self, t: torch.Tensor) -> DTensor:
        if isinstance(t, DTensor):
            return t
        return DTensor.from_local(t, self.mesh,
                                  [Replicate()] * self.mesh.ndim,
                                  run_check=False)

    def at(self, model, rows=None):
        """Placements: ``model`` on the model dim; on the others ``rows``
        (the batch rows' placement by default) where the rows are split,
        else ``Replicate()``."""
        rows = (self.rows if rows is None else rows) \
            if self.rows.is_shard() else Replicate()
        return tuple(model if i == self.m_dim else rows
                     for i in range(self.mesh.ndim))

    def run(self, fn, outs, ins, grads, *args):
        """``fn`` of ``args`` placed by ``ins``, one shard a rank; its
        outputs placed by ``outs`` (one placement tuple an output), each
        argument's gradient by ``grads``."""
        from torch.distributed.tensor.experimental import local_map
        args = [self.placed(t).redistribute(self.mesh, pl)
                for t, pl in zip(args, ins)]
        return local_map(fn, out_placements=outs, in_placements=ins,
                         in_grad_placements=grads,
                         device_mesh=self.mesh)(*args)


def _ffn_on_mesh(act, x, wi, second, wo) -> torch.Tensor:
    """:func:`_ffn_core` of DTensors, one shard a rank, by ``local_map``
    (:class:`_MeshLayout`): a rank takes its batch rows (``x``'s ``model``
    split gathered) and, where ``model`` divides the ``ffn`` dim, its
    slice of that dim: ``wi``, ``wg`` and ``bi`` split on their ``ffn``
    dim, ``wo`` on dim 0, all gathered on the other mesh dims.  The
    output is then a partial sum on ``model``, as the routed experts'
    is; elsewhere the weights are gathered and every rank runs its rows
    whole.  Each weight's gradient is split as the weight is on
    ``model`` and partial over the batch dims, then returns to the
    weight's placement, so DTensor's strategies choose no layout of
    these matmuls."""
    lay = _MeshLayout(x, wi)
    split = lay.m > 1 and wi.shape[-1] % lay.m == 0
    w_model = ((Shard(1), Shard(second.ndim - 1), Shard(0)) if split
               else (Replicate(),) * 3)
    y_model = Partial() if split else Replicate()
    return lay.run(
        functools.partial(_ffn_core, act), (lay.at(y_model),),
        (lay.at(Replicate()), *(lay.at(w, Replicate()) for w in w_model)),
        (lay.at(y_model), *(lay.at(w, Partial()) for w in w_model)),
        x, wi, second, wo)


class _AttnLayout(_MeshLayout):
    """Attention's :class:`_MeshLayout`, with the ``model`` dim's split of
    the query read off ``q``'s placement: ``"heads"`` (``Shard(2)``),
    ``"seq"`` (``Shard(1)``, the ``attn_q`` policy), ``"rows"``
    (``Shard(0)``: a residual stream that no policy holds can reach a
    layer with its batch rows split over ``model`` too) or ``None``
    (replicated); ``coord`` is the rank's index along a split."""

    def __init__(self, q: torch.Tensor, *others: torch.Tensor):
        super().__init__(q, *others)
        q = self.placed(q)
        q_model = (q.placements[self.m_dim] if self.m_dim is not None
                   else Replicate())
        self.split = None
        if self.m > 1 and q_model.is_shard(2) and q.shape[2] % self.m == 0:
            self.split = "heads"
        elif self.m > 1 and q_model.is_shard(1) and \
                q.shape[1] % self.m == 0:
            self.split = "seq"
        elif self.m > 1 and q_model.is_shard(0) and \
                q.shape[0] % (self.n_rows * self.m) == 0:
            self.split = "rows"
        self.coord = (self.mesh.get_local_rank(self.m_dim) if self.split
                      else 0)

    def by_split(self, heads, seq, rows, neither):
        return {"heads": heads, "seq": seq, "rows": rows}.get(self.split,
                                                              neither)


def _attention_on_mesh(q, k, v, causal, q_offset, kv_len, chunk
                       ) -> torch.Tensor:
    """:func:`_attention` of DTensors, one shard a rank, by ``local_map``
    (:class:`_AttnLayout`): scores, mask, softmax (or the online-softmax
    chunks) and the value product are local; each rank takes its batch
    rows and, by the ``model`` dim's split of q:

    * query heads (``Shard(2)``): H/m query heads.  kv heads that ``model``
      divides follow them (``Shard(2)``, whole groups, the plain reshape);
      others enter replicated on ``model`` and the rank takes the kv head
      of each of its heads (:func:`_local_kv`), their gradients partial
      sums on ``model``;
    * query sequence (``Shard(1)``): its query rows against every key,
      the causal mask offset by the rows before them; k and v replicated
      on ``model``, their gradients partial;
    * batch rows (``Shard(0)``): its rows over ``model`` as well, k and v
      split alike;
    * neither: q is replicated on ``model``, every rank runs its rows.

    The output is placed as q is."""
    lay = _AttnLayout(q, k, v)
    H, Hkv = q.shape[2], k.shape[2]
    kv_follow = lay.split == "heads" and Hkv % lay.m == 0
    q_pl = lay.at(lay.by_split(heads=Shard(2), seq=Shard(1), rows=Shard(0),
                               neither=Replicate()))
    kv_pl = lay.at(Shard(2) if kv_follow else
                   Shard(0) if lay.split == "rows" else Replicate())
    kv_grad = lay.at(lay.by_split(
        heads=Shard(2) if kv_follow else Partial(), seq=Partial(),
        rows=Shard(0), neither=Replicate()))

    def local(ql, kl, vl):
        off = q_offset
        if lay.split == "seq":
            off = q_offset + lay.coord * ql.shape[1]
        elif lay.split == "heads" and not kv_follow:
            h = ql.shape[2]
            kl, vl = (_local_kv(t, lay.coord * h, h, H // Hkv)
                      for t in (kl, vl))
        return _attention(ql, kl, vl, causal, off, kv_len, chunk)

    return lay.run(local, (q_pl,), (q_pl, kv_pl, kv_pl),
                   (q_pl, kv_grad, kv_grad), q, k, v)


def attn_out(p, ctx: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd", ctx, wo)``.  On DTensors it runs one
    shard a rank (:class:`_AttnLayout`): ``ctx`` keeps the attention core's
    placement and ``wo`` is gathered, but for its heads on ``model`` when
    those of ``ctx`` are split there.  The output is a partial sum on
    ``model`` (heads split), split as ``ctx``'s batch rows are, or split
    as the query sequence is and then gathered: the layer's residual
    stream keeps its sequence whole, as the FFN's matmul needs on torch
    2.11, which cannot flatten (b, s) with s split.  No gradient of
    ``ctx`` is split off head boundaries (an unsplit head count ``model``
    does not divide)."""
    wo = p["wo"]
    if not isinstance(ctx, DTensor) and not isinstance(wo, DTensor):
        return torch.einsum("bshk,hkd->bsd", ctx, wo)
    lay = _AttnLayout(ctx, wo)
    ctx_pl = lay.at(lay.by_split(heads=Shard(2), seq=Shard(1), rows=Shard(0),
                                 neither=Replicate()))
    wo_pl = lay.at(Shard(0) if lay.split == "heads" else Replicate(),
                   Replicate())
    wo_grad = lay.at(lay.by_split(heads=Shard(0), seq=Partial(),
                                  rows=Partial(), neither=Replicate()),
                     Partial())
    out_pl = lay.at(lay.by_split(heads=Partial(), seq=Shard(1),
                                 rows=Shard(0), neither=Replicate()))
    y = lay.run(functools.partial(torch.einsum, "bshk,hkd->bsd"), (out_pl,),
                (ctx_pl, wo_pl), (ctx_pl, wo_grad), ctx, wo)
    if lay.split == "seq":
        y = y.redistribute(lay.mesh, lay.at(Replicate()))
    return y
