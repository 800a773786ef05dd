"""The unified LM, the port of the JAX package's ``models/transformer.py``:
all 10 assigned architectures (dense GQA, MoE, hybrid Mamba+attention,
pure SSM, encoder-decoder, VLM) on one skeleton.

Entry points (the JAX package's, with the parameter tree replaced by the
:class:`LM` module):

  init_lm(cfg, generator, device)            -> LM
  apply_lm(cfg, model, tokens, ...)          -> (logits, aux)  (prefill)
  apply_layer(cfg, layer, x, kind)           -> x  (one layer: a stage)
  init_cache(cfg, batch, max_len, device)    -> decode cache
  decode_step(cfg, model, cache, tokens)     -> (logits, cache)
  prefill_cross(cfg, model, cache, frames)   -> cache (whisper)

DESIGN.  The JAX package scans stacked blocks of ``cfg.block_size``
layers (layer ``i = r*bs + p_pos``, params and cache stacked
``[repeats, ...]`` per block position).  The port holds one module per
layer (``model.layers[i]``, a ``ModuleList``) and runs them in a host
loop, but keeps the cache LAYOUT of ``init_cache`` — ``cache["layers"]
[p_pos]["k"]`` is ``[repeats, B, max_len, Hkv, hd]`` — so the two caches
compare entry by entry.  ``decode_step`` writes the cache in place and
returns it; ``cache["pos"]`` is a host ``int`` (no device sync a step),
where the JAX package threads an int32 scalar.  ``remat`` is the JAX
package's ``jax.checkpoint`` of each block: under autograd, ``True`` /
``"full"`` recomputes each layer (and each encoder layer) in the backward
pass (``torch.utils.checkpoint``), ``"dots"`` keeps the weight matmuls'
outputs and recomputes the rest; without gradients it changes nothing.
``unroll`` is an XLA compile control with no equivalent here: it is
accepted and changes nothing.  ``constrain`` marks the JAX package's
sharding points: the identity without an activation policy, a
redistribution of a DTensor with one (``models/partitioning.py``).  A
model whose parameters are DTensors (``distributed.distribute_lm``) runs
in ``mesh_scope``.

Parameters are created with ``requires_grad=False``, for the serving
path; the train step turns them on (``training/step.py``).  Whisper's
and Pixtral's frontends are stubs, as in the JAX package: the caller
passes frame / patch embeddings.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate
from torch.utils import checkpoint as ckpt

from repro_torch.kernels._common import resolve_device

from .config import ModelConfig
from .layers import (Boxed, _dtype, _qkv, apply_ffn, apply_rope, attn_out,
                     dense_init, gqa_attention, init_attention, init_ffn,
                     layer_norm, ones_init, rms_norm, rope_frequencies,
                     zeros_init)
from .moe import apply_moe, init_moe
from .partitioning import constrain, mesh_scope
from .ssm import (apply_mamba, apply_mamba_decode, init_mamba,
                  init_mamba_state)

ATTN_CHUNK_THRESHOLD = 8_192   # chunked (online-softmax) attention above this
ATTN_CHUNK = 1_024


# ------------------------------------------------------------ the module --
class ParamNode(nn.Module):
    """One node of the parameter tree: named parameters and child nodes,
    read as ``p["wq"]`` / ``"bq" in p`` like the JAX package's dicts.
    ``axes`` holds each direct parameter's logical axes."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        self.axes: Dict[str, Tuple] = {}
        for name, v in tree.items():
            if isinstance(v, dict):
                self.add_module(name, ParamNode(v))
            elif isinstance(v, list):
                self.add_module(name, nn.ModuleList(ParamNode(t) for t in v))
            else:
                self.register_parameter(
                    name, nn.Parameter(v.value, requires_grad=False))
                self.axes[name] = v.axes

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def boxed_tree(self) -> Dict[str, Any]:
        """The node as a nested dict of ``Boxed(parameter, axes)``."""
        out: Dict[str, Any] = {n: Boxed(p, self.axes[n])
                               for n, p in self._parameters.items()}
        for n, m in self._modules.items():
            out[n] = ([c.boxed_tree() for c in m]
                      if isinstance(m, nn.ModuleList) else m.boxed_tree())
        return out


class LM(ParamNode):
    """The port's LM: ``embed``, ``final_norm``, ``lm_head`` (untied),
    ``layers[i]`` (one node a layer), ``encoder`` (whisper:
    ``layers`` + ``final_norm``), ``patch_proj`` (pixtral)."""

    def __init__(self, cfg: ModelConfig, tree: Dict[str, Any]):
        super().__init__(tree)
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return self.embed.device


# ------------------------------------------------------------------ init --
def _init_norm(cfg, dt):
    if cfg.act == "gelu":   # whisper-style layernorm
        return {"scale": ones_init((cfg.d_model,), ("embed",), dt),
                "bias": zeros_init((cfg.d_model,), ("embed",), dt)}
    return {"scale": ones_init((cfg.d_model,), ("embed",), dt)}


def _apply_norm(cfg, p, x):
    if "bias" in p:
        return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rms_norm(x, p["scale"], cfg.norm_eps)


def _init_layer(gen, cfg: ModelConfig, kind: str, ffn_kind: str,
                cross: bool) -> Dict:
    dt = _dtype(cfg.dtype)
    p: Dict[str, Any] = {"norm1": _init_norm(cfg, dt)}
    if kind == "attn":
        p["attn"] = init_attention(gen, cfg)
    else:
        p["mamba"] = init_mamba(gen, cfg)
    if ffn_kind == "moe":
        p["norm2"] = _init_norm(cfg, dt)
        p["moe"] = init_moe(gen, cfg)
    elif cfg.d_ff > 0:
        p["norm2"] = _init_norm(cfg, dt)
        p["ffn"] = init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.act, dt)
    if cross:
        p["cross_norm"] = _init_norm(cfg, dt)
        p["cross"] = init_attention(gen, cfg)
    return p


def init_tree(cfg: ModelConfig, gen: Optional[torch.Generator]) -> Dict:
    """The per-layer Boxed tree on the host: random values drawn from
    ``gen``, or unset values when ``gen`` is None (a skeleton)."""
    dt = _dtype(cfg.dtype)
    bs = cfg.block_size
    if cfg.num_layers % bs:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not a "
                         f"multiple of the block size {bs}")
    cross = cfg.family == "encdec"
    tree: Dict[str, Any] = {
        "embed": dense_init(gen, (cfg.vocab_size, cfg.d_model),
                            ("vocab", "embed"), dt, scale=0.02),
        "final_norm": _init_norm(cfg, dt),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                     ("embed", "vocab"), dt)
    tree["layers"] = [_init_layer(gen, cfg, cfg.layer_kind(i),
                                  cfg.layer_ffn(i), cross)
                      for i in range(cfg.num_layers)]
    if cfg.family == "encdec":
        tree["encoder"] = {
            "layers": [_init_layer(gen, cfg, "attn", "dense", cross=False)
                       for _ in range(cfg.encoder_layers)],
            "final_norm": _init_norm(cfg, dt),
        }
    if cfg.family == "vlm":
        tree["patch_proj"] = dense_init(gen, (cfg.d_model, cfg.d_model),
                                        ("embed", None), dt)
    return tree


def init_lm(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
            device=None) -> LM:
    """A randomly initialised LM on ``device`` (the card unless the caller
    asks for the CPU).  Values are drawn on the host from ``generator``
    (default: seed 0), so one seed gives the same weights on every
    device."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return LM(cfg, init_tree(cfg, generator)).to(dev)


# --------------------------------------------------------------- forward --
def _sinusoid(seq: int, d: int) -> np.ndarray:
    pos = np.arange(seq)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10_000.0, 2 * i / d)
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)


def _sinusoid_at(pos: torch.Tensor, d: int) -> torch.Tensor:
    """Single-position sinusoid in float32 (decode path)."""
    i = torch.arange(d // 2, device=pos.device)
    ang = pos.float() / torch.pow(10_000.0, 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _inv_freq(cfg, device) -> torch.Tensor:
    return torch.from_numpy(rope_frequencies(
        cfg.resolved_head_dim, cfg.rope_fraction, cfg.rope_theta)).to(device)


def _mixer(cfg, p, x, positions, inv_freq, *, kind, chunk, enc_out=None):
    h = _apply_norm(cfg, p["norm1"], x)
    if kind == "attn":
        q, k, v = _qkv(p["attn"], h, cfg)
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
        q = constrain(q, "attn_q")
        ctx = gqa_attention(q, k, v, causal=True, chunk=chunk)
        x = x + attn_out(p["attn"], ctx)
    else:
        x = x + apply_mamba(p["mamba"], h, cfg)
    if enc_out is not None and "cross" in p:
        h = _apply_norm(cfg, p["cross_norm"], x)
        q = torch.einsum("bsd,dhk->bshk", h, p["cross"]["wq"])
        q = constrain(q, "attn_q")
        k = torch.einsum("bsd,dhk->bshk", enc_out, p["cross"]["wk"])
        v = torch.einsum("bsd,dhk->bshk", enc_out, p["cross"]["wv"])
        if "bq" in p["cross"]:
            q = q + p["cross"]["bq"]
            k = k + p["cross"]["bk"]
            v = v + p["cross"]["bv"]
        ctx = gqa_attention(q, k, v, causal=False, chunk=0)
        x = x + attn_out(p["cross"], ctx)
    return x


def _ffn_block(cfg, p, x):
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if "moe" in p:
        h = _apply_norm(cfg, p["norm2"], x)
        y, aux = apply_moe(p["moe"], h, cfg)
        return x + y, aux
    if "ffn" in p:
        h = _apply_norm(cfg, p["norm2"], x)
        return x + apply_ffn(p["ffn"], h, cfg.act), zero
    return x, zero   # mixer-only layer (mamba2)


# --------------------------------------------------------------- remat --
_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep
    the weight matmuls' outputs, recompute everything else."""
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(remat, model: LM) -> Callable:
    """``f -> f'`` running ``f(*args)`` under ``remat`` when gradients
    flow into the model's parameters, else ``f`` itself."""
    if not remat or not torch.is_grad_enabled() or not any(
            p.requires_grad for p in model.parameters()):
        return lambda f: f
    # the forward draws no random numbers: no RNG state to carry over
    opts = dict(use_reentrant=False, preserve_rng_state=False)
    if remat == "dots":
        opts["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)
    elif remat not in (True, "full"):
        raise ValueError(f"unknown remat {remat!r}; expected True, False, "
                         f"'full' or 'dots'")
    return lambda f: functools.partial(ckpt.checkpoint, f, **opts)


def _encoder(cfg, model, frames: torch.Tensor,
             wrap: Callable = lambda f: f) -> torch.Tensor:
    """Whisper encoder over stub frame embeddings [B, T, d] (no rope: the
    sinusoid is added once).  ``wrap`` is the remat of each layer."""
    x = frames + torch.from_numpy(_sinusoid(frames.shape[1], cfg.d_model)
                                  ).to(frames.device, frames.dtype)

    def body(x, layer):
        h = _apply_norm(cfg, layer["norm1"], x)
        q, k, v = _qkv(layer["attn"], h, cfg)
        ctx = gqa_attention(q, k, v, causal=False, chunk=0)
        x = x + attn_out(layer["attn"], ctx)
        x, _ = _ffn_block(cfg, layer, x)
        return constrain(x, "act_btd")

    for layer in model["encoder"]["layers"]:
        x = wrap(functools.partial(body, layer=layer))(x)
    return _apply_norm(cfg, model["encoder"]["final_norm"], x)


def _as_tokens(tokens, device) -> torch.Tensor:
    return torch.as_tensor(tokens, device=device).long()


def _embed(model, tokens: torch.Tensor, dt) -> torch.Tensor:
    """The token embeddings ``embed[tokens]`` in ``dt``, by ``F.embedding``
    (the same rows, bit for bit).  On a mesh the table's vocabulary shards
    are gathered over the mesh dims that split them first: the JAX
    package's gather of a vocabulary-sharded table fails to partition,
    and DTensor's masked strategy for it fails to reduce when the tokens
    are split over another mesh dim.  The ``embed`` dim stays sharded."""
    table = model["embed"]
    if isinstance(table, DTensor) and any(
            p.is_shard(0) for p in table.placements):
        table = table.redistribute(table.device_mesh, [
            Replicate() if p.is_shard(0) else p for p in table.placements])
    return F.embedding(tokens, table.to(dt))


def _on_mesh(fn: Callable) -> Callable:
    """Run ``fn(cfg, model, ...)`` in ``mesh_scope(model)``."""
    @functools.wraps(fn)
    def wrapped(cfg, model, *args, **kwargs):
        with mesh_scope(model):
            return fn(cfg, model, *args, **kwargs)
    return wrapped


def _logits(cfg, model, x, dt):
    x = _apply_norm(cfg, model["final_norm"], x)
    head = model["embed"].T if cfg.tie_embeddings else model["lm_head"]
    logits = (x @ head.to(dt)).float()
    return constrain(logits, "logits")


@_on_mesh
def apply_lm(cfg: ModelConfig, model: LM, tokens,
             extra_embeds=None, remat: bool = True, unroll: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits [B, S(, +P), V] float32, moe aux loss scalar).

    ``extra_embeds``: whisper frame embeddings [B, T, d] (encoder input) or
    pixtral patch embeddings [B, P, d] (prepended to the text sequence).
    ``remat`` recomputes layers in the backward pass, ``unroll`` has no
    equivalent here (module note).
    """
    dt = _dtype(cfg.dtype)
    dev = model.device
    wrap = _remat(remat, model)
    tokens = _as_tokens(tokens, dev)
    x = _embed(model, tokens, dt)
    enc_out = None
    if extra_embeds is not None:
        extra_embeds = torch.as_tensor(extra_embeds, device=dev).to(dt)
    if cfg.family == "encdec":
        if extra_embeds is None:
            raise ValueError(f"{cfg.name} needs frame embeddings "
                             f"(extra_embeds [B, T, d])")
        # the JAX package remats the encoder's layers whatever ``remat``
        enc_out = _encoder(cfg, model, extra_embeds, _remat(True, model))
        x = x + torch.from_numpy(_sinusoid(x.shape[1], cfg.d_model)
                                 ).to(dev, dt)
    elif cfg.family == "vlm" and extra_embeds is not None:
        patches = extra_embeds @ model["patch_proj"]
        x = torch.cat([patches, x], dim=1)

    x = constrain(x, "act_btd")
    B, S, _ = x.shape
    positions = torch.arange(S, device=dev).expand(B, S)
    inv_freq = _inv_freq(cfg, dev)
    chunk = ATTN_CHUNK if S > ATTN_CHUNK_THRESHOLD else 0

    def layer(x, lp, kind):
        x = _mixer(cfg, lp, x, positions, inv_freq, kind=kind, chunk=chunk,
                   enc_out=enc_out)
        x, a = _ffn_block(cfg, lp, x)
        return constrain(x, "act_btd"), a

    aux = torch.zeros((), dtype=torch.float32, device=dev)
    for i, lp in enumerate(model["layers"]):
        x, a = wrap(functools.partial(layer, lp=lp,
                                      kind=cfg.layer_kind(i)))(x)
        aux = aux + a
    return _logits(cfg, model, x, dt), aux


def apply_layer(cfg: ModelConfig, lp, x: torch.Tensor, kind: str = "attn"
                ) -> torch.Tensor:
    """One decoder layer of ``apply_lm`` (mixer, then FFN or MoE) on
    activations ``x`` [B, S, d] at positions 0..S-1, without its MoE aux
    loss: a stage's unit of work in a pipeline.  ``lp`` is one layer's
    parameters (``model.layers[i]`` or a dict of the same leaves)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    chunk = ATTN_CHUNK if S > ATTN_CHUNK_THRESHOLD else 0
    x = _mixer(cfg, lp, x, positions, _inv_freq(cfg, x.device), kind=kind,
               chunk=chunk)
    return _ffn_block(cfg, lp, x)[0]


# ---------------------------------------------------------------- decode --
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> Dict:
    """Pre-allocated decode cache on ``device`` (the card unless the
    caller asks for the CPU): KV rings for attention layers, SSD state for
    mamba layers, cross-attention KV for encdec — the JAX package's layout,
    ``[repeats, ...]`` per block position.  ``pos`` is a host int.
    ``device="meta"`` builds the shapes only (what the sharding rules
    read), at any size."""
    dev = (torch.device("meta") if str(device) == "meta"
           else resolve_device(device))
    dt = _dtype(cfg.dtype)
    hd = cfg.resolved_head_dim
    bs = cfg.block_size
    repeats = cfg.num_layers // bs
    cache: Dict[str, Any] = {"pos": 0, "layers": []}
    for p_pos in range(bs):
        if cfg.layer_kind(p_pos) == "attn":
            shape = (repeats, batch, max_len, cfg.num_kv_heads, hd)
            entry = {"k": torch.zeros(shape, dtype=dt, device=dev),
                     "v": torch.zeros(shape, dtype=dt, device=dev)}
        else:
            st = init_mamba_state(cfg, batch, dt, dev)
            entry = {k: torch.zeros((repeats,) + v.shape, dtype=v.dtype,
                                    device=dev) for k, v in st.items()}
        cache["layers"].append(entry)
    if cfg.family == "encdec":
        cache["cross_k"] = torch.zeros(
            (cfg.num_layers, batch, cfg.encoder_seq, cfg.num_kv_heads, hd),
            dtype=dt, device=dev)
        cache["cross_v"] = torch.zeros_like(cache["cross_k"])
    return cache


@_on_mesh
def decode_step(cfg: ModelConfig, model: LM, cache: Dict, tokens,
                unroll: bool = False) -> Tuple[torch.Tensor, Dict]:
    """One decode step for the whole batch.  tokens: [B, 1] -> logits
    [B, 1, V].  ``cache["pos"]`` is the write position (tokens so far);
    the cache is written in place and returned with ``pos + 1``."""
    dt = _dtype(cfg.dtype)
    dev = model.device
    tokens = _as_tokens(tokens, dev)
    x = _embed(model, tokens, dt)                     # [B, 1, d]
    B = x.shape[0]
    pos = int(cache["pos"])
    if cfg.family == "encdec":
        x = x + _sinusoid_at(torch.tensor([pos], device=dev),
                             cfg.d_model).to(dt)[None, :]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=dev)
    inv_freq = _inv_freq(cfg, dev)

    bs = cfg.block_size
    repeats = cfg.num_layers // bs
    if cfg.family == "encdec":
        # the JAX package reads cross K/V as [repeats, bs, ...][:, 0]
        cross_k = cache["cross_k"].reshape(
            (repeats, bs) + cache["cross_k"].shape[1:])[:, 0]
        cross_v = cache["cross_v"].reshape(
            (repeats, bs) + cache["cross_v"].shape[1:])[:, 0]

    for i, lp in enumerate(model["layers"]):
        r, p_pos = divmod(i, bs)
        ce = cache["layers"][p_pos]
        h = _apply_norm(cfg, lp["norm1"], x)
        if cfg.layer_kind(p_pos) == "attn":
            q, k1, v1 = _qkv(lp["attn"], h, cfg)
            q = apply_rope(q, positions, inv_freq)
            k1 = apply_rope(k1, positions, inv_freq)
            k, v = ce["k"][r], ce["v"][r]
            k[:, pos:pos + 1] = k1
            v[:, pos:pos + 1] = v1
            ctx = gqa_attention(q, k, v, causal=False, q_offset=pos,
                                kv_len=pos + 1, chunk=0)
            x = x + attn_out(lp["attn"], ctx)
        else:
            y, st = apply_mamba_decode(
                lp["mamba"], h, {"h": ce["h"][r], "conv": ce["conv"][r]},
                cfg)
            x = x + y
            ce["h"][r] = st["h"]
            ce["conv"][r] = st["conv"]
        if "cross" in lp:
            hc = _apply_norm(cfg, lp["cross_norm"], x)
            q = torch.einsum("bsd,dhk->bshk", hc, lp["cross"]["wq"])
            if "bq" in lp["cross"]:
                q = q + lp["cross"]["bq"]
            ctx = gqa_attention(q, cross_k[r], cross_v[r], causal=False,
                                chunk=0)
            x = x + attn_out(lp["cross"], ctx)
        x, _ = _ffn_block(cfg, lp, x)
        x = constrain(x, "act_btd")

    logits = _logits(cfg, model, x, dt)
    cache["pos"] = pos + 1
    return logits, cache


def prefill_cross(cfg: ModelConfig, model: LM, cache: Dict,
                  frames) -> Dict:
    """Run the whisper encoder once and fill the cross-attention K/V, in
    the JAX package's order: block position major, repeat minor."""
    dt = _dtype(cfg.dtype)
    dev = model.device
    enc_out = _encoder(cfg, model, torch.as_tensor(frames, device=dev).to(dt))
    bs = cfg.block_size
    ks, vs = [], []
    for p_pos in range(bs):
        for lp in list(model["layers"])[p_pos::bs]:
            cr = lp["cross"]
            k = torch.einsum("bsd,dhk->bshk", enc_out, cr["wk"])
            v = torch.einsum("bsd,dhk->bshk", enc_out, cr["wv"])
            if "bk" in cr:
                k, v = k + cr["bk"], v + cr["bv"]
            ks.append(k)
            vs.append(v)
    cache["cross_k"] = torch.stack(ks).to(cache["cross_k"].dtype)
    cache["cross_v"] = torch.stack(vs).to(cache["cross_v"].dtype)
    return cache
