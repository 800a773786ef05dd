"""Gradient compression for the cross-node reduction, the port of the
JAX package's ``training/grad_compress.py``.

* **top-k sparsification with error feedback**: keep the k largest-|g|
  entries of each tensor, carry the residual in a local error buffer
  added back the next step;
* **int8 quantization** with a per-tensor scale (1 byte an entry + a
  4-byte scale), rounding half to even (``torch.round``, as
  ``jnp.round``).

Both map a gradient tree (nested dicts, lists, tuples of tensors) to a
tree of the same structure; the dense shapes stay (zeros off the
support) and the wire bytes are counted apart (:func:`topk_wire_bytes`).
On one device there is no reduction to compress: these are the
transforms and their exactness, for the multi-card trainer.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.checkpoint import flatten_with_paths, unflatten


def _map(fn, *trees):
    """``fn`` over the leaves of trees of one structure; a tree of
    results (a tuple result gives a tuple of trees)."""
    cols = [[v for _, v in flatten_with_paths(t)] for t in trees]
    out = [fn(*leaves) for leaves in zip(*cols)]
    if out and isinstance(out[0], tuple):
        return tuple(unflatten(trees[0], list(o)) for o in zip(*out))
    return unflatten(trees[0], out)


# ----------------------------------------------------------------- top-k --
def topk_compress(grads, error, k_frac: float = 0.01):
    """Returns (sparse_grads, new_error).  sparse_grads has the same dense
    shape (zeros off-support) — the wire format would send (idx, val)
    pairs.  The threshold is the k-th largest |entry|: every entry at
    least that large is kept, so ties cannot depend on the order."""
    def one(g, e):
        g = g.float() + e
        n = g.numel()
        k = max(1, int(n * k_frac))
        flat = g.reshape(-1)
        thresh = torch.topk(torch.abs(flat), k).values[-1]
        mask = torch.abs(flat) >= thresh
        kept = torch.where(mask, flat, 0.0)
        return kept.reshape(g.shape), (flat - kept).reshape(g.shape)
    return _map(one, grads, error)


def init_error(params):
    # ``zeros_like``: a DTensor leaf's error buffer is placed as it is
    return _map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def topk_wire_bytes(params, k_frac: float) -> int:
    """Bytes on the wire per step for (int32 idx, f32 val) pairs."""
    total = 0
    for _, p in flatten_with_paths(params):
        k = max(1, int(p.numel() * k_frac))
        total += k * 8
    return total


# ------------------------------------------------------------------ int8 --
def _div32(a: torch.Tensor, b) -> torch.Tensor:
    """``a / b`` of float32 operands rounded once to float32, as IEEE
    division (and the JAX package) gives it, on every device: a CUDA
    division by a scalar multiplies by its reciprocal, one rounding
    more.  The quotient is taken in float64 and rounded to float32,
    which for float32 operands is the correctly rounded quotient."""
    return (a.double() / b).float()


def int8_quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    g = g.float()
    scale = _div32(torch.max(torch.abs(g)), 127.0) + 1e-12
    q = torch.clamp(torch.round(_div32(g, scale.double())), -127, 127
                    ).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def int8_roundtrip(grads):
    """Quantize+dequantize a tree (what the wire sees)."""
    def one(g):
        q, s = int8_quantize(g)
        return int8_dequantize(q, s).to(g.dtype)
    return _map(one, grads)
