"""Batched serving of the LM zoo: prefill and decode step factories and a
greedy host loop, the port of the JAX package's ``serving/decode.py``.

``serve_step`` feeds one new token for the whole batch against the
pre-allocated cache (KV rings for attention layers, O(1) SSD state for
mamba layers) and picks the next token: greedy (``argmax``, first index
on ties, as ``jnp.argmax``) or categorical by the Gumbel-max trick, as
``jax.random.categorical`` samples, from an explicit ``torch.Generator``
on the model's device.  Steps run under ``torch.no_grad``; the cache is
written in place.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.kernels._common import resolve_device
from repro_torch.models import (apply_lm, decode_step, init_cache,
                                prefill_cross)
from repro_torch.models.config import ModelConfig


def _argmax(x: torch.Tensor) -> torch.Tensor:
    """``argmax`` over the last (vocabulary) dim.  DTensor's argmax over a
    split dim mis-shapes its gather of the shards' maxima (torch 2.13, on
    gloo and fake groups alike), so a split vocabulary is gathered
    first."""
    if isinstance(x, DTensor):
        last = x.ndim - 1
        x = x.redistribute(x.device_mesh, [
            Replicate() if p.is_shard(last) else p for p in x.placements])
    return torch.argmax(x, dim=-1)


def make_serve_step(cfg: ModelConfig, sample: str = "greedy",
                    temperature: float = 1.0,
                    unroll: bool = False) -> Callable:
    if sample not in ("greedy", "categorical"):
        raise ValueError(f"unknown sampling {sample!r}; expected 'greedy' "
                         f"or 'categorical'")

    @torch.no_grad()
    def serve_step(model, cache, tokens,
                   generator: Optional[torch.Generator] = None):
        logits, cache = decode_step(cfg, model, cache, tokens, unroll=unroll)
        last = logits[:, -1, :]
        if sample == "greedy":
            nxt = _argmax(last)
        else:
            if generator is None:
                raise ValueError("categorical sampling needs a generator")
            u = torch.rand(last.shape, generator=generator,
                           device=last.device)
            u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
            nxt = _argmax(last / temperature - torch.log(-torch.log(u)))
        return nxt.to(torch.int32)[:, None], cache, logits
    return serve_step


def make_prefill_step(cfg: ModelConfig, unroll: bool = False) -> Callable:
    """Prefill: run the full prompt, return its logits.  (Cache writing
    during prefill is decode-loop based, as in the JAX package.)"""
    @torch.no_grad()
    def prefill(model, tokens, extra_embeds=None):
        logits, _ = apply_lm(cfg, model, tokens, extra_embeds=extra_embeds,
                             remat=False, unroll=unroll)
        return logits
    return prefill


def greedy_generate(cfg: ModelConfig, model, prompt, steps: int,
                    max_len: Optional[int] = None, extra_embeds=None,
                    device=None) -> torch.Tensor:
    """Host loop: feed the prompt token by token, then generate ``steps``
    more.  Returns [B, steps] generated ids.  Runs on ``device`` (the card
    unless the caller asks for the CPU), where the model must already be."""
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"the model is on {model.device}, not on {dev}")
    prompt = torch.as_tensor(prompt, device=dev)
    B, P = prompt.shape
    max_len = max_len or (P + steps)
    cache = init_cache(cfg, B, max_len, device=dev)
    if cfg.family == "encdec":
        cache = prefill_cross(cfg, model, cache, extra_embeds)
    step = make_serve_step(cfg)
    tok = None
    for t in range(P):
        tok, cache, _ = step(model, cache, prompt[:, t:t + 1])
    out = []
    for _ in range(steps):
        out.append(tok)
        tok, cache, _ = step(model, cache, tok)
    return torch.cat(out, dim=1)
