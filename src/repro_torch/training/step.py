"""Loss and train/eval step factories, the port of the JAX package's
``training/step.py``.

``train_step(model, opt_state, batch) -> (model, opt_state, metrics)``
turns the model's parameters' gradients on, computes the loss and its
gradients with ``torch.autograd`` and applies :class:`AdamW` in place.
``opt_state``'s moments are in the JAX package's stacked layout
(``opt.init(lm_to_params(model))``); the update reaches them through
per-layer views (``models/convert.layer_views``).
With ``microbatches`` M > 1 the batch is split along its leading axis;
as in the JAX package, each microbatch's gradients (in the parameters'
dtype) are summed into float32 zeros, then divided by M — so a bfloat16
model's sum does not round at every microbatch, as ``.grad``'s own
accumulation would — and the loss and metrics are averaged.
A model whose parameters are DTensors (``distributed.distribute_lm``)
takes the same step on its mesh, in ``mesh_scope``: gradients and
moments are DTensors placed like their parameters, and the metrics come
back as plain tensors.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint import flatten_with_paths, unflatten
from repro_torch.models import apply_lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import layer_views, param_tree
from repro_torch.models.partitioning import mesh_scope
from .optimizer import AdamW, AdamWState

Z_LOSS = 1e-4
MOE_AUX = 1e-2


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over valid tokens + z-loss.  logits f32 [B,S,V].

    The JAX package takes the gold logit by a one-hot contraction, which
    keeps a vocabulary sharded over devices local.  So does the port on a
    mesh (DTensor logits); on one device it reads it with ``gather``,
    without a B*S*V float32 one-hot.  The sum of exact zeros and one
    value is the gathered value, bit for bit."""
    lse = torch.logsumexp(logits, dim=-1)
    if isinstance(logits, DTensor):
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        onehot = (labels.long()[..., None] == vocab).to(logits.dtype)
        gold = torch.sum(logits * onehot, dim=-1)
    else:
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    z = torch.square(lse)
    if mask is None:
        mask = torch.ones_like(nll)
    denom = torch.clamp(mask.sum(), min=1.0)
    return (nll * mask).sum() / denom, (z * mask).sum() / denom


def make_loss_fn(cfg: ModelConfig, remat=True,
                 unroll: bool = False) -> Callable:
    def loss_fn(model, batch: Dict) -> Tuple[torch.Tensor, Dict]:
        logits, aux = apply_lm(cfg, model, batch["tokens"],
                               extra_embeds=batch.get("extra_embeds"),
                               remat=remat, unroll=unroll)
        labels = torch.as_tensor(batch["labels"], device=logits.device)
        if cfg.family == "vlm" and batch.get("extra_embeds") is not None:
            # patches occupy the prefix; loss on text positions only
            logits = logits[:, -labels.shape[1]:, :]
        ce, z = cross_entropy(logits, labels)
        loss = ce + Z_LOSS * z + MOE_AUX * aux
        return loss, {"ce": ce, "z": z, "moe_aux": aux}
    return loss_fn


def _split(batch: Dict, m: int):
    """The batch's ``m`` microbatches along the leading axis (the JAX
    package's reshape to ``[m, B // m, ...]``).  A DTensor batch split over
    the mesh on its leading axis is split shard by shard: microbatch ``i``
    is every rank's ``i``-th slice of its own rows, so no rows move
    between ranks (on one rank, the same split)."""
    out = [{} for _ in range(m)]
    for k, v in batch.items():
        if v is None:
            continue
        if isinstance(v, DTensor):
            parts = _split_local(v, m)
        else:
            v = torch.as_tensor(v)
            if v.shape[0] % m:
                raise ValueError(f"batch of {v.shape[0]} does not split "
                                 f"into {m} microbatches")
            parts = v.reshape((m, v.shape[0] // m) + tuple(v.shape[1:]))
        for i, part in enumerate(parts):
            out[i][k] = part
    return out


def _split_local(v: DTensor, m: int):
    if any(p.is_shard() and p.dim != 0 for p in v.placements) or any(
            p.is_partial() for p in v.placements):
        raise ValueError(f"a batch placed {v.placements} does not split "
                         f"into microbatches shard by shard")
    local = v.to_local()
    if local.shape[0] % m:
        raise ValueError(f"a shard of {local.shape[0]} rows does not split "
                         f"into {m} microbatches")
    return [DTensor.from_local(part, v.device_mesh, v.placements,
                               run_check=False)
            for part in local.reshape((m, local.shape[0] // m)
                                      + tuple(local.shape[1:]))]


def make_train_step(cfg: ModelConfig, opt: AdamW, remat=True,
                    microbatches: int = 1, unroll: bool = False) -> Callable:
    loss_fn = make_loss_fn(cfg, remat=remat, unroll=unroll)

    def train_step(model, opt_state: AdamWState, batch: Dict):
        with mesh_scope(model):
            return _step(model, opt_state, batch)

    def _step(model, opt_state: AdamWState, batch: Dict):
        model.requires_grad_(True)
        params = param_tree(model)
        leaves = [p for _, p in flatten_with_paths(params)]

        def grads_of(mb):
            model.zero_grad(set_to_none=True)
            loss, metrics = loss_fn(model, mb)
            loss.backward()
            grads = [_grad(p) for p in leaves]
            model.zero_grad(set_to_none=True)
            return (loss.detach(),
                    {k: v.detach() for k, v in metrics.items()}, grads)

        if microbatches > 1:
            gsum, lsum, ms = None, 0.0, []
            for mb in _split(batch, microbatches):
                loss, m, g = grads_of(mb)
                if gsum is None:
                    gsum = [x.to(torch.float32, copy=True) for x in g]
                else:
                    torch._foreach_add_(gsum, g)
                del g
                lsum = lsum + loss
                ms.append(m)
            torch._foreach_div_(gsum, float(microbatches))
            grads = gsum
            loss = lsum / microbatches
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        else:
            loss, metrics, grads = grads_of(batch)
        # the gradients go to the optimizer as a tree of their own (a
        # float32 sum cannot sit in a bfloat16 ``.grad``)
        state = AdamWState(opt_state.count,
                           layer_views(cfg, opt_state.mu),
                           layer_views(cfg, opt_state.nu))
        _, state, opt_m = opt.update(unflatten(params, grads), state,
                                     params)
        metrics = {k: _full(v) for k, v in
                   dict(metrics, loss=loss, **opt_m).items()}
        return model, AdamWState(state.count, opt_state.mu,
                                 opt_state.nu), metrics

    return train_step


def _full(v: torch.Tensor) -> torch.Tensor:
    """A metric as a plain tensor: a DTensor's local value may be a
    partial sum, so it is reduced over the mesh first."""
    return v.full_tensor() if isinstance(v, DTensor) else v


def _grad(p: torch.Tensor) -> torch.Tensor:
    """``p``'s gradient; zeros where no loss term reached it (the JAX
    package's gradient tree has every leaf)."""
    return p.grad if p.grad is not None else torch.zeros_like(p)


def make_eval_step(cfg: ModelConfig) -> Callable:
    loss_fn = make_loss_fn(cfg, remat=False)

    @torch.no_grad()
    def eval_step(model, batch):
        loss, metrics = loss_fn(model, batch)
        return dict(metrics, loss=loss)

    return eval_step
