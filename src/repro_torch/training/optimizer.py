"""AdamW with global-norm clipping, the port of the JAX package's
``training/optimizer.py``, in its arithmetic.

Moments are float32 whatever the parameter dtype; the clip norm, the
bias corrections ``c1``/``c2`` and the learning rate (warmup, cosine)
are float32 tensors on the parameters' device, so a step never waits on
the host; each new parameter is computed in float32 and cast back to
the parameter's dtype.  ``torch.optim.AdamW`` is not used: it keeps a
bfloat16 parameter's moments in bfloat16 and applies the decay in
another order.

The state is a tree like the parameters (``mu`` / ``nu`` mirror it leaf
by leaf), so the checkpoint flattener gives the JAX package's keys.
``update`` runs under ``no_grad`` and writes the parameters and moments
in place (the counterpart of ``donate_argnums``); it returns them with
the new count and the metrics ``grad_norm`` and ``lr``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, NamedTuple, Tuple

import torch

from repro_torch.checkpoint import flatten_with_paths, unflatten

# leaves updated together: bounds the float32 temporaries of one update
_GROUP_BYTES = 1 << 28


class AdamWState(NamedTuple):
    count: torch.Tensor     # int32 scalar: updates applied so far
    mu: Any
    nu: Any


def _leaves(tree) -> Tuple[List[str], List[torch.Tensor]]:
    flat = flatten_with_paths(tree)
    return [k for k, _ in flat], [v for _, v in flat]


def _groups(tensors: List[torch.Tensor]):
    """Index ranges of consecutive leaves of about ``_GROUP_BYTES`` of
    float32 each."""
    lo, size = 0, 0
    for i, t in enumerate(tensors):
        size += 4 * t.numel()
        if size >= _GROUP_BYTES:
            yield lo, i + 1
            lo, size = i + 1, 0
    if lo < len(tensors):
        yield lo, len(tensors)


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 0
    schedule: str = "constant"       # constant | cosine
    total_steps: int = 0

    def init(self, params) -> AdamWState:
        """Zero float32 moments shaped like ``params`` (a tree of
        tensors), on their device."""
        _, leaves = _leaves(params)
        dev = leaves[0].device if leaves else torch.device("cpu")

        def zeros():
            # ``zeros_like``: a DTensor leaf gets moments placed as it is
            return unflatten(params, [
                torch.zeros_like(p, dtype=torch.float32) for p in leaves])
        return AdamWState(count=torch.zeros((), dtype=torch.int32,
                                            device=dev),
                          mu=zeros(), nu=zeros())

    def _lr_at(self, step: torch.Tensor) -> torch.Tensor:
        lr = torch.tensor(self.lr, dtype=torch.float32, device=step.device)
        if self.warmup_steps:
            lr = lr * torch.clamp((step + 1) / self.warmup_steps, max=1.0)
        if self.schedule == "cosine" and self.total_steps:
            frac = torch.clamp((step - self.warmup_steps) /
                               max(self.total_steps - self.warmup_steps, 1),
                               0.0, 1.0)
            lr = lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return lr

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params
               ) -> Tuple[Any, AdamWState, dict]:
        """One step: ``params`` and the moments of ``state`` are written
        in place and returned with the count advanced.  ``grads`` (any
        dtype) is read, never written."""
        keys, ps = _leaves(params)
        gkeys, gs = _leaves(grads)
        mkeys, ms = _leaves(state.mu)
        nkeys, vs = _leaves(state.nu)
        if not keys == gkeys == mkeys == nkeys:
            raise ValueError("params, grads and moments are not one tree")
        dev = state.count.device

        # global-norm clip (float32 accumulation)
        sq = [torch.sum(torch.square(g.float())) for g in gs]
        gnorm = torch.sqrt(torch.stack(sq).sum()) if sq else \
            torch.zeros((), device=dev)
        scale = (torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
                 if self.clip_norm else torch.ones((), device=dev))

        step = state.count
        lr = self._lr_at(step)
        b1, b2 = self.b1, self.b2
        c1 = 1.0 - torch.pow(b1, step.float() + 1)
        c2 = 1.0 - torch.pow(b2, step.float() + 1)

        for lo, hi in _groups(ps):
            p, m, v = ps[lo:hi], ms[lo:hi], vs[lo:hi]
            g = [x.to(torch.float32, copy=True) for x in gs[lo:hi]]
            torch._foreach_mul_(g, scale)
            # the JAX package's order of float32 roundings, term by term
            # (no fused multiply-adds): m = b1*m + (1-b1)*g, ...
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
            torch._foreach_mul_(v, b2)
            torch._foreach_mul_(g, g)
            torch._foreach_mul_(g, 1 - b2)
            torch._foreach_add_(v, g)
            del g
            delta = torch._foreach_div(m, c1)              # mhat
            denom = torch._foreach_div(v, c2)              # vhat
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            torch._foreach_div_(delta, denom)
            del denom
            p32 = [x.float() for x in p]
            if self.weight_decay:
                torch._foreach_add_(delta, torch._foreach_mul(
                    p32, self.weight_decay))
            torch._foreach_mul_(delta, lr)
            new = torch._foreach_sub(p32, delta)
            del delta, p32
            for dst, src in zip(p, new):
                dst.copy_(src)

        return (params, AdamWState(count=step + 1, mu=state.mu,
                                   nu=state.nu),
                {"grad_norm": gnorm, "lr": lr})
