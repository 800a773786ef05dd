"""Activation-sharding policy hook (the JAX package's
``models/partitioning.py``).

The launcher installs a policy mapping *activation kinds* ("act_btd",
"attn_q", "logits") to :class:`~repro_torch.distributed.sharding.
PartitionSpec` s, and model code calls ``constrain(x, kind)`` at the few
load-bearing points (embedding output, layer carry, logits).  On a DTensor
``constrain`` redistributes ``x`` to the spec's placements over ``x``'s own
mesh — the counterpart of ``jax.lax.with_sharding_constraint`` under the
ambient mesh.  With no policy installed (tests, one device) it is the
identity; with a policy for ``kind`` installed, a plain tensor raises:
there is no mesh to place it on, and nothing is quietly ignored.

:func:`mesh_scope` is the scope model code runs in when its parameters
are DTensors: the constants it builds on the host side of each op
(positions, masks, rope tables, the learning rate) are plain tensors, and
``implicit_replication`` treats them as replicated over the mesh.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

_POLICY: Dict[str, tuple] = {}


def set_policy(policy: Optional[Dict[str, tuple]]) -> None:
    """Install ``{kind: PartitionSpec}`` (a spec is a tuple, one entry a
    tensor dim: ``None``, a mesh axis name or a tuple of names)."""
    global _POLICY
    policy = dict(policy or {})
    for kind, spec in policy.items():
        if not isinstance(spec, tuple):
            raise TypeError(f"policy for {kind!r}: expected a PartitionSpec "
                            f"(a tuple), got {type(spec).__name__}")
    _POLICY = policy


def get_policy() -> Dict[str, tuple]:
    return dict(_POLICY)


@contextlib.contextmanager
def activation_policy(policy: Dict[str, tuple]):
    old = get_policy()
    set_policy(policy)
    try:
        yield
    finally:
        set_policy(old)


def constrain(x, kind: str):
    spec = _POLICY.get(kind)
    if spec is None:
        return x
    if not isinstance(x, DTensor):
        raise TypeError(f"an activation policy for {kind!r} is installed, "
                        f"but the activation is a plain tensor (no mesh to "
                        f"place it on)")
    # imported here: the distributed package imports the models
    from repro_torch.distributed.sharding import NamedSharding
    placements = NamedSharding(x.device_mesh, spec).placements
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


_SCOPE = threading.local()


@contextlib.contextmanager
def mesh_scope(model):
    """``implicit_replication()`` when ``model``'s parameters are DTensors
    (a model on a mesh), else a scope that changes nothing.  Nested scopes
    are one scope: ``implicit_replication`` ends replication on its exit,
    so only the outermost one enters it."""
    p = next(model.parameters(), None)
    if not isinstance(p, DTensor) or getattr(_SCOPE, "active", False):
        yield
        return
    _SCOPE.active = True
    try:
        with implicit_replication():
            yield
    finally:
        _SCOPE.active = False
