"""Activation-sharding policy hook (the JAX package's
``models/partitioning.py``).

The launcher installs a policy mapping *activation kinds* ("act_btd",
"attn_q", "logits") to shardings, and model code calls
``constrain(x, kind)`` at the few load-bearing points.  With no policy
installed (tests, one device) ``constrain`` is the identity, exactly as
the JAX version is in every single-device run.

A policy means something only once the sharding layer (the JAX package's
``distributed/sharding.py``) is ported.  Until then installing a
non-empty policy raises ``NotImplementedError`` rather than being
silently ignored.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

_POLICY: Dict[str, object] = {}

_NOT_PORTED = ("activation sharding policies need the sharding layer "
               "(distributed/sharding.py), which the port does not have yet")


def set_policy(policy: Optional[Dict[str, object]]) -> None:
    global _POLICY
    if policy:
        raise NotImplementedError(_NOT_PORTED)
    _POLICY = {}


def get_policy() -> Dict[str, object]:
    return dict(_POLICY)


@contextlib.contextmanager
def activation_policy(policy: Dict[str, object]):
    old = get_policy()
    set_policy(policy)
    try:
        yield
    finally:
        set_policy(old)


def constrain(x, kind: str):
    if _POLICY.get(kind) is None:
        return x
    raise NotImplementedError(_NOT_PORTED)
