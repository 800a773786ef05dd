"""The corpus-mesh probe of the JAX package's ``distributed/shard_batch.py``.

There, :func:`corpus_mesh` builds a 1-D device mesh over the local devices
and the serving layer splits large chunks row-wise across it; with fewer
than two devices it returns ``None`` and everything runs the plain
single-device pack.  The port keeps that contract for one card —
``corpus_mesh()`` is ``None`` and ``mesh_size(None)`` is 1 — and refuses
two or more cards instead of quietly serving them unsharded: sharding a
pack across cards is not ported yet (ROADMAP.md, queue 1 item 6).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["corpus_mesh", "mesh_size"]


def corpus_mesh(devices: Optional[Sequence] = None):
    """``None`` when fewer than two devices are given (default: the
    visible CUDA cards), as in the JAX package; raises
    ``NotImplementedError`` for two or more."""
    n = torch.cuda.device_count() if devices is None else len(devices)
    if n < 2:
        return None
    raise NotImplementedError(
        f"{n} cards are visible, and sharding a pack across cards is not "
        f"ported yet (ROADMAP.md, queue 1 item 6); pass mesh=None to "
        f"serve on one card")


def mesh_size(mesh) -> int:
    """Device count of a corpus mesh (1 for the ``None`` single-device
    case, the only mesh the port has)."""
    if mesh is not None:
        raise NotImplementedError(
            "sharding a pack across cards is not ported yet (ROADMAP.md, "
            "queue 1 item 6)")
    return 1
