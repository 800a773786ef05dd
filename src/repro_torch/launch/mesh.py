"""Mesh factories, the port of the JAX package's ``launch/mesh.py``.

Single pod: (data=16, model=16) = 256 cards.  Multi-pod: (pod=2, data=16,
model=16) = 512 cards, the "pod" axis the boundary between two pods'
fabrics.  :func:`make_production_mesh` returns these as device-free
:class:`~repro_torch.distributed.sharding.MeshShape` s: the sharding rules
need only names and sizes, so they run at production size anywhere.
:func:`make_host_mesh` is a ``DeviceMesh`` over the process group's
world, one rank a card (or a CPU rank under gloo).

FUNCTIONS, not module constants: importing this module touches no device
and no process-group state.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.distributed.sharding import MeshShape


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshShape(shape, axes)


def make_host_mesh(model: int = 1, data: Optional[int] = None,
                   device_type: Optional[str] = None):
    """A ``(data, model)`` DeviceMesh over every rank of the initialised
    process group.  ``device_type`` defaults to ``"cuda"`` under NCCL and
    ``"cpu"`` otherwise.  Raises when ``data * model`` is not the world
    size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    n = dist.get_world_size()
    data = data or (n // model)
    if data * model != n:
        raise ValueError(f"a {data}x{model} mesh needs {data * model} "
                         f"ranks; the world has {n}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))
