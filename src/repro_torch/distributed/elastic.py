"""Elastic scaling: resume a job on a different device count, the port of
the JAX package's ``distributed/elastic.py``, and the placement of a model
and its state onto a ``DeviceMesh``.

Two pieces make the framework elastic:

1. **State re-sharding** — checkpoints are topology-free (full tensors +
   manifest, ``checkpoint/ckpt.py``; a DTensor tree is saved as its
   ``full_tensor()`` from rank 0), so resuming on a new mesh is just
   ``distribute_tensor`` with the new rules: :func:`reshard_tree`.
2. **Data re-partitioning** — the pipeline is stateless-deterministic in
   (seed, step) and takes (shard, num_shards) at construction
   (``data/pipeline.py``), so a new data-parallel degree re-partitions the
   same global stream with no drift: :func:`elastic_pipeline`.

The only constraint is divisibility (global_batch % new_dp == 0); the
driver validates and refuses otherwise.

:func:`distribute_lm` places an LM's parameters (one ``nn.Parameter`` a
leaf) as DTensors under the rules, and :func:`place_like` puts a tree of
full tensors (a restored checkpoint) where a template's DTensors are.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.checkpoint import flatten_with_paths, unflatten
from repro_torch.data import BatchPipeline, CompressedCorpus
from .sharding import (MeshRules, NamedSharding, default_rules, map_axes,
                       spec_for)


def distribute(tensor: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """``tensor`` (the same full tensor on every rank) as a DTensor placed
    by ``sharding``; a DTensor on the same mesh is redistributed."""
    if isinstance(tensor, DTensor):
        if tensor.device_mesh != sharding.mesh:
            raise ValueError("a DTensor moves to another mesh through a "
                             "checkpoint (full tensors), not in place")
        return tensor.redistribute(sharding.mesh, sharding.placements)
    return distribute_tensor(tensor, sharding.mesh, sharding.placements)


def reshard_tree(tree: Any, axes_tree: Any, mesh,
                 rules: Optional[MeshRules] = None) -> Any:
    """Place a (restored) tree onto a new mesh under the sharding rules."""
    rules = rules or default_rules(mesh)
    return map_axes(lambda axes, t: distribute(t, NamedSharding(
        mesh, spec_for(axes, t.shape, mesh, rules))), axes_tree, tree)


@torch.no_grad()
def distribute_lm(model, mesh, rules: Optional[MeshRules] = None):
    """Replace every parameter of ``model`` (a ``repro_torch`` LM, plain
    tensors, the same values on every rank) by a DTensor placed under the
    rules, in place.  Returns the model."""
    from repro_torch.models.layers import unbox
    params, axes = unbox(model.boxed_tree())
    placed = reshard_tree(params, axes, mesh, rules)

    def walk(node, tree):
        for name, p in list(node._parameters.items()):
            node._parameters[name] = torch.nn.Parameter(
                tree[name], requires_grad=p.requires_grad)
        for name, child in node.named_children():
            if isinstance(child, torch.nn.ModuleList):
                for c, t in zip(child, tree[name]):
                    walk(c, t)
            else:
                walk(child, tree[name])
    walk(model, placed)
    return model


def place_like(tree: Any, template: Any) -> Any:
    """``tree`` (full tensors, e.g. a restored checkpoint on the device)
    with each leaf placed as ``template``'s matching DTensor is; leaves
    whose template is not a DTensor are returned as they are."""
    out = []
    for (_, t), (_, ref) in zip(flatten_with_paths(tree),
                                flatten_with_paths(template)):
        if isinstance(ref, DTensor):
            t = distribute_tensor(torch.as_tensor(t).to(ref.device),
                                  ref.device_mesh, ref.placements)
        out.append(t)
    return unflatten(tree, out)


def elastic_pipeline(corpus: CompressedCorpus, *, global_batch: int,
                     seq_len: int, seed: int, resume_step: int,
                     shard: int, num_shards: int) -> BatchPipeline:
    if global_batch % num_shards:
        raise ValueError(
            f"elastic resize invalid: global_batch {global_batch} "
            f"not divisible by new dp degree {num_shards}")
    return BatchPipeline(corpus, global_batch=global_batch, seq_len=seq_len,
                         seed=seed, shard=shard, num_shards=num_shards,
                         start_step=resume_step, prefetch=0)
