"""Distribution over cards: the sharding rules and DTensor placement of the
LM (``sharding``, ``elastic``), GPipe stages (``pipeline``), and
corpus-sharded packs (``shard_batch``: a :class:`CorpusMesh` splits a
pack's rows over cards, or repeated device stand-ins, and runs each shard
on its own host thread)."""

from .sharding import (MeshRules, MeshShape, NamedSharding, PartitionSpec,
                       default_rules, spec_for, param_shardings,
                       batch_shardings, batch_spec, cache_shardings,
                       replicated)
from .elastic import (reshard_tree, elastic_pipeline, distribute,
                      distribute_lm, place_like)
from .shard_batch import (CorpusMesh, corpus_mesh, mesh_size, pad_corpora,
                          run_sharded, shard_batch)

__all__ = ["MeshRules", "MeshShape", "NamedSharding", "PartitionSpec",
           "default_rules", "spec_for", "param_shardings",
           "batch_shardings", "batch_spec", "cache_shardings", "replicated",
           "reshard_tree", "elastic_pipeline", "distribute", "distribute_lm",
           "place_like",
           "CorpusMesh", "corpus_mesh", "mesh_size", "pad_corpora",
           "shard_batch", "run_sharded"]
