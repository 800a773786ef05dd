"""Distribution over cards: corpus-sharded packs (``shard_batch``).  A
:class:`CorpusMesh` splits a pack's rows over cards (or repeated device
stand-ins) and runs each shard on its own host thread."""

from .shard_batch import (CorpusMesh, corpus_mesh, mesh_size, pad_corpora,
                          run_sharded, shard_batch)

__all__ = ["CorpusMesh", "corpus_mesh", "mesh_size", "pad_corpora",
           "shard_batch", "run_sharded"]
