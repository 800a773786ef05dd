"""Distribution over cards: so far only the corpus-mesh probe the serving
layer reads (``corpus_mesh`` / ``mesh_size``); sharding a pack across
cards is not ported yet."""

from .shard_batch import corpus_mesh, mesh_size

__all__ = ["corpus_mesh", "mesh_size"]
