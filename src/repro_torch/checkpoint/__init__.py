"""Checkpointing, ported: sharded npz + JSON manifest, atomic ``LATEST``
publish, keep-last-k GC, and mid-ingest snapshots of a
:class:`~repro_torch.data.CompressedCorpus` — in the JAX package's on-disk
format, so a checkpoint written by either package restores in the other."""

from .ckpt import (CheckpointManager, flatten_with_paths, latest_step,
                   restore_checkpoint, restore_corpus, save_checkpoint,
                   save_corpus)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "save_corpus", "restore_corpus", "CheckpointManager",
           "flatten_with_paths"]
