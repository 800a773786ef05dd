"""Data plane, ported: the word-level tokenizer, the synthetic corpus
generators (host-side numpy, identical to the JAX package's) and the
compressed corpus store (``CompressedCorpus``: build, append, save/load,
window reads, epoch-stamped traversal memos on the device) and the
trainer's deterministic batch pipeline over it (``BatchPipeline``, windows
expanded from the grammar, bit-equal to the JAX package's batches)."""

from .tokenizer import Tokenizer
from .store import CompressedCorpus
from .pipeline import BatchPipeline, PipelineState
from . import synthetic

__all__ = ["Tokenizer", "CompressedCorpus", "BatchPipeline", "PipelineState",
           "synthetic"]
