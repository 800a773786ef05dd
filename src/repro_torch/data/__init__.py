"""Data plane, ported: the word-level tokenizer, the synthetic corpus
generators (host-side numpy, identical to the JAX package's) and the
compressed corpus store (``CompressedCorpus``: build, append, save/load,
window reads, epoch-stamped traversal memos on the device)."""

from .tokenizer import Tokenizer
from .store import CompressedCorpus
from . import synthetic

__all__ = ["Tokenizer", "CompressedCorpus", "synthetic"]
