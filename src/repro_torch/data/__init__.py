"""Data plane, ported: the word-level tokenizer and the synthetic corpus
generators (host-side numpy, identical to the JAX package's)."""

from .tokenizer import Tokenizer
from . import synthetic

__all__ = ["Tokenizer", "synthetic"]
