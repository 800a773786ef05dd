"""Training stack, ported: optimizer, loss/step factories, gradient
compression, fault-tolerant driver."""

from .optimizer import AdamW, AdamWState
from .step import make_train_step, make_eval_step, make_loss_fn, cross_entropy
from .grad_compress import (topk_compress, init_error, topk_wire_bytes,
                            int8_roundtrip, int8_quantize, int8_dequantize)
from .driver import train, StragglerWatchdog, FailureInjector

__all__ = ["AdamW", "AdamWState", "make_train_step", "make_eval_step",
           "make_loss_fn", "cross_entropy", "topk_compress", "init_error",
           "topk_wire_bytes", "int8_roundtrip", "int8_quantize",
           "int8_dequantize", "train", "StragglerWatchdog",
           "FailureInjector"]
