"""Model zoo: the 10 assigned architectures on one unified LM skeleton
(the port of the JAX package's ``models``), plus the carry-over of
weights, gradients and optimizer state from and to the JAX package's
parameter tree (``convert``)."""

from .config import ModelConfig, ShapeSpec, LM_SHAPES, reduced
from .layers import Boxed, unbox, stack_boxed
from .transformer import (LM, init_lm, apply_lm, apply_layer, init_cache,
                          decode_step, prefill_cross)
from .convert import (adamw_state_from_jax, adamw_state_to_jax, layer_views,
                      lm_axes, lm_from_params, lm_grads, lm_load_params,
                      lm_skeleton, lm_to_params, param_tree)

__all__ = ["ModelConfig", "ShapeSpec", "LM_SHAPES", "reduced",
           "Boxed", "unbox", "stack_boxed",
           "LM", "init_lm", "apply_lm", "apply_layer", "init_cache",
           "decode_step",
           "prefill_cross", "lm_from_params", "lm_to_params", "lm_axes",
           "lm_skeleton",
           "lm_load_params", "lm_grads", "param_tree", "layer_views",
           "adamw_state_from_jax", "adamw_state_to_jax"]
