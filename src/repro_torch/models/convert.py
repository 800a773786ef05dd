"""Weight carry-over between the JAX package's parameter tree and the
port's :class:`~repro_torch.models.transformer.LM`.

The JAX package's tree (``unbox(init_lm(key, cfg))[0]``) stacks each
block position's layers along a leading ``[repeats]`` axis under
``params["blocks"][p_pos]`` (layer ``i = r*bs + p_pos``), and the
encoder's layers under ``params["encoder"]["layers"]``; the port holds
one node a layer.  Every other leaf has the same name, shape and layout
in both, so carrying weights across is unstacking and copying — no
transpose.

* :func:`lm_from_params` takes that tree with numpy leaves and returns
  the port's LM on a device (the card unless the caller asks for the CPU).
* :func:`lm_to_params` is the inverse: the JAX layout with tensor leaves,
  so ``repro_torch.checkpoint.save_checkpoint`` writes a checkpoint the
  JAX package restores into its own tree.
* :func:`lm_axes` gives every parameter's logical axes keyed like that
  checkpoint's flattened keys (``jax.tree_util.keystr`` of the JAX
  layout), the counterpart of the axes half of ``unbox``;
  :func:`lm_skeleton` the shapes (``meta`` tensors) and axes tree of a
  config's LM without building it.
* Training: :func:`lm_load_params` copies a tree in the JAX layout into
  a model in place (resume); :func:`lm_grads` gives the parameters'
  ``.grad`` in the JAX layout (``jax.value_and_grad``'s tree);
  :func:`adamw_state_from_jax` / :func:`adamw_state_to_jax` carry an
  ``AdamWState`` (count, moments in the JAX layout) between numpy and
  the device; :func:`layer_views` reads a JAX-layout tree one layer at a
  time (views of the stacked tensors: the optimizer writes through them).

This extends the port's carry-over convention (the engine's state is
``GrammarArrays`` from numpy).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.checkpoint import flatten_with_paths, unflatten
from repro_torch.kernels._common import resolve_device

from .config import ModelConfig
from .layers import Boxed, stack_trees, tree_map, unbox
from .transformer import LM, init_tree


def _jax_layout(cfg: ModelConfig, tree: Dict, stack: Callable) -> Dict:
    """The port's per-layer tree in the JAX package's stacked layout;
    ``stack`` turns the list of one parameter's per-layer leaves into
    one leaf."""
    out = {k: v for k, v in tree.items() if k not in ("layers", "encoder")}
    bs = cfg.block_size
    out["blocks"] = [stack_trees(tree["layers"][p_pos::bs], stack)
                     for p_pos in range(bs)]
    if "encoder" in tree:
        out["encoder"] = {
            "layers": stack_trees(tree["encoder"]["layers"], stack),
            "final_norm": tree["encoder"]["final_norm"]}
    return out


def layer_views(cfg: ModelConfig, params: Dict) -> Dict:
    """The JAX package's stacked tree unstacked into one node a layer,
    each layer's leaf a view of the stacked array (numpy or torch)."""
    bs = cfg.block_size
    repeats = cfg.num_layers // bs
    if len(params["blocks"]) != bs:
        raise ValueError(f"{cfg.name}: {len(params['blocks'])} block "
                         f"positions, the config has block size {bs}")
    out = {k: v for k, v in params.items() if k not in ("blocks", "encoder")}
    layers = [None] * cfg.num_layers
    for p_pos, block in enumerate(params["blocks"]):
        for r in range(repeats):
            layers[r * bs + p_pos] = tree_map(lambda a, r=r: a[r], block)
    out["layers"] = layers
    if "encoder" in params:
        enc = params["encoder"]
        out["encoder"] = {
            "layers": [tree_map(lambda a, r=r: a[r], enc["layers"])
                       for r in range(cfg.encoder_layers)],
            "final_norm": enc["final_norm"]}
    return out


def _to_tensor(a) -> torch.Tensor:
    """A leaf as a tensor of its own (never sharing the leaf's memory)."""
    if isinstance(a, torch.Tensor):
        return a.detach().clone()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes: torch cannot read it
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _fill(cfg: ModelConfig, want, params: Dict, put) -> None:
    """``put(target, tensor)`` for every ``(key, target)`` of ``want``
    with the leaf of the JAX-layout tree ``params`` under that key, after
    checking that both trees hold the same keys, shapes and dtypes."""
    got = dict(flatten_with_paths(layer_views(cfg, params)))
    missing = [k for k, _ in want if k not in got]
    extra = sorted(set(got) - {k for k, _ in want})
    if missing or extra:
        raise ValueError(f"{cfg.name}: parameter trees differ: missing "
                         f"{missing[:5]}, unexpected {extra[:5]}")
    for key, target in want:
        t = _to_tensor(got[key])
        ref = target.value if isinstance(target, Boxed) else target
        if t.shape != ref.shape or t.dtype != ref.dtype:
            raise ValueError(f"{cfg.name}: {key} is {tuple(t.shape)} "
                             f"{t.dtype}, expected {tuple(ref.shape)} "
                             f"{ref.dtype}")
        put(target, t)


def lm_from_params(cfg: ModelConfig, params: Dict, device=None) -> LM:
    """The port's LM holding the JAX package's unboxed parameters
    (numpy leaves), on ``device``.  Every leaf must exist in both trees
    with the same shape and dtype."""
    dev = resolve_device(device)
    skeleton = init_tree(cfg, None)

    def put(box, t):
        box.value = t
    _fill(cfg, flatten_with_paths(skeleton), params, put)
    return LM(cfg, skeleton).to(dev)


@torch.no_grad()
def lm_load_params(model: LM, params: Dict) -> LM:
    """Copy ``params`` (the JAX layout, numpy or tensor leaves, e.g. a
    restored checkpoint's) into ``model``'s parameters in place; a
    DTensor parameter takes its shard of the full leaf."""
    def put(p, t):
        if isinstance(p, DTensor):
            # every rank holds the full tensor: place it as ``p`` is
            t = distribute_tensor(t.to(p.device), p.device_mesh,
                                  p.placements)
        p.copy_(t)
    _fill(model.cfg, flatten_with_paths(param_tree(model)), params, put)
    return model


def param_tree(model: LM) -> Dict:
    """The model's parameters as one nested dict a layer (the port's
    layout), the leaves the parameters themselves."""
    return unbox(model.boxed_tree())[0]


def lm_to_params(model: LM) -> Dict:
    """The model's parameters in the JAX package's stacked layout (tensor
    leaves on the model's device, detached: the stacked leaves are
    copies, the others share the parameters' memory)."""
    return _jax_layout(model.cfg, tree_map(torch.Tensor.detach,
                                           param_tree(model)), torch.stack)


def lm_grads(model: LM) -> Dict:
    """The parameters' ``.grad`` in the JAX package's stacked layout
    (zeros where no gradient reached a parameter, as ``jax.grad`` gives
    them)."""
    grads = tree_map(lambda p: (p.grad if p.grad is not None
                                else torch.zeros_like(p)).detach(),
                     param_tree(model))
    return _jax_layout(model.cfg, grads, torch.stack)


def adamw_state_from_jax(state, device=None):
    """The port's ``AdamWState`` on ``device`` (the card unless the
    caller asks for the CPU) from an ``AdamWState`` of the JAX package
    or a restored checkpoint: count int32, moments in the JAX layout."""
    # imported here: the training package imports this one
    from repro_torch.training.optimizer import AdamWState
    dev = resolve_device(device)

    def conv(a):
        return _to_tensor(a).to(dev)
    return AdamWState(count=conv(np.asarray(state.count, np.int32)),
                      mu=tree_map(conv, state.mu),
                      nu=tree_map(conv, state.nu))


def adamw_state_to_jax(state):
    """``state`` with numpy leaves, field for field the JAX package's
    ``AdamWState(count, mu, nu)``."""
    def conv(t):
        return t.detach().cpu().numpy()
    return type(state)(count=conv(state.count), mu=tree_map(conv, state.mu),
                       nu=tree_map(conv, state.nu))


def lm_skeleton(cfg: ModelConfig) -> Tuple[Dict, Dict]:
    """``(params, axes)`` of ``cfg``'s LM in the JAX package's layout with
    no memory behind them: ``meta`` tensors of the parameters' shapes and
    dtypes, and the tree of their logical axes — what the sharding rules
    read, at any size (the counterpart of ``eval_shape`` + ``unbox``)."""
    with torch.device("meta"):
        model = LM(cfg, init_tree(cfg, None))
        params = lm_to_params(model)
    flat_axes = lm_axes(model)
    return params, unflatten(params, [flat_axes[k] for k, _ in
                                      flatten_with_paths(params)])


def lm_axes(model: LM) -> Dict[str, Tuple]:
    """``{flattened key: logical axes}`` of every parameter, stacked
    leaves with the leading "layers" axis, as the JAX package's
    ``unbox`` gives them."""
    layout = _jax_layout(model.cfg, model.boxed_tree(),
                         lambda bs: Boxed(None, ("layers",) + bs[0].axes))
    return {k: b.axes for k, b in flatten_with_paths(layout)}
