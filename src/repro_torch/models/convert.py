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
  layout), the counterpart of the axes half of ``unbox``.

This extends the port's carry-over convention (the engine's state is
``GrammarArrays`` from numpy).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import flatten_with_paths
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


def _per_layer(cfg: ModelConfig, params: Dict) -> Dict:
    """The JAX package's stacked tree unstacked into one node a layer."""
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
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes: torch cannot read it
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def lm_from_params(cfg: ModelConfig, params: Dict, device=None) -> LM:
    """The port's LM holding the JAX package's unboxed parameters
    (numpy leaves), on ``device``.  Every leaf must exist in both trees
    with the same shape and dtype."""
    dev = resolve_device(device)
    skeleton = init_tree(cfg, None)
    want = flatten_with_paths(skeleton)
    got = dict(flatten_with_paths(_per_layer(cfg, params)))
    missing = [k for k, _ in want if k not in got]
    extra = sorted(set(got) - {k for k, _ in want})
    if missing or extra:
        raise ValueError(f"{cfg.name}: parameter trees differ: missing "
                         f"{missing[:5]}, unexpected {extra[:5]}")
    for key, box in want:
        t = _to_tensor(got[key])
        if t.shape != box.value.shape or t.dtype != box.value.dtype:
            raise ValueError(f"{cfg.name}: {key} is {tuple(t.shape)} "
                             f"{t.dtype}, expected "
                             f"{tuple(box.value.shape)} {box.value.dtype}")
        box.value = t
    return LM(cfg, skeleton).to(dev)


def lm_to_params(model: LM) -> Dict:
    """The model's parameters in the JAX package's stacked layout (tensor
    leaves on the model's device)."""
    params, _ = unbox(model.boxed_tree())
    return _jax_layout(model.cfg, params,
                       lambda ts: torch.stack([t.detach() for t in ts]))


def lm_axes(model: LM) -> Dict[str, Tuple]:
    """``{flattened key: logical axes}`` of every parameter, stacked
    leaves with the leading "layers" axis, as the JAX package's
    ``unbox`` gives them."""
    layout = _jax_layout(model.cfg, model.boxed_tree(),
                         lambda bs: Boxed(None, ("layers",) + bs[0].axes))
    return {k: b.axes for k, b in flatten_with_paths(layout)}
