"""Logical-axis -> mesh sharding policy (DP / FSDP / TP / EP / SP), the
port of the JAX package's ``distributed/sharding.py``.

Model code tags every parameter dim with a logical axis name
(``models/layers.py`` Boxed).  This module maps those names onto a mesh:

  * TP   — "heads"/"kv_heads"/"ffn"/"vocab"/"expert"/"ssm_*" -> "model"
  * FSDP — "embed" (the d_model dim every matrix has) -> fsdp axes
           ("data", or ("pod","data") for cross-pod ZeRO-3)
  * DP   — batch dims of activations/inputs -> ("pod","data")
  * SP   — decode caches: kv-heads -> "model" when divisible, otherwise the
           *sequence* dim shards over "model"

Every mapping is divisibility-checked against the mesh; a dim that does not
divide falls back to replication.  One mesh axis is never assigned twice in
a single spec (first logical dim wins), and trailing ``None``s are trimmed.

DESIGN.  The rules read only a mesh's axis names and sizes, so a mesh is
either a ``torch.distributed.DeviceMesh`` with ``mesh_dim_names`` or a
device-free :class:`MeshShape` (the counterpart of JAX's ``AbstractMesh``):
the rules run at 16x16 and 2x16x16 with no devices.  A spec is a
:class:`PartitionSpec`, a tuple that compares equal to the tuple of JAX's
``PartitionSpec`` — one entry a tensor dim: ``None``, a mesh axis name, or
a tuple of names in mesh order.  A :class:`NamedSharding` carries the mesh
and the spec and gives the DTensor ``placements`` (one a mesh dim: the
tensor dim it shards, ``Shard(d)``, or ``Replicate()``; a dim over
``("pod", "data")`` is ``Shard(d)`` on both mesh dims, which DTensor splits
outer mesh dim first — JAX's major-to-minor layout), the shape of one
shard, and each mesh coordinate's slice of the full tensor.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

from torch.distributed.tensor import Replicate, Shard

from repro_torch.models.layers import tree_map

AxisAssign = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry a tensor dim: ``None`` (replicated), a mesh axis name, or
    a tuple of mesh axis names.  ``PartitionSpec("model", None) ==
    ("model", None)``, as ``tuple()`` of JAX's spec gives it."""

    def __new__(cls, *parts: AxisAssign):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class MeshShape:
    """A device-free mesh: axis names and sizes, as JAX's
    ``AbstractMesh`` has them (``shape`` is an ordered name -> size map)."""

    def __init__(self, sizes: Sequence[int], names: Sequence[str]):
        if len(sizes) != len(names):
            raise ValueError(f"{len(sizes)} sizes for {len(names)} names")
        self.shape = OrderedDict(zip(names, (int(s) for s in sizes)))
        self.axis_names = tuple(names)

    def __repr__(self) -> str:
        return f"MeshShape({dict(self.shape)})"


def mesh_axes(mesh) -> "OrderedDict[str, int]":
    """``{axis name: size}`` in mesh order, of a ``DeviceMesh`` (which must
    have ``mesh_dim_names``), a :class:`MeshShape` or anything with a
    ``shape`` map and ``axis_names`` (JAX's meshes, test stand-ins)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None or hasattr(mesh, "get_coordinate"):
        if not names:
            raise ValueError("a DeviceMesh needs mesh_dim_names for the "
                             "sharding rules")
        return OrderedDict(zip(names, (int(s) for s in mesh.shape)))
    return OrderedDict((a, int(mesh.shape[a])) for a in mesh.axis_names)


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """logical axis name -> mesh axis (or tuple of mesh axes)."""
    rules: Dict[str, AxisAssign]
    batch_axes: Tuple[str, ...] = ("pod", "data")

    def assign(self, name: Optional[str]) -> AxisAssign:
        if name is None:
            return None
        return self.rules.get(name)


def default_rules(mesh, fsdp_over_pod: bool = False) -> MeshRules:
    names = tuple(mesh_axes(mesh))
    has_pod = "pod" in names
    fsdp: AxisAssign = (("pod", "data") if (fsdp_over_pod and has_pod)
                        else "data")
    batch = tuple(a for a in ("pod", "data") if a in names)
    return MeshRules(rules={
        "vocab": "model",
        "ffn": "model",
        "heads": "model",
        "kv_heads": "model",
        "expert": "model",
        "ssm_inner": "model",
        "ssm_heads": "model",
        "embed": fsdp,
        "layers": None,
        "head_dim": None,
    }, batch_axes=batch)


def _names(assign: AxisAssign) -> Tuple[str, ...]:
    if assign is None:
        return ()
    return (assign,) if isinstance(assign, str) else tuple(assign)


def _axis_size(mesh, assign: AxisAssign) -> int:
    sizes = mesh_axes(mesh)
    return math.prod(sizes[a] for a in _names(assign))


def spec_for(axes: Sequence[Optional[str]], shape: Sequence[int],
             mesh, rules: MeshRules) -> PartitionSpec:
    """PartitionSpec for one tensor given its logical axes + shape."""
    used: set = set()
    parts: List[AxisAssign] = []
    for name, dim in zip(axes, shape):
        assign = rules.assign(name)
        if assign is None:
            parts.append(None)
            continue
        mesh_names = _names(assign)
        if any(a in used for a in mesh_names):
            parts.append(None)
            continue
        size = _axis_size(mesh, assign)
        if size <= 1 or dim % size != 0:
            parts.append(None)
            continue
        used.update(mesh_names)
        parts.append(assign)
    while parts and parts[-1] is None:
        parts.pop()
    return PartitionSpec(*parts)


# ------------------------------------------------------------- shardings --
class NamedSharding:
    """A mesh and a spec: what one tensor's placement over the mesh is."""

    def __init__(self, mesh, spec: Iterable[AxisAssign]):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)
        sizes = mesh_axes(mesh)
        seen: set = set()
        for part in self.spec:
            names = _names(part)
            for a in names:
                if a not in sizes:
                    raise ValueError(f"{self.spec}: no mesh axis {a!r} in "
                                     f"{tuple(sizes)}")
                if a in seen:
                    raise ValueError(f"{self.spec}: mesh axis {a!r} used "
                                     f"twice")
                seen.add(a)
            order = [list(sizes).index(a) for a in names]
            if order != sorted(order):
                # DTensor splits a dim over mesh dims outer first only
                raise ValueError(f"{self.spec}: axes {names} are not in "
                                 f"mesh order {tuple(sizes)}")

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    def _dim_of(self) -> Dict[str, int]:
        """mesh axis name -> the tensor dim it shards."""
        return {a: d for d, part in enumerate(self.spec)
                for a in _names(part)}

    @property
    def placements(self) -> Tuple:
        """DTensor placements, one a mesh dim in mesh order."""
        dim_of = self._dim_of()
        return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                     for a in mesh_axes(self.mesh))

    def _parts(self, ndim: int) -> List[Tuple[str, ...]]:
        if len(self.spec) > ndim:
            raise ValueError(f"{self.spec} has more entries than a rank-"
                             f"{ndim} tensor has dims")
        return [_names(p) for p in self.spec] + [()] * (ndim - len(self.spec))

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of one device's shard (each sharded dim must divide,
        as JAX's ``NamedSharding.shard_shape`` demands)."""
        sizes = mesh_axes(self.mesh)
        out = []
        for dim, names in zip(shape, self._parts(len(shape))):
            n = math.prod(sizes[a] for a in names)
            if dim % n:
                raise ValueError(f"{self.spec}: dim of {dim} does not split "
                                 f"into {n} shards")
            out.append(dim // n)
        return tuple(out)

    def index(self, coord: Sequence[int], shape: Sequence[int]
              ) -> Tuple[slice, ...]:
        """The slice of the full tensor held at mesh coordinate ``coord``
        (one index a mesh dim).  A dim over several mesh axes is split
        major to minor in mesh order."""
        sizes = mesh_axes(self.mesh)
        at = dict(zip(sizes, coord))
        local = self.shard_shape(shape)
        out = []
        for dim, n_local, names in zip(shape, local,
                                       self._parts(len(shape))):
            if not names:
                out.append(slice(None))
                continue
            k = 0
            for a in names:
                k = k * sizes[a] + at[a]
            out.append(slice(k * n_local, (k + 1) * n_local))
        return tuple(out)

    def indices_map(self, shape: Sequence[int]
                    ) -> Dict[Tuple[int, ...], Tuple[slice, ...]]:
        """``{mesh coordinate: slice}`` for every coordinate of the mesh
        (row-major, so coordinate order is rank order)."""
        sizes = mesh_axes(self.mesh)
        return {c: self.index(c, shape)
                for c in itertools.product(*(range(s)
                                             for s in sizes.values()))}


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def map_axes(fn, axes_tree, other_tree):
    """``fn(axes, leaf)`` over an axes tree (leaves: tuples of axis names)
    and a tree of the same structure, as ``jax.tree.map`` with
    ``is_leaf`` on the axes tuples.  Nested dicts, lists and tuples."""
    if _is_axes(axes_tree):
        return fn(axes_tree, other_tree)
    if isinstance(axes_tree, dict):
        if set(axes_tree) != set(other_tree):
            raise ValueError(f"trees differ: {sorted(axes_tree)} vs "
                             f"{sorted(other_tree)}")
        return {k: map_axes(fn, axes_tree[k], other_tree[k])
                for k in axes_tree}
    if isinstance(axes_tree, (list, tuple)):
        if len(axes_tree) != len(other_tree):
            raise ValueError("trees differ in length")
        return type(axes_tree)(map_axes(fn, a, o)
                               for a, o in zip(axes_tree, other_tree))
    raise TypeError(f"not an axes tree node: {axes_tree!r}")


def param_shardings(axes_tree, shape_tree, mesh, rules: MeshRules):
    """NamedSharding tree for a parameter tree.

    ``axes_tree``: logical axes per leaf (from ``unbox``); ``shape_tree``:
    matching tensors (any device, ``meta`` included) or anything with a
    ``shape``."""
    return map_axes(lambda axes, arr: NamedSharding(
        mesh, spec_for(axes, arr.shape, mesh, rules)), axes_tree, shape_tree)


def _batch_assign(rules: MeshRules) -> AxisAssign:
    ba = rules.batch_axes
    return ba[0] if len(ba) == 1 else tuple(ba)


def batch_spec(rules: MeshRules, ndim: int = 2) -> PartitionSpec:
    """[B, S, ...] activations/inputs: batch over (pod, data)."""
    return PartitionSpec(_batch_assign(rules), *([None] * (ndim - 1)))


def batch_shardings(batch_tree, mesh, rules: MeshRules):
    size = _axis_size(mesh, _batch_assign(rules))

    def one(arr):
        b = arr.shape[0]
        if size > 1 and b % size == 0:
            return NamedSharding(mesh, batch_spec(rules, len(arr.shape)))
        return NamedSharding(mesh, PartitionSpec())
    return tree_map(one, batch_tree)


# ----------------------------------------------------------- decode cache --
def _paths(tree, prefix=()) -> List[Tuple[Tuple[str, ...], Any]]:
    """``[(keys on the path, leaf)]`` (dict keys as strings, sequence
    positions as "")."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _paths(v, prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _paths(v, prefix + ("",))]
    return [(prefix, tree)]


def cache_shardings(cfg, cache_tree, mesh, rules: MeshRules):
    """Sharding for the decode cache tree (``models.init_cache`` layout).

    KV entries  [repeats, B, maxlen, Hkv, hd]:
        B -> batch axes; Hkv -> model if divisible, else maxlen -> model
        (and for batch==1, maxlen spreads over *all* non-used axes: the
        long-context single-stream case).
    SSM state h [repeats, B, H, P, N]: B -> batch, H -> model.
    conv state  [repeats, B, K-1, conv_dim]: B -> batch, conv_dim -> model.
    cross K/V   [layers, B, T_enc, Hkv, hd]: like KV.
    ``pos`` (a host int in the port) is replicated.
    """
    model_sz = mesh_axes(mesh).get("model", 1)
    batch_assign = _batch_assign(rules)
    batch_sz = _axis_size(mesh, batch_assign)

    def kv_spec(shape):
        _, B, L, Hkv, _ = shape
        b_ax = batch_assign if (batch_sz > 1 and B % batch_sz == 0) else None
        if Hkv % model_sz == 0:
            return P(None, b_ax, None, "model", None)
        if B == 1 and b_ax is not None:
            # single stream: spread sequence over everything available
            all_ax = (tuple(rules.batch_axes) + ("model",))
            if L % _axis_size(mesh, all_ax) == 0:
                return P(None, None, all_ax, None, None)
        if L % model_sz == 0:
            return P(None, b_ax, "model", None, None)
        return P(None, b_ax)

    def one(keys, arr):
        if "pos" in keys:
            return NamedSharding(mesh, P())
        shape = tuple(arr.shape)
        if keys and keys[-1] in ("k", "v") or "cross_k" in keys or \
                "cross_v" in keys:
            return NamedSharding(mesh, kv_spec(shape))
        if keys and keys[-1] == "h":                 # [rep, B, H, P, N]
            _, B, H, _, _ = shape
            b_ax = batch_assign if (batch_sz > 1 and B % batch_sz == 0) else None
            m_ax = "model" if H % model_sz == 0 else None
            return NamedSharding(mesh, P(None, b_ax, m_ax, None, None))
        if keys and keys[-1] == "conv":              # [rep, B, K-1, convd]
            _, B, _, cd = shape
            b_ax = batch_assign if (batch_sz > 1 and B % batch_sz == 0) else None
            m_ax = "model" if cd % model_sz == 0 else None
            return NamedSharding(mesh, P(None, b_ax, None, m_ax))
        return NamedSharding(mesh, P())

    leaves = iter([one(k, a) for k, a in _paths(cache_tree)])
    return tree_map(lambda _: next(leaves), cache_tree)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
