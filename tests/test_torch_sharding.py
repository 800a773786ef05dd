"""The port's sharding rules (``repro_torch.distributed.sharding``,
``launch/mesh.py``) against the JAX package's, with no devices.

The rules read only a mesh's names and sizes, so both packages run at
production size here: the JAX package on ``jax.sharding.AbstractMesh``,
the port on its ``MeshShape``, 16x16 and 2x16x16, ``fsdp_over_pod`` off
and on.  For every architecture, leaf by leaf: the spec equal (the port's
``PartitionSpec`` is the tuple of JAX's) and ``shard_shape`` equal to
``NamedSharding(AbstractMesh, P).shard_shape`` — for the parameters
(skeletons on the ``meta`` device against ``eval_shape`` + ``unbox``)
and the AdamW moments, the batches of every ``LM_SHAPES`` entry, and the
decode caches at the decode shapes.  Each mesh coordinate's slice on a
2x2x2 mesh equals JAX's ``devices_indices_map`` (8 host devices, in a
subprocess; device order is rank order).  Exact equality throughout.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard

from repro import configs as jconfigs
from repro import models as jm
from repro import training as jt
from repro.distributed import MeshRules as JMeshRules
from repro.distributed import sharding as jsharding
from repro_torch import configs as tconfigs
from repro_torch import models as tm
from repro_torch import training as tt
from repro_torch.checkpoint import flatten_with_paths
from repro_torch.distributed import sharding as tsharding
from repro_torch.distributed.sharding import (MeshRules, MeshShape,
                                              NamedSharding, PartitionSpec)
from repro_torch.launch import mesh as tmesh

HERE = os.path.dirname(os.path.abspath(__file__))
ARCHS = list(tconfigs.ARCH_IDS)
MESHES = [((16, 16), ("data", "model"), False),
          ((16, 16), ("data", "model"), True),
          ((2, 16, 16), ("pod", "data", "model"), False),
          ((2, 16, 16), ("pod", "data", "model"), True)]
MESH_IDS = ["16x16", "16x16-fsdp_over_pod", "2x16x16",
            "2x16x16-fsdp_over_pod"]


def _meshes(i):
    sizes, names, fsdp = MESHES[i]
    jmesh = AbstractMesh(sizes, names)
    tmesh_ = MeshShape(sizes, names)
    return (jmesh, jsharding.default_rules(jmesh, fsdp_over_pod=fsdp),
            tmesh_, tsharding.default_rules(tmesh_, fsdp_over_pod=fsdp))


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    cfg = jconfigs.get_config(arch)
    boxed = jax.eval_shape(functools.partial(jm.init_lm, cfg=cfg),
                           jax.random.PRNGKey(0))
    params, axes = jm.unbox(boxed)
    return cfg, params, axes, jax.eval_shape(jt.AdamW().init, params)


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    """The JAX layout of the port's parameters on the ``meta`` device
    (shapes only), its logical axes, and AdamW's moments."""
    cfg = tconfigs.get_config(arch)
    params, axes = tm.lm_skeleton(cfg)
    return cfg, params, axes, tt.AdamW().init(params)


def _jax_flat(tree):
    return {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_same(port_sh, jax_sh, jax_shapes, what):
    """Leaf by leaf: the port's spec == tuple(JAX's spec), and the shard
    shapes equal, at the JAX tree's shapes."""
    got = dict(flatten_with_paths(port_sh))
    want = _jax_flat(jax_sh)
    shapes = _jax_flat(jax_shapes)
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want))[:5])
    for k, w in want.items():
        g = got[k]
        assert isinstance(g.spec, PartitionSpec)
        assert g.spec == tuple(w.spec), (what, k, g.spec, w.spec)
        shape = tuple(shapes[k].shape)
        assert g.shard_shape(shape) == tuple(w.shard_shape(shape)), (what, k)


@pytest.mark.parametrize("mesh", range(len(MESHES)), ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_moment_shardings_match_jax(arch, mesh):
    jcfg, jparams, jaxes, jstate = _jax_params(arch)
    _, tparams, taxes, tstate = _port_params(arch)
    jmesh, jrules, pmesh, prules = _meshes(mesh)
    assert {k: tuple(v.shape) for k, v in flatten_with_paths(tparams)} == \
        {k: tuple(v.shape) for k, v in _jax_flat(jparams).items()}
    _assert_same(tsharding.param_shardings(taxes, tparams, pmesh, prules),
                 jsharding.param_shardings(jaxes, jparams, jmesh, jrules),
                 jparams, f"{arch} params")
    for field in ("mu", "nu"):
        _assert_same(
            tsharding.param_shardings(taxes, getattr(tstate, field), pmesh,
                                      prules),
            jsharding.param_shardings(jaxes, getattr(jstate, field), jmesh,
                                      jrules),
            getattr(jstate, field), f"{arch} {field}")


@pytest.mark.parametrize("mesh", range(len(MESHES)), ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_shardings_match_jax(arch, mesh):
    """Every ``LM_SHAPES`` entry's ``input_specs``."""
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jmesh, jrules, pmesh, prules = _meshes(mesh)
    for shape in tm.LM_SHAPES:
        jins = jconfigs.input_specs(jcfg, shape)
        tins = {k: torch.empty(shp, dtype=dt, device="meta")
                for k, (shp, dt) in tconfigs.input_specs(tcfg, shape).items()}
        _assert_same(tsharding.batch_shardings(tins, pmesh, prules),
                     jsharding.batch_shardings(jins, jmesh, jrules), jins,
                     f"{arch} {shape}")


@pytest.mark.parametrize("mesh", range(len(MESHES)), ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shardings_match_jax(arch, mesh):
    """The decode caches at the decode shapes the JAX dry run builds
    (``long_500k`` where the arch supports it)."""
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jmesh, jrules, pmesh, prules = _meshes(mesh)
    for shape, spec in tm.LM_SHAPES.items():
        if spec.kind != "decode" or not tconfigs.shape_supported(
                tcfg, shape)[0]:
            continue
        B, L = spec.global_batch, spec.seq_len
        jcache = jax.eval_shape(functools.partial(jm.init_cache, jcfg, B, L))
        tcache = tm.init_cache(tcfg, B, L, device="meta")
        got = dict(flatten_with_paths(tsharding.cache_shardings(
            tcfg, tcache, pmesh, prules)))
        want = _jax_flat(jsharding.cache_shardings(jcfg, jcache, jmesh,
                                                   jrules))
        shapes = _jax_flat(jcache)
        assert set(got) == set(want)
        for k, w in want.items():
            assert got[k].spec == tuple(w.spec), (arch, shape, k)
            shp = tuple(shapes[k].shape)
            if k != "['pos']":
                assert tuple(dict(flatten_with_paths(tcache))[k].shape) == shp
            assert got[k].shard_shape(shp) == tuple(w.shard_shape(shp))


# ---------------------------------------- tests/test_distributed.py:24-54 --
class FakeMesh:
    """Just enough of a Mesh for spec_for (axis sizes + names)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _divisibility_fallback(pkg, R, P):
    mesh = FakeMesh({"data": 16, "model": 16})
    rules = R(rules={"vocab": "model", "embed": "data", "heads": "model"},
              batch_axes=("data",))
    rules2 = R(rules={"a": "model", "b": "model"}, batch_axes=("data",))
    return [(pkg.spec_for(("vocab", "embed"), (160, 32), mesh, rules),
             P("model", "data")),
            (pkg.spec_for(("embed", "heads", None), (32, 14, 64), mesh,
                          rules), P("data",)),
            (pkg.spec_for(("a", "b"), (16, 16), mesh, rules2), P("model"))]


def _multipod_fsdp(pkg, R, P):
    mesh = FakeMesh({"pod": 2, "data": 16, "model": 16})
    r = pkg.default_rules(mesh, fsdp_over_pod=True)
    r2 = pkg.default_rules(mesh, fsdp_over_pod=False)
    return [(r.assign("embed"), ("pod", "data")), (r2.assign("embed"), "data"),
            (r2.batch_axes, ("pod", "data"))]


def _trailing_nones(pkg, R, P):
    mesh = FakeMesh({"data": 4, "model": 2})
    rules = R(rules={"embed": "data"}, batch_axes=("data",))
    return [(pkg.spec_for((None, "embed", None, None), (3, 8, 5, 7), mesh,
                          rules), P(None, "data"))]


@pytest.mark.parametrize("case", [_divisibility_fallback, _multipod_fsdp,
                                  _trailing_nones],
                         ids=["divisibility_fallback", "multipod_fsdp",
                              "trailing_nones_trimmed"])
def test_fake_mesh_cases_mirror_the_jax_tests(case):
    """The three ``FakeMesh`` cases of ``tests/test_distributed.py``, on the
    port, with the JAX package's answers beside them."""
    got = case(tsharding, MeshRules, PartitionSpec)
    ref = case(jsharding, JMeshRules, JP)
    for (g, want), (j, jwant) in zip(got, ref):
        assert g == want
        assert j == jwant
        assert g == (tuple(j) if isinstance(j, JP) else j)


# ------------------------------------------------------------- slices --
_JAX_SLICES = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2),
            ("pod", "data", "model"))
out = []
for spec, shape in json.loads(sys.argv[1]):
    spec = [tuple(s) if isinstance(s, list) else s for s in spec]
    m = NamedSharding(mesh, P(*spec)).devices_indices_map(tuple(shape))
    out.append([[list(sl.indices(n)[:2]) for sl, n in zip(m[d], shape)]
                for d in jax.devices()[:8]])
print(json.dumps(out))
"""
SLICE_CASES = [
    [[["pod", "data"], "model"], [8, 6]],
    [[None, "model", "data"], [3, 4, 10]],
    [["pod"], [4, 5]],
    [[["pod", "data", "model"]], [16]],
    [[], [2, 3]],
    [["data", ["pod", "model"]], [6, 8]],
]


def test_slices_match_devices_indices_map():
    """Each coordinate's slice of a 2x2x2 mesh (row-major coordinate
    order is rank order) equals JAX's ``devices_indices_map``."""
    r = subprocess.run([sys.executable, "-c", _JAX_SLICES,
                        json.dumps(SLICE_CASES)], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    want = json.loads(r.stdout.strip().splitlines()[-1])
    mesh = MeshShape((2, 2, 2), ("pod", "data", "model"))
    for (spec, shape), jax_map in zip(SLICE_CASES, want):
        sh = NamedSharding(mesh, [tuple(s) if isinstance(s, list) else s
                                  for s in spec])
        got = [[list(sl.indices(n)[:2]) for sl, n in zip(idx, shape)]
               for idx in sh.indices_map(shape).values()]
        assert got == jax_map, (spec, shape)


# -------------------------------------------------------- the mesh types --
def test_placements_follow_mesh_order():
    """A dim over ("pod", "data") is Shard on both mesh dims (JAX's
    major-to-minor layout, DTensor's outer-first split)."""
    mesh = MeshShape((2, 16, 16), ("pod", "data", "model"))
    sh = NamedSharding(mesh, PartitionSpec(("pod", "data"), "model"))
    assert sh.placements == (Shard(0), Shard(0), Shard(1))
    assert NamedSharding(mesh, PartitionSpec()).placements == \
        (Replicate(),) * 3
    assert tsharding.replicated(mesh).spec == () == tuple(JP())
    assert PartitionSpec("model", None) == ("model", None) == tuple(
        JP("model", None))


@pytest.mark.parametrize("spec, match", [
    ((("data", "pod"),), "mesh order"),
    (("model", "model"), "used twice"),
    (("rows",), "no mesh axis"),
])
def test_bad_specs_raise(spec, match):
    with pytest.raises(ValueError, match=match):
        NamedSharding(MeshShape((2, 16, 16), ("pod", "data", "model")), spec)


def test_shard_shape_needs_divisible_dims():
    """As JAX's ``shard_shape``: a sharded dim must divide."""
    mesh = MeshShape((2, 16, 16), ("pod", "data", "model"))
    with pytest.raises(ValueError, match="does not split"):
        NamedSharding(mesh, PartitionSpec("model")).shard_shape((10,))
    with pytest.raises(ValueError):
        JNamedSharding(AbstractMesh((2, 16, 16), ("pod", "data", "model")),
                       JP("model")).shard_shape((10,))


def test_production_meshes_are_device_free():
    """``make_production_mesh`` is the JAX package's mesh as names and
    sizes; importing and calling it starts no process group."""
    assert dict(tmesh.make_production_mesh().shape) == {"data": 16,
                                                         "model": 16}
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert multi.axis_names == ("pod", "data", "model")
    assert dict(multi.shape) == {"pod": 2, "data": 16, "model": 16}
    assert not torch.distributed.is_initialized()
