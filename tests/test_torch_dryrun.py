"""The port's dry run, roofline and op counts (``launch/dryrun.py``,
``launch/roofline.py``, ``utils/hlo_analysis.py``,
``kernels/autotune.hlo_profile``) against the JAX package's.

The JAX values come from ONE subprocess: importing ``repro.launch.dryrun``
sets ``XLA_FLAGS`` to 512 host devices, which would leak into this
worker's later tests.  It prints ``model_flops`` of every arch and shape,
the activation policies on both production meshes, and the JAX parse of
the compiled HLO of an all-gather, an all-reduce and a reduce-scatter
over 4 host devices.  ``model_flops`` and the policies must be equal;
the port's counter must give the same per-rank bytes for the same
collectives over a fake group of 4, and exactly 1/16 of a matmul's
global FLOPs when it is sharded over a 4x4 mesh (all of them when it is
replicated).  ``roofline.analyze`` with the JAX constants equals the
JAX ``analyze`` on records the port's dry run wrote (two reduced cells
on a fake world of 4, a skipped and an error record).
"""

import json
import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed import _functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.kernels import autotune as jautotune
from repro.launch import roofline as jroofline
from repro_torch.checkpoint import flatten_with_paths
from repro_torch.configs import ALIASES, get_config
from repro_torch.distributed import (batch_shardings, default_rules,
                                     param_shardings)
from repro_torch.distributed.sharding import MeshShape
from repro_torch.kernels import autotune as tautotune
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import LM_SHAPES, lm_skeleton, reduced
from repro_torch.utils import hlo_analysis as ha

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 4
CELLS = ("train_4k", "decode_32k")

_JAX = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import repro.launch.dryrun as jd          # sets XLA_FLAGS: 512 host devices
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs import ALIASES, get_config
from repro.distributed import default_rules
from repro.launch.mesh import make_production_mesh
from repro.models.config import LM_SHAPES
from repro.utils.hlo_analysis import parse_collectives

out = {"flops": {}, "policy": {}, "coll": {}}
for arch in ALIASES:
    for shape in LM_SHAPES:
        out["flops"][f"{arch}|{shape}"] = jd.model_flops(get_config(arch),
                                                         shape)
for kind in ("single", "multi"):
    mesh = make_production_mesh(multi_pod=kind == "multi")
    rules = default_rules(mesh)
    for arch in ALIASES:
        for shape in LM_SHAPES:
            pol = jd.make_activation_policy(get_config(arch), shape, mesh,
                                            rules)
            out["policy"][f"{kind}|{arch}|{shape}"] = {
                k: list(v) for k, v in pol.items()}
mesh = Mesh(np.array(jax.devices()[:4]), ("x",))
x = jnp.zeros((32, 16), jnp.float32)        # [8, 16] a device
for name, f in (
        ("all-gather", lambda a: jax.lax.all_gather(a, "x", tiled=True)),
        ("all-reduce", lambda a: jax.lax.psum(a, "x")),
        ("reduce-scatter", lambda a: jax.lax.psum_scatter(
            a, "x", scatter_dimension=0, tiled=True))):
    g = jax.shard_map(f, mesh=mesh, in_specs=P("x"), out_specs=P("x"),
                      check_vma=False)
    out["coll"][name] = parse_collectives(
        jax.jit(g).lower(x).compile().as_text())
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_values():
    """Start the JAX subprocess; the returned function waits for it."""
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX, os.path.join(HERE, "..", "src")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    done = {}

    def values():
        if not done:
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-6000:]
            done.update(json.loads(out.strip().splitlines()[-1]))
        return done
    yield values
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture
def fake_world():
    with dryrun.fake_world(WORLD):
        yield


@pytest.fixture(scope="module")
def records(tmp_path_factory, jax_values):
    """The port's dry run of reduced ``qwen2-0.5b`` cells (train, decode)
    on a 2x2 mesh over a fake world of 4, a skipped cell and a failed one
    (a 2x4 mesh in a world of 4); the JAX values start first."""
    out = tmp_path_factory.mktemp("dryrun")
    cfg = reduced(get_config("qwen2-0.5b"))
    mesh = MeshShape((2, 2), ("data", "model"))
    recs = {}
    with dryrun.fake_world(WORLD):
        for shape in CELLS:
            recs[shape] = dryrun.run_cell("qwen2-0.5b", shape, "single",
                                          out_dir=str(out), cfg=cfg,
                                          mesh_shape=mesh)
        recs["skipped"] = dryrun.run_cell("qwen2-0.5b", "long_500k",
                                          "single", out_dir=str(out))
        recs["error"] = dryrun.run_cell(
            "qwen2-0.5b", "prefill_32k", "single", out_dir=str(out),
            cfg=cfg, mesh_shape=MeshShape((2, 4), ("data", "model")))
    assert not dist.is_initialized()
    return out, cfg, mesh, recs


# ------------------------------------------------------ JAX equalities --
@pytest.mark.parametrize("arch", list(ALIASES))
def test_model_flops_equal_jax(arch, jax_values):
    want = jax_values()["flops"]
    for shape in LM_SHAPES:
        assert dryrun.model_flops(get_config(arch), shape) == \
            want[f"{arch}|{shape}"], shape


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_activation_policies_equal_jax(kind, jax_values):
    """Every arch and shape on the 16x16 and 2x16x16 production meshes:
    the same kinds, each spec equal (a ``PartitionSpec`` is a tuple)."""
    want = jax_values()["policy"]
    mesh = make_production_mesh(multi_pod=kind == "multi")
    rules = default_rules(mesh)
    for arch in ALIASES:
        for shape in LM_SHAPES:
            got = dryrun.make_activation_policy(get_config(arch), shape,
                                                mesh, rules)
            assert all(isinstance(v, tuple) for v in got.values())
            assert json.loads(json.dumps(got)) == \
                want[f"{kind}|{arch}|{shape}"], (arch, shape)


def test_collective_bytes_equal_the_jax_parse(fake_world, jax_values):
    """An all-gather, an all-reduce and a reduce-scatter of a [8, 16]
    float32 shard over 4 ranks: per-rank result bytes and counts equal
    the JAX parse of the same collectives' compiled HLO."""
    x = torch.zeros(8, 16)
    group = dist.group.WORLD
    with ha.count_ops() as rec:
        funcol.all_gather_single(x, 0, group).wait()
        funcol.all_reduce(x, "sum", group).wait()
        funcol.reduce_scatter_single(x, "sum", 0, group).wait()
    got = ha.parse_collectives(rec)
    for kind, want in jax_values()["coll"].items():
        assert got[kind] == want[kind], kind
        assert want[kind]["count"] == 1
    assert ha.total_collective_bytes(rec) == sum(
        v["bytes"] for v in got.values()) == (32 + 8 + 2) * 16 * 4


def test_flops_are_per_rank():
    """A [64, 128] @ [128, 256] on a 4x4 fake mesh: rows over ``data``
    and columns over ``model`` count exactly 1/16 of the global FLOPs on
    a rank; replicated operands count all of them."""
    from torch.distributed.device_mesh import init_device_mesh
    glob = 2 * 64 * 128 * 256
    with dryrun.fake_world(16):
        mesh = init_device_mesh("cpu", (4, 4),
                                mesh_dim_names=("data", "model"))
        for pa, pb, share in (((Shard(0), Replicate()),
                               (Replicate(), Shard(1)), 16),
                              ((Replicate(),) * 2, (Replicate(),) * 2, 1)):
            a = DTensor.from_local(torch.empty(64 // (4 if share > 1 else 1),
                                               128, device="meta"),
                                   mesh, pa)
            b = DTensor.from_local(torch.empty(128, 256 // (4 if share > 1
                                                            else 1),
                                               device="meta"), mesh, pb)
            for _ in range(2):   # DTensor's shape inference is not counted
                with ha.count_ops() as rec:
                    c = a @ b
                assert rec.flops == glob / share
                assert ha.op_histogram(rec)["dot"] == 1
            assert c.to_local().shape == ((16, 64) if share > 1
                                          else (64, 256))


def test_hlo_profile_matches_jax():
    """``a @ a`` of a (64, 64) float32: the FLOPs of the JAX
    ``hlo_profile`` (XLA's cost analysis), no collective bytes, one dot."""
    x = np.ones((64, 64), np.float32)
    want = jautotune.hlo_profile(lambda a: a @ a, jnp.asarray(x))
    got = tautotune.hlo_profile(lambda a: a @ a, torch.from_numpy(x),
                                device="cpu")
    assert got["flops"] == want["flops"]
    assert got["collective_bytes"] == want["collective_bytes"] == 0
    assert got["ops"]["dot"] == 1 and got["ops"]["custom-call"] == 0
    assert got["bound"] == "bandwidth"
    assert got["intensity"] == got["flops"] / got["bytes"]


# ------------------------------------------------------------ the records --
def _rule_bytes(cfg, shape, mesh):
    """One rank's bytes of a train cell's arguments under the rules:
    parameters, float32 moments, the count, tokens and labels."""
    rules = default_rules(mesh)
    params, axes = lm_skeleton(cfg)
    sh = dict(flatten_with_paths(param_shardings(axes, params, mesh,
                                                 rules)))
    total = 4
    for k, t in flatten_with_paths(params):
        n = math.prod(sh[k].shard_shape(tuple(t.shape)))
        total += n * (t.element_size() + 8)
    spec = LM_SHAPES[shape]
    probe = torch.empty((spec.global_batch, spec.seq_len), device="meta")
    b = batch_shardings(probe, mesh, rules)
    return total + 2 * 4 * math.prod(b.shard_shape(tuple(probe.shape)))


def test_dryrun_records(records):
    """The JAX package's keys; eager counting on 4 ranks; per-rank
    argument bytes equal to the rules' shard shapes; the null fields;
    a skipped and a failed cell recorded as the reference records them,
    and read back from their files."""
    out, cfg, mesh, recs = records
    for shape in CELLS:
        r = recs[shape]
        assert r["status"] == "ok", r.get("trace")
        assert r["devices"] == WORLD and r["counting"] == "eager"
        assert r["scan_repeats"] == cfg.num_layers
        assert set(r["memory"]) == {"argument_bytes", "output_bytes",
                                    "temp_bytes", "alias_bytes",
                                    "code_bytes"}
        assert r["memory"]["temp_bytes"] is None
        assert r["cost"]["flops_per_device"] > 0
        assert r["cost"]["bytes_per_device"] > 0
        assert r["ops"]["fusion"] == r["ops"]["while"] == 0
        assert r["ops"]["dot"] > 0
        assert r["model_flops_total"] == dryrun.model_flops(cfg, shape)
        assert r["collective_bytes_per_device"] == sum(
            v["bytes"] for v in r["collectives"].values()) > 0
    assert recs["train_4k"]["memory"]["argument_bytes"] == _rule_bytes(
        cfg, "train_4k", mesh)
    assert recs["skipped"]["status"] == "skipped"
    assert recs["error"]["status"] == "error" and recs["error"]["trace"]
    again = dryrun.run_cell("qwen2-0.5b", "train_4k", "single",
                            out_dir=str(out))
    assert again == recs["train_4k"]


def test_roofline_analyze_equals_jax(records, monkeypatch):
    """With the port's three constants set to the JAX package's, the
    port's ``analyze`` equals the JAX one on the same records; the JAX
    one reads a null ``temp_bytes`` as the port does, as 0.  ``load_all``
    and ``render`` give a row a cell, the skipped one marked."""
    out, _, _, recs = records
    monkeypatch.setattr(roofline, "PEAK_FLOPS", jroofline.PEAK_FLOPS)
    monkeypatch.setattr(roofline, "HBM_BW", jroofline.HBM_BW)
    monkeypatch.setattr(roofline, "LINK_BW", jroofline.ICI_BW)
    for name, rec in recs.items():
        got = roofline.analyze(rec)
        jrec = json.loads(json.dumps(rec))
        if "memory" in jrec:
            jrec["memory"]["temp_bytes"] = 0
        assert got == jroofline.analyze(jrec), name
        assert (got is None) == (name in ("skipped", "error"))
    rows = roofline.load_all(str(out))
    assert len(rows) == 3 and sum("skipped" in r for r in rows) == 1
    assert roofline.render(rows).count("\n") == 4
    assert len(roofline.render(rows, "csv").splitlines()) == 3


def test_roofline_constants_are_the_h100s():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989.4e12, 3.35e12, 50e9)


def test_dryrun_cli_skips_and_leaves_no_group(tmp_path, capsys):
    """``python -m repro_torch.launch.dryrun`` on a cell the assignment
    skips: the 256-rank fake group comes and goes, exit 0."""
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen2-0.5b", "--shape", "long_500k",
                     "--mesh", "single", "--out", str(tmp_path)])
    assert e.value.code == 0
    assert not dist.is_initialized()
    rec = json.loads((tmp_path / "qwen2_05b__long_500k__single.json")
                     .read_text())
    assert rec["status"] == "skipped"
    assert "SKIP" in capsys.readouterr().out
