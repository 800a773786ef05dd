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
from repro_torch.distributed.sharding import MeshShape, NamedSharding
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


# (mesh (data, model), kv heads, q placement on model): query heads split
# 2 a rank with kv heads replicated (4 does not divide 2) or following
# them (4 does), rows and heads split on 2x2, the query sequence split,
# the batch rows split over ``model`` (a residual stream no policy holds)
ATTN_SPLITS = {
    "heads_kv_replicated": ((1, 4), 2, Shard(2)),
    "heads_kv_follow": ((1, 4), 4, Shard(2)),
    "rows_and_heads": ((2, 2), 2, Shard(2)),
    "sequence": ((1, 4), 2, Shard(1)),
    "rows_over_model": ((1, 4), 2, Shard(0)),
}


@pytest.mark.parametrize("split", ATTN_SPLITS)
def test_attention_core_flops_are_per_rank(split):
    """``gqa_attention`` of meta DTensors (8 query heads, causal) on a
    fake world of 4 counts exactly 1/4 of the plain core's FLOPs on the
    same global shapes a rank: each rank takes its rows and its query
    heads or query rows, and no rank runs a replicated core."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.models.layers import gqa_attention
    (d, m), hkv, q_model = ATTN_SPLITS[split]
    B, S, H, D = 4, 32, 8, 16
    with ha.count_ops() as plain:
        gqa_attention(torch.empty(B, S, H, D, device="meta"),
                      *(torch.empty(B, S, hkv, D, device="meta"),) * 2,
                      causal=True)
    with dryrun.fake_world(WORLD):
        mesh = init_device_mesh("cpu", (d, m),
                                mesh_dim_names=("data", "model"))
        rows = Shard(0) if d > 1 else Replicate()

        def placed(shape, model):
            local = [n // (d if i == 0 and d > 1 else 1) //
                     (m if model.is_shard(i) else 1)
                     for i, n in enumerate(shape)]
            return DTensor.from_local(torch.empty(local, device="meta"),
                                      mesh, (rows, model))
        q = placed((B, S, H, D), q_model)
        kv = Shard(2) if hkv % m == 0 and q_model == Shard(2) else \
            q_model if q_model == Shard(0) else Replicate()
        k, v = (placed((B, S, hkv, D), kv) for _ in range(2))
        for _ in range(2):   # DTensor's shape inference is not counted
            with ha.count_ops() as rec:
                out = gqa_attention(q, k, v, causal=True)
            assert rec.flops == plain.flops / WORLD
            assert ha.op_histogram(rec)["dot"] == 2
        assert tuple(out.placements) == (rows, q_model)
        assert tuple(out.shape) == (B, S, H, D)


def _count_step(fn, tree, x, loss):
    """FLOPs of ``fn(tree, x)`` and of its backward from ``loss(out)``,
    each under the per-rank counter."""
    with ha.count_ops() as fwd:
        out = fn(tree, x)
    out = out[0] if isinstance(out, tuple) else out
    with ha.count_ops() as bwd:
        loss(out).backward()
    return fwd.flops, bwd.flops


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


# (the layer of the port, mesh (data, model), x's placement on ``model``):
# each run on meta tensors, plain and on a fake world of 4
PROJ_CASES = {
    "ffn_swiglu": ("ffn_swiglu", (2, 2), Replicate()),
    "ffn_gelu": ("ffn_gelu", (2, 2), Replicate()),
    # ``model`` does not divide the ffn dim: the weights are gathered
    "ffn_indivisible": ("ffn_odd", (2, 2), Replicate()),
    # router, routed experts (EP) and shared expert
    "moe_shared_expert": ("moe", (2, 2), Replicate()),
    # one data rank: the router's rows are not split; x split on model
    "moe_router_on_1x4": ("moe", (1, 4), Shard(2)),
    "mamba_in_proj": ("in_proj", (2, 2), Replicate()),
    "mamba_out_proj": ("out_proj", (2, 2), Replicate()),
    "mamba_layer": ("mamba", (2, 2), Replicate()),
    # attention's query projection: heads over ``model``
    "attn_heads": ("heads", (2, 2), Replicate()),
}


def _proj_case(layer):
    """``(fn(tree, x), Boxed tree, x width, (share of rows, share of the
    rest))``: a layer of the port at reduced widths, and how many ranks
    share each part of its work (the MoE router only the batch rows')."""
    from repro_torch.models import layers, moe, ssm
    f32 = torch.float32
    if layer.startswith("ffn"):
        act = "swiglu" if layer == "ffn_swiglu" else "gelu"
        ff = 27 if layer == "ffn_odd" else 32
        return ((lambda p, x: layers.apply_ffn(p, x, act)),
                layers.init_ffn(None, 16, ff, act, f32), 16, None)
    if layer == "heads":
        return ((lambda p, x: layers._heads(x, p["wq"])),
                {"wq": layers.init_attention(None, reduced(
                    get_config("qwen2-0.5b"), dtype="float32", d_model=16,
                    head_dim=4))["wq"]}, 16, None)
    if layer == "moe":
        cfg = reduced(get_config("qwen2-moe-a2.7b"), dtype="float32",
                      d_model=16, moe_d_ff=16, moe_shared_d_ff=32)
        return ((lambda p, x: moe.apply_moe(p, x, cfg)),
                moe.init_moe(None, cfg), 16, cfg)
    cfg = reduced(get_config("mamba2-2.7b"), dtype="float32", d_model=16,
                  ssm_head_dim=8)
    tree = ssm.init_mamba(None, cfg)
    if layer == "mamba":
        return ((lambda p, x: ssm.apply_mamba(p, x, cfg)), tree, 16, None)
    split = "out" if layer == "in_proj" else "in"
    tree = {layer: tree[layer]}
    width = tree[layer].value.shape[0]
    return ((lambda p, x: ssm._project(x, p[layer], split)), tree, width,
            None)


@pytest.mark.parametrize("case", PROJ_CASES)
def test_projections_are_per_rank(case):
    """The dense FFN (SwiGLU and GELU), the MoE layer (router, routed
    experts, shared expert), mamba's in_proj, out_proj and whole layer,
    and attention's head projection, on meta DTensors placed by the
    rules over a fake world of 4: forward and backward each count exactly
    the plain layer's FLOPs over the ranks that share the work (all four;
    the batch rows' for the MoE router, and for an FFN whose ffn dim
    ``model`` does not divide), and every gradient is placed as its
    parameter or input is (of the whole mamba layer, the projections'
    and the input's)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import moe
    from repro_torch.models.layers import unbox
    layer, (d, m), x_model = PROJ_CASES[case]
    fn, boxed, width, cfg = _proj_case(layer)
    params, axes = unbox(boxed)
    B, S = 4, 16

    def meta(tree):
        if isinstance(tree, dict):
            return {k: meta(v) for k, v in tree.items()}
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta",
                           requires_grad=True)
    plain_p = meta(params)
    plain_x = torch.empty(B, S, width, device="meta", requires_grad=True)
    plain = _count_step(fn, plain_p, plain_x, lambda y: y.sum())
    # how the plain work splits: the router over the rows, the rest over
    # every rank (an FFN's over the rows where ``model`` cannot split it)
    router = (0, 0)
    if cfg is not None:
        router = _count_step(lambda p, x: moe._router_probs(p, x),
                             plain_p, plain_x, lambda y: y.sum())
    rows_only = layer == "ffn_odd"
    with dryrun.fake_world(WORLD):
        mesh = init_device_mesh("cpu", (d, m),
                                mesh_dim_names=("data", "model"))
        tree = dryrun._place_tree(params, param_shardings(
            axes, params, mesh, default_rules(mesh)))
        for t in _leaves(tree):
            t.requires_grad_()
        x = dryrun._placed((B, S, width), torch.float32, NamedSharding(
            mesh, ("data",) + ((None, "model") if x_model.is_shard()
                               else ())))
        x.requires_grad_()

        def loss(y):
            whole = [Replicate() if p.is_partial() else p
                     for p in y.placements]
            return y.redistribute(mesh, whole).to_local().sum()
        with implicit_replication():    # the model's host constants
            got = _count_step(fn, tree, x, loss)
        # the whole mamba layer: its projections (the conv, the norm and
        # the scan's parameters are DTensor ops)
        pinned = ({k: tree[k] for k in ("in_proj", "out_proj")}
                  if layer == "mamba" else tree)
        for t in _leaves(pinned) + [x]:
            assert tuple(t.grad.placements) == tuple(t.placements), t.shape
    for i, pass_ in enumerate(("forward", "backward")):
        rest = plain[i] - router[i]
        want = router[i] / d + rest / (d if rows_only else d * m)
        assert plain[i] > 0 and got[i] == want, (pass_, got, plain, router)


def test_reduced_train_step_counts_one_share_a_rank(tmp_path):
    """A whole train step of reduced ``qwen2-0.5b`` (its vocabulary a
    multiple of 2) on a 2x2 mesh over a fake world of 4 counts exactly a
    quarter of the same step on a world of one: every matmul of the
    step (embedding, attention, FFN, logits, their backward and the
    remat's recompute) is split over the four ranks, none computed whole
    on a ``model`` rank."""
    cfg = reduced(get_config("qwen2-0.5b"), vocab_size=256)
    flops = {}
    for d, m in ((1, 1), (2, 2)):
        with dryrun.fake_world(d * m):
            rec = dryrun.run_cell("qwen2-0.5b", "train_4k", "single",
                                  out_dir=str(tmp_path), cfg=cfg,
                                  force=True, mesh_shape=MeshShape(
                                      (d, m), ("data", "model")))
        assert rec["status"] == "ok", rec.get("trace")
        flops[d * m] = rec["cost"]["flops_per_device"]
    assert flops[4] * 4 == flops[1] > 0


# reduced cells that raised on a mesh (the arch, shape, mesh and
# overrides of ``reduced``): heads the fake mesh's ``model`` dim does not
# divide, a split vocabulary at the greedy argmax, a split mamba state
MESH_CELLS = {
    "yi-9b/decode_32k": ("yi-9b", "decode_32k", (1, 4), {}),
    "stablelm-12b/decode_32k": ("stablelm-12b", "decode_32k", (1, 4), {}),
    # one decoder and one encoder layer: self and cross attention
    "whisper-large-v3/train_4k": ("whisper-large-v3", "train_4k", (2, 2),
                                  dict(num_heads=5, num_kv_heads=5,
                                       head_dim=8, d_model=40, num_layers=1,
                                       encoder_layers=1)),
    # one stream: the cache's sequence over both dims, the logits'
    # vocabulary over ``model`` at the greedy argmax
    "jamba-v0.1-52b/long_500k": ("jamba-v0.1-52b", "long_500k", (2, 2),
                                 dict(vocab_size=256)),
    # the same on 1x4: the MoE router's input reaches it split on
    # ``model`` (the router runs per rank, that split gathered)
    "jamba-v0.1-52b/long_500k-on-1x4": ("jamba-v0.1-52b", "long_500k",
                                        (1, 4), dict(vocab_size=256)),
    # one stream on 1x4: DTensor split the state update's head dim P
    "mamba2-2.7b/long_500k": ("mamba2-2.7b", "long_500k", (1, 4), {}),
}


@pytest.mark.parametrize("cell", MESH_CELLS)
def test_reduced_cells_record_ok(cell, tmp_path):
    """Reduced cells where ``model`` divides the query heads but not the
    kv heads (yi and stablelm decode: 4 over 2 on 1x4), or not the heads
    at all (whisper train, self and cross attention: 5 on 2x2), record
    ``ok``: the attention core runs one shard a rank.  So do jamba's
    single-stream decode, whose greedy step takes the argmax of logits
    with a split vocabulary (on 1x4 its MoE router's input arrives split
    on ``model``), and mamba2's on 1x4, whose recurrence runs one shard
    a rank (``models/ssm.py``)."""
    arch, shape, mesh, over = MESH_CELLS[cell]
    cfg = reduced(get_config(arch), **over)
    with dryrun.fake_world(WORLD):
        rec = dryrun.run_cell(arch, shape, "single", out_dir=str(tmp_path),
                              cfg=cfg, mesh_shape=MeshShape(
                                  mesh, ("data", "model")))
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["cost"]["flops_per_device"] > 0
    assert not dist.is_initialized()


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
