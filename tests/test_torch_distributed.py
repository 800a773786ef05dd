"""The port's LM distribution layer on the CPU: DTensor placement by the
sharding rules, the sharded train step, elastic resharding through a
checkpoint, activation policies, gradient compression of DTensors,
``launch.train --mesh`` (``repro_torch.distributed``,
``models/partitioning.py``, ``launch/mesh.py``, ``launch/train.py``) on
four gloo ranks, and GPipe (``distributed/pipeline.py``) over stand-in
devices — against the JAX package.

The JAX package's own sharded step fails on the installed jax (its
embedding gather, ``src/repro/models/transformer.py:216``), so the port's
sharded step is held to the JAX package's UNSHARDED step, which is what
``tests/_multidevice_worker.py`` asserts ("sharded == single"), with its
bounds: loss within 1e-4, parameters within 5e-3.  Elastic losses within
1e-4 relative; the policy's logits within 1e-5 of scale; GPipe within
1e-5 of the JAX package's ``gpipe`` (run in a 4-host-device subprocess)
and bit-equal to its stages applied in order.

The four ranks (``tests/_torch_dist_worker.py``) start once for the file,
beside the four of the 2x2 launcher, and run while the JAX references are
computed; a rendezvous file under the test's temporary directory and a
free port keep parallel test workers apart.
"""

import functools
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jm
from repro import training as jt
from repro.data import BatchPipeline as JPipeline
from repro.data import CompressedCorpus as JCorpus
from repro.data import synthetic as jsynthetic
from repro_torch import models as tm
from repro_torch import training as tt
from repro_torch.checkpoint import flatten_with_paths
from repro_torch.configs import get_config
from repro_torch.distributed import (MeshShape, NamedSharding,
                                     default_rules, spec_for)
from repro_torch.distributed.pipeline import gpipe, make_pp_mesh
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as tlaunch
from repro_torch.models import partitioning as tpart
from _torch_dist_worker import (ATTN_CASES, DECODE_BATCH, DECODE_STEPS,
                                MOE_CASES, MOE_STEPS, MOE_WIDTHS, PROMPT,
                                SERVE_CASES, decode_tokens, frames)

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 4
LOSS_TOL = 1e-4          # tests/_multidevice_worker.py:63
PARAM_TOL = 5e-3         # tests/_multidevice_worker.py:67
ELASTIC_RTOL = 1e-4
LM_TOL = 1e-4            # logits: LM_TOL * max(1, max|jax|), test_torch_decode
POLICY_TOL = 1e-5
GPIPE_TOL = 1e-5
GLOBAL_BATCH, SEQ, LR, STEPS = 8, 16, 1e-2, 6


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the four gloo ranks of the scenarios and, beside them, the
    four of the 2x2 launcher; the returned function waits for them and
    gives each rank's results."""
    out = tmp_path_factory.mktemp("ranks")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    worker = os.path.join(HERE, "_torch_dist_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, mode, str(r), str(WORLD), rendezvous,
         str(out)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env)
        for mode, rendezvous in (("scenarios", str(out / "rendezvous")),
                                 ("launcher", str(_free_port())))
        for r in range(WORLD)]
    done = {}

    def results():
        if not done:
            # the ranks run at a lower priority (the worker's ``main``):
            # a busy host may hold them back for minutes
            logs = [p.communicate(timeout=600)[0] for p in procs]
            bad = [r for r, p in enumerate(procs) if p.returncode]
            assert not bad, f"worker {bad[0]} failed:\n{logs[bad[0]][-6000:]}"
            done["ranks"] = [
                dict(json.loads((out / f"rank{r}.json").read_text()),
                     **json.loads((out / f"launcher{r}.json").read_text()))
                for r in range(WORLD)]
            done["params"] = dict(np.load(out / "step_params.npz"))
            for case in MOE_CASES:
                done[f"moe_{case}"] = dict(np.load(out / f"moe_{case}.npz"))
            for case in ATTN_CASES:
                done[f"attn_{case}"] = dict(np.load(out /
                                                    f"attn_{case}.npz"))
            for case in SERVE_CASES:
                done[f"{case}_decode"] = dict(np.load(
                    out / f"{case}_decode.npz"))
        return done
    yield results
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


def _tiny():
    over = dict(dtype="float32", num_layers=2, d_model=32, num_heads=4,
                num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=400)
    return (jm.reduced(jconfigs.get_config("yi_9b"), **over),
            tm.reduced(get_config("yi_9b"), **over))


def _jax_train(jcfg, tcfg, steps: int, extra=None):
    """The JAX package's unsharded ``steps`` from the port's seed-0
    weights on corpus D's batches (with frame embeddings ``extra``):
    (losses, parameters after step 0, parameters after the last
    step)."""
    init = tm.lm_to_params(tm.init_lm(tcfg, torch.Generator().manual_seed(0),
                                      device="cpu"))
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()), init)
    cc = JCorpus.build(jsynthetic.make_table2_corpus("D"), vocab_size=400)
    pl = JPipeline(cc, global_batch=GLOBAL_BATCH, seq_len=SEQ, seed=0,
                   prefetch=0)
    opt = jt.AdamW(lr=LR)
    step = jax.jit(jt.make_train_step(jcfg, opt))
    state = opt.init(params)
    losses, kept = [], []
    for s in range(steps):
        x, y = pl.batch_at(s)
        batch = {"tokens": jnp.asarray(x), "labels": jnp.asarray(y)}
        if extra is not None:
            batch["extra_embeds"] = jnp.asarray(extra)
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        if s in (0, steps - 1):
            kept.append({k: np.asarray(v) for k, v in flatten_with_paths(
                jax.tree.map(np.asarray, params))})
    return losses, kept[0], kept[-1]


@pytest.fixture(scope="module")
def jax_moe(ranks):
    """The JAX package's unsharded ``MOE_STEPS`` of each MoE case:
    ``{case: (losses, parameters after the last step)}``."""
    out = {}
    for case in MOE_CASES:
        losses, _, last = _jax_train(*_moe_cfgs(case), MOE_STEPS)
        out[case] = (losses, last)
    return out


def _attn_cfgs(case):
    arch, over, _, _ = ATTN_CASES[case]
    return (jm.reduced(jconfigs.get_config(arch), **over),
            tm.reduced(get_config(arch), **over))


@pytest.fixture(scope="module")
def jax_attn(ranks):
    """The JAX package's unsharded step 0 of each attention case
    (loss, parameters after it), and each serving case's parallel logits
    of the prompt and ``decode_step`` logits token by token."""
    out, by_cfg = {}, {}
    for case, (arch, over, _, _) in ATTN_CASES.items():
        key = (arch, repr(over))   # a policy does not change the step
        if key not in by_cfg:
            jcfg, tcfg = _attn_cfgs(case)
            extra = frames(tcfg) if tcfg.family == "encdec" else None
            losses, first, _ = _jax_train(jcfg, tcfg, 1, extra)
            by_cfg[key] = (losses[0], first)
        out[case] = by_cfg[key]
    toks = decode_tokens()
    for case in SERVE_CASES:
        jcfg, tcfg = (_attn_cfgs if case == "gqa" else _moe_cfgs)(case)
        params = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                              tm.lm_to_params(tm.init_lm(
                                  tcfg, torch.Generator().manual_seed(0),
                                  device="cpu")))
        parallel, _ = jm.apply_lm(jcfg, params,
                                  jnp.asarray(toks[:, :PROMPT]))
        cache = jm.init_cache(jcfg, DECODE_BATCH, PROMPT + DECODE_STEPS + 1)
        step = jax.jit(functools.partial(jm.decode_step, jcfg))
        steps = []
        for t in range(PROMPT + DECODE_STEPS):
            lg, cache = step(params, cache, jnp.asarray(toks[:, t:t + 1]))
            steps.append(np.asarray(lg)[:, 0])
        out[f"{case}_decode"] = (np.asarray(parallel), np.stack(steps))
    return out


@pytest.fixture(scope="module")
def jax_run(ranks, jax_moe, jax_attn):
    """The JAX package's unsharded steps 0-5 of the tiny dense config:
    (losses, parameters after step 0).  With it, the MoE and attention
    references: all are computed while the ranks run, before the first
    wait."""
    losses, first, _ = _jax_train(*_tiny(), STEPS)
    return losses, first


def test_sharded_step_matches_the_jax_unsharded_step(ranks, jax_run):
    """One AdamW step on a 2x2 mesh (parameters, moments and batch placed
    by the rules) against the JAX package's step on one device."""
    res = ranks()
    losses, want = jax_run
    for r in res["ranks"]:
        assert abs(r["step_loss"] - losses[0]) < LOSS_TOL, (r["step_loss"],
                                                            losses[0])
    got = res["params"]
    assert set(got) == set(want)
    d = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    assert d < PARAM_TOL, d


def test_elastic_resume_matches_the_continuous_run_and_jax(ranks, jax_run):
    """Steps 0-5 on 4x1 == steps 0-2 on 4x1, a checkpoint, steps 3-5 on
    2x2; both == the JAX package's unsharded steps."""
    losses, _ = jax_run
    for r in ranks()["ranks"]:
        np.testing.assert_allclose(r["elastic_resumed"],
                                   r["elastic_continuous"],
                                   rtol=ELASTIC_RTOL)
        np.testing.assert_allclose(r["elastic_continuous"], losses,
                                   rtol=ELASTIC_RTOL)
        np.testing.assert_allclose(r["elastic_resumed"], losses,
                                   rtol=ELASTIC_RTOL)


def _placements(spec_axes, shape, mesh_shape):
    mesh = MeshShape(mesh_shape, ("data", "model"))
    return str(NamedSharding(mesh, spec_for(
        spec_axes, shape, mesh, default_rules(mesh))).placements)


def test_to_local_is_the_rules_slice(ranks):
    """Every parameter's local shard equals the rules' slice of the full
    tensor at the rank's coordinate; the moments are placed like their
    parameters (stacked: a leading "layers" dim), also after the
    elastic reshard."""
    _, tcfg = _tiny()
    wq = ("layers", "embed", "heads", "head_dim")
    embed = ("vocab", "embed")
    for r in ranks()["ranks"]:
        assert r["to_local_err"] == 0.0
        assert r["to_local_sharded"] > 0
        assert r["moment_placements"] == _placements(
            wq, (2, 32, 4, 8), (2, 2))
        assert r["elastic_moment_placements"] == _placements(
            embed, (400, 32), (2, 2))


def test_activation_policy_redistributes_dtensors(ranks):
    """``act_btd`` on ``data`` and ``logits`` on (``data``, -, ``model``):
    every ``constrain`` call (seen through a spy) leaves its activation on
    the policy's placements, some of them changed by it, and the logits
    stay within 1e-5 of scale of the run without a policy."""
    want = {"act_btd": "(Shard(dim=0), Replicate())",
            "logits": "(Shard(dim=0), Shard(dim=2))"}
    for r in ranks()["ranks"]:
        assert r["policy_err"] <= POLICY_TOL
        calls = r["policy_constrained"]
        assert set(want) <= {k for k, _, _ in calls}
        # a kind the policy names ends on its placements; another
        # ("attn_q") passes through
        assert all(out == want.get(k, before) for k, before, out in calls)
        assert any(before != out for k, before, out in calls
                   if k == "act_btd")
        assert r["policy_logits_placements"] == want["logits"]


def test_gradient_compression_of_dtensors(ranks):
    """``int8_roundtrip`` and ``topk_compress`` (its float64 quotient, its
    error buffer placed like the gradient) of DTensors equal the same
    transforms of the full tensors."""
    for r in ranks()["ranks"]:
        assert r["compress_equal"] == [True, True]


def test_launcher_mesh_2x2_matches_1x1(ranks):
    """``launch.train --device cpu --reduced --mesh 2x2`` on four ranks
    started as torchrun starts them == ``--mesh 1x1`` (a world of one),
    losses within 1e-4 relative; the launcher leaves the group."""
    one = tlaunch.main(["--device", "cpu", "--reduced", "--steps", "3",
                        "--global-batch", "4", "--seq-len", "16",
                        "--mesh", "1x1"])
    assert not torch.distributed.is_initialized()
    for r in ranks()["ranks"]:
        np.testing.assert_allclose(r["launcher"], one["history"],
                                   rtol=ELASTIC_RTOL)
        assert not r["launcher_initialized_after"]


def _moe_cfgs(case):
    arch, over = MOE_CASES[case]
    over = dict(MOE_WIDTHS, **over)
    return (jm.reduced(jconfigs.get_config(arch), **over),
            tm.reduced(get_config(arch), **over))


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_step_on_a_mesh_matches_the_jax_unsharded_step(case, ranks,
                                                           jax_moe):
    """MoE and hybrid archs on a 2x2 mesh (the routed experts one shard a
    rank, ``models/moe.py``): ``MOE_STEPS`` AdamW steps within the dense
    bounds of the JAX package's unsharded steps, and the first MoE
    layer's routing indices equal to ``lax.top_k`` of the JAX package's
    router on that layer's input.  ``qwen2_moe_e3``'s 3 experts do not
    split over ``model``: the rules shard each expert's ffn dim."""
    jcfg, _ = _moe_cfgs(case)
    losses, want = jax_moe[case]
    res = ranks()
    split = "Shard(dim=2)" if case.endswith("e3") else "Shard(dim=0)"
    idx = {}
    for r in res["ranks"]:
        got = r[f"moe_{case}"]
        np.testing.assert_allclose(got["losses"], losses, rtol=0,
                                   atol=LOSS_TOL)
        assert got["expert_placements"].endswith(f"{split})")
        idx.setdefault(got["data_coord"], got["idx"])
        assert idx[got["data_coord"]] == got["idx"]   # model ranks agree
    saved = res[f"moe_{case}"]
    d = max(float(np.abs(saved[k] - want[k]).max()) for k in want)
    assert d < PARAM_TOL, d
    probs = jax.nn.softmax(jnp.einsum(
        "bsd,de->bse", jnp.asarray(saved["x"]), jnp.asarray(
            saved["router"])), axis=-1)
    _, jidx = jax.lax.top_k(probs, jcfg.moe_top_k)
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(idx[c]) for c in sorted(idx)]),
        np.asarray(jidx))


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_step_on_a_mesh_matches_the_jax_unsharded_step(
        case, ranks, jax_attn):
    """Attention whose heads ``model`` splits unevenly, its core one shard
    a rank (``models/layers.py``): ``gqa``'s 8 query heads split 2 a rank
    over 1x4 while its 2 kv heads stay replicated; ``gqa_seq``, the same
    under the ``attn_q`` policy, its query's sequence split 4 ways over
    ``model`` (each shard's causal offset, ``wo``'s partial gradient and
    the gather of ``attn_out``); ``gqa``'s second layer, its residual
    stream held by no policy, projects its query heads split as the
    first does (the projections run one shard a rank); ``whisper``'s 5
    heads (self and cross attention) on 2x2, which 2 does not divide, so
    DTensor's strategy projects the query with the batch rows split over
    ``model`` and the core splits them so.  One AdamW step within the
    dense bounds of the JAX package's unsharded step."""
    loss, want = jax_attn[case]
    res = ranks()
    wq = {"gqa": "(Replicate(), Shard(dim=1))",
          "gqa_seq": "(Replicate(), Shard(dim=1))",
          "whisper": "(Shard(dim=0), Replicate())"}[case]
    # the query on ``model``: heads (both layers); the sequence; rows
    q = {"gqa": ["S(2)"], "gqa_seq": ["S(1)"], "whisper": ["S(0)"]}[case]
    for r in res["ranks"]:
        got = r[f"attn_{case}"]
        assert abs(got["loss"] - loss) < LOSS_TOL, (got["loss"], loss)
        assert got["wq_placements"] == wq
        assert got["wk_placements"].endswith("Replicate())")
        assert got["q_model_placements"] == q
    saved = res[f"attn_{case}"]
    assert set(saved) == set(want)
    d = max(float(np.abs(saved[k] - want[k]).max()) for k in want)
    assert d < PARAM_TOL, d


@pytest.mark.parametrize("case", SERVE_CASES)
def test_serving_on_a_mesh_matches_jax(case, ranks, jax_attn):
    """``gqa`` on 1x4, its cache's sequence split over ``model`` (2 kv
    heads do not divide 4), and ``jamba`` on 2x2 (rows over ``data``; kv
    heads and the mamba state's heads over ``model``) serve: the parallel
    logits of the prompt and ``make_serve_step``'s logits through the
    prompt and three more tokens, each within 1e-4 of scale of the JAX
    package's; its greedy tokens are the argmax of the JAX package's
    logits, and its argmax of logits whose vocabulary is split over
    ``model`` that of the whole logits."""
    parallel, steps = jax_attn[f"{case}_decode"]
    got = ranks()[f"{case}_decode"]
    split = {"gqa": ["(Replicate(), Shard(dim=2))"] * 2,
             # layer 0 is a mamba layer: its state's heads, its conv
             # tail's channels
             "jamba": ["(Shard(dim=1), Shard(dim=2))",
                       "(Shard(dim=1), Shard(dim=3))"]}[case]
    for r in ranks()["ranks"]:
        assert r[f"{case}_cache_placements"] == split
        assert r[f"{case}_argmax_over_a_split_vocabulary"]
        assert np.array_equal(np.asarray(r[f"{case}_greedy"]),
                              steps.argmax(-1))
    for g, w in ((got["parallel"], parallel), (got["steps"], steps)):
        assert g.shape == w.shape
        err = float(np.abs(g - w).max()) / max(1.0, float(np.abs(w).max()))
        assert err <= LM_TOL, err


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "jamba-v0.1-52b"])
def test_launcher_trains_moe_archs_on_a_mesh(arch):
    """``launch.train --mesh 1x1 --reduced`` trains the MoE and hybrid
    archs (their routed experts through ``local_map``), with the plain
    path's losses bit for bit, and leaves the process group."""
    argv = ["--device", "cpu", "--reduced", "--arch", arch, "--steps", "2",
            "--global-batch", "2", "--seq-len", "8"]
    plain = tlaunch.main(argv)["history"]
    mesh = tlaunch.main(argv + ["--mesh", "1x1"])["history"]
    assert all(np.isfinite(plain))
    assert mesh == plain
    assert not torch.distributed.is_initialized()


def test_launcher_names_the_family_of_an_op_dtensor_cannot_shard(
        monkeypatch):
    """An op with no DTensor strategy raises ``NotImplementedError``; on
    a mesh the launcher re-raises it naming the arch's family, and leaves
    the process group."""
    from repro_torch.models import moe as tmoe

    def unsharded(*args, **kwargs):
        raise NotImplementedError("aten.example: no sharding strategy")
    monkeypatch.setattr(tmoe, "_dispatch_on_mesh", unsharded)
    with pytest.raises(NotImplementedError,
                       match=r"\(moe family\).*aten.example"):
        tlaunch.main(["--device", "cpu", "--reduced", "--arch",
                      "qwen2-moe-a2.7b", "--steps", "1", "--global-batch",
                      "2", "--seq-len", "8", "--mesh", "1x1"])
    assert not torch.distributed.is_initialized()


@pytest.fixture
def world_of_one():
    """A gloo process group of one rank and its 1x1 mesh."""
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://localhost:{_free_port()}", world_size=1,
        rank=0)
    try:
        yield tmesh.make_host_mesh(1, 1, device_type="cpu")
    finally:
        torch.distributed.destroy_process_group()


def test_one_rank_mesh_step_is_the_plain_step(world_of_one):
    """On a 1x1 mesh every rule replicates, so a step (two microbatches)
    equals the plain step bit for bit: the loss, the parameters and the
    stacked AdamW moments, which the optimizer writes through per-layer
    views of DTensors."""
    _one_rank_step_is_plain(_tiny()[1], world_of_one)


def test_one_rank_mesh_moe_step_is_the_plain_step(world_of_one):
    """The same for a MoE arch: on a world of one the routed experts'
    local function is the plain dispatch with every expert."""
    _one_rank_step_is_plain(_moe_cfgs("qwen2_moe")[1], world_of_one)


def _one_rank_step_is_plain(cfg, world_of_one):
    from repro_torch.distributed import distribute_lm
    from torch.distributed.tensor import DTensor
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, 400, (4, 8)))
             for k in ("tokens", "labels")}
    opt = tt.AdamW(lr=LR)
    out = []
    for mesh in (None, world_of_one):
        model = tm.init_lm(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
        b = batch
        if mesh is not None:
            distribute_lm(model, mesh)
            b = {k: DTensor.from_local(v, mesh, NamedSharding(
                mesh, ()).placements) for k, v in batch.items()}
        step = tt.make_train_step(cfg, opt, microbatches=2)
        model, state, met = step(model, opt.init(tm.lm_to_params(model)), b)
        out.append((float(met["loss"]), _full_leaves(tm.lm_to_params(model)),
                    _full_leaves(state.mu), _full_leaves(state.nu)))
    (l0, *trees0), (l1, *trees1) = out
    assert l1 == l0
    for t0, t1 in zip(trees0, trees1):
        assert all(torch.equal(a, b) for a, b in zip(t0, t1))
    assert any(bool(v.abs().sum() > 0) for v in trees1[1])


def _full_leaves(tree):
    from torch.distributed.tensor import DTensor
    return [v.full_tensor() if isinstance(v, DTensor) else v
            for _, v in flatten_with_paths(tree)]


def test_mesh_of_the_wrong_size_raises(ranks):
    """A 3x1 host mesh in a world of 4 raises, as the JAX ``assert`` does;
    so does a host mesh with no process group."""
    for r in ranks()["ranks"]:
        assert "needs 3 ranks" in r["mesh_3x1_error"]
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_host_mesh(1, 1)


def test_policy_on_a_plain_tensor_raises():
    with tpart.activation_policy({"act_btd": ("data", None, None)}):
        with pytest.raises(TypeError, match="plain tensor"):
            tpart.constrain(torch.ones(2, 3, 4), "act_btd")
    with pytest.raises(TypeError, match="PartitionSpec"):
        tpart.set_policy({"act_btd": "data"})
    assert tpart.get_policy() == {}


# ------------------------------------------------------------------ GPipe --
_JAX_GPIPE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[1])
import jax, jax.numpy as jnp, numpy as np
from repro.distributed.pipeline import gpipe, make_pp_mesh
d = np.load(sys.argv[2])
out = gpipe(lambda w, x: jnp.tanh(x @ w), make_pp_mesh(4), 4)(
    jnp.asarray(d["ws"]), jnp.asarray(d["mb"]))
np.save(sys.argv[3], np.asarray(out))
"""


def _gpipe_inputs():
    rng = np.random.default_rng(0)
    ws = rng.normal(size=(4, 16, 16)).astype(np.float32) * 0.5
    mb = rng.normal(size=(6, 3, 16)).astype(np.float32)
    return ws, mb


def test_gpipe_matches_jax_and_the_stages_in_order(tmp_path):
    """``_multidevice_worker.py``'s pipeline (4 stages of tanh(x @ w), 6
    microbatches) over ``("cpu",) * 4``: within 1e-5 of the JAX package's
    ``gpipe`` on 4 host devices, and bit-equal to the stages applied in
    order to each microbatch."""
    ws, mb = _gpipe_inputs()
    np.savez(tmp_path / "in.npz", ws=ws, mb=mb)
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_GPIPE,
         os.path.join(HERE, "..", "src"), str(tmp_path / "in.npz"),
         str(tmp_path / "out.npy")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    run = gpipe(lambda w, x: torch.tanh(x @ w), make_pp_mesh(
        4, ("cpu",) * 4), 4)
    got = run(torch.from_numpy(ws), torch.from_numpy(mb))
    seq = []
    for m in torch.from_numpy(mb):
        for w in torch.from_numpy(ws):
            m = torch.tanh(m @ w)
        seq.append(m)
    assert torch.equal(got, torch.stack(seq))
    log = proc.communicate(timeout=120)[0]
    assert proc.returncode == 0, log
    want = np.load(tmp_path / "out.npy")
    np.testing.assert_allclose(got.numpy(), want, atol=GPIPE_TOL, rtol=0)


def test_gpipe_runs_the_classic_schedule():
    """At tick t stage i runs microbatch t - i: (M + S - 1) ticks, each
    stage's slice on its own device of the list (devices may repeat)."""
    S, M = 3, 5
    calls = []

    def stage_fn(p, x):
        calls.append((int(p["id"]), int(x[0])))
        return x + 1
    params = {"id": torch.arange(S)}
    mbs = torch.arange(M)[:, None] * 100
    out = gpipe(stage_fn, ("cpu",) * S, S)(params, mbs)
    assert torch.equal(out, mbs + S)
    want = [(i, 100 * (t - i) + i) for t in range(M + S - 1)
            for i in reversed(range(S)) if 0 <= t - i < M]
    assert calls == want


def test_make_pp_mesh_raises_with_too_few_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="4-stage pipeline needs 4"):
        make_pp_mesh(4)
    with pytest.raises(RuntimeError, match="needs 4"):
        make_pp_mesh(4, ("cpu",) * 3)
    assert make_pp_mesh(2, ("cpu",) * 4) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="3 stages need 3"):
        gpipe(lambda p, x: x, ("cpu",) * 2, 3)
