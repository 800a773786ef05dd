"""One of four gloo CPU ranks for ``tests/test_torch_distributed.py``.

    python tests/_torch_dist_worker.py scenarios RANK WORLD INIT_FILE OUT_DIR
    python tests/_torch_dist_worker.py launcher RANK WORLD PORT OUT_DIR

``scenarios``: under one process group (``file://INIT_FILE``), in order:

1. ``step``: the tiny config of ``_multidevice_worker.py`` takes one AdamW
   step on a 2x2 ``(data, model)`` mesh, each rank feeding the batch rows
   of its ``data`` coordinate; the loss, and (rank 0) the parameters
   after the step; every parameter's ``to_local()`` against the rules'
   slice of the full tensor.
2. ``elastic``: steps 0-5 on 4x1; steps 0-2 on 4x1, a checkpoint, steps
   3-5 on 2x2 (the moments placed by ``reshard_tree``).
3. ``policy``: the forward pass on 2x2 with and without an activation
   policy, each ``constrain`` call seen through a spy (kind, placements
   in and out).
4. ``compress``: ``int8_roundtrip`` and ``topk_compress`` of DTensor
   gradients against the same transforms of the full tensors.
5. ``moe``: each case of :data:`MOE_CASES` takes ``MOE_STEPS`` AdamW
   steps on 2x2; the losses, (rank 0) the parameters after them
   and the first MoE layer's input and router, and each rank's routing
   indices of that layer with its ``data`` coordinate.
6. ``attention``: attention whose heads ``model`` splits unevenly
   (``models/layers.py``, the core one shard a rank), the cases of
   :data:`ATTN_CASES`: ``gqa``, 8 query heads over 2 kv heads on 1x4
   (kv heads replicated, query heads 2 a rank), ``gqa_seq``, the same
   under the ``attn_q`` policy (the query's sequence split over
   ``model``), and ``whisper``, 5 heads on 2x2 (its cross attention too,
   on the frames :func:`frames` gives), each take one AdamW step; the
   query's placements on ``model`` after ``constrain(q, "attn_q")``.  Then each of :data:`SERVE_CASES` serves:
   the parallel logits of a :data:`PROMPT`-token prompt, and
   ``make_serve_step`` through the prompt and :data:`DECODE_STEPS` more
   tokens against a cache placed by the rules (logits and greedy
   tokens), and its argmax of logits whose vocabulary ``model`` splits.
   (Rank 0) the parameters after each step and the logits.
7. ``raises``: a 3x1 host mesh in a world of 4.

Each rank writes ``OUT_DIR/rank<r>.json``; rank 0 also writes
``OUT_DIR/step_params.npz``, ``OUT_DIR/moe_<case>.npz``,
``OUT_DIR/attn_<case>.npz`` and ``OUT_DIR/<case>_decode.npz``.
``launcher``: ``repro_torch.launch.train --mesh 2x2`` as ``torchrun``
starts it (``env://`` on ``PORT``), writing ``OUT_DIR/launcher<r>.json``.
"""

import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import models as tm
from repro_torch import training as tt
from repro_torch.checkpoint import (flatten_with_paths, restore_checkpoint,
                                    save_checkpoint, unflatten)
from repro_torch.configs import get_config
from repro_torch.data import BatchPipeline, CompressedCorpus, synthetic
from repro_torch.distributed import (NamedSharding, PartitionSpec,
                                     cache_shardings, default_rules,
                                     distribute_lm,
                                     elastic_pipeline, reshard_tree,
                                     spec_for)
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as tlaunch
from repro_torch.models import moe as tmoe
from repro_torch.models import partitioning as tpart
from repro_torch.serving import make_serve_step
from repro_torch.serving.decode import _argmax as serve_argmax
from repro_torch.models import transformer as ttransformer
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

GLOBAL_BATCH, SEQ, LR, STEPS, CUT = 8, 16, 1e-2, 6, 3
MOE_STEPS = 2
# case: (arch, overrides of ``reduced``) at the widths of ``tiny`` (DTensor
# then reuses the sharding decisions of the dense scenarios); 4 experts
# split over ``model`` (EP), 3 do not, so the rules split each expert's
# ffn dim instead
MOE_WIDTHS = dict(dtype="float32", d_model=32, num_heads=4, num_kv_heads=2,
                  head_dim=8, d_ff=64, moe_d_ff=64, vocab_size=400)
MOE_CASES = {
    "qwen2_moe": ("qwen2_moe_a27b", {}),
    "qwen2_moe_e3": ("qwen2_moe_a27b", {"moe_num_experts": 3}),
    "jamba": ("jamba_v01_52b", {"num_layers": 8}),
}

# attention cases: (arch, overrides of ``reduced``, mesh (data, model),
# activation policy); ``gqa_seq`` is ``gqa`` under the ``attn_q`` policy
# that ``launch/dryrun.make_activation_policy`` gives a train cell whose
# kv heads ``model`` does not divide: the query's sequence split over
# ``model``, its causal mask offset by each shard's first row
GQA = ("yi_9b", dict(dtype="float32", num_layers=2, d_model=32, num_heads=8,
                     num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=400))
ATTN_CASES = {
    "gqa": (*GQA, (1, 4), {}),
    "gqa_seq": (*GQA, (1, 4),
                {"attn_q": PartitionSpec("data", "model", None, None)}),
    "whisper": ("whisper_large_v3", dict(dtype="float32", d_model=40,
                                         num_heads=5, num_kv_heads=5,
                                         head_dim=8, d_ff=64,
                                         vocab_size=400), (2, 2), {}),
}
PROMPT, DECODE_STEPS, DECODE_BATCH = 4, 3, 2
# serving cases: ``gqa`` on 1x4 (its cache's sequence split over
# ``model``), and ``jamba`` on 2x2 (rows over ``data``; kv heads and the
# mamba state's heads over ``model``)
SERVE_CASES = ("gqa", "jamba")


def attn_cfg(case):
    arch, over, _, _ = ATTN_CASES[case]
    return tm.reduced(get_config(arch), **over)


def serve_cfg(case):
    """(config, mesh (data, model)) of a serving case."""
    if case == "gqa":
        return attn_cfg("gqa"), ATTN_CASES["gqa"][2]
    arch, over = MOE_CASES[case]
    return tm.reduced(get_config(arch), **MOE_WIDTHS, **over), (2, 2)


def frames(cfg):
    """Whisper's stub frame embeddings for every step's global batch."""
    rng = np.random.default_rng(5)
    return rng.normal(size=(GLOBAL_BATCH, cfg.encoder_seq, cfg.d_model)
                      ).astype(np.float32)


def decode_tokens():
    """The GQA decode's tokens: the prompt, then the decoded ones."""
    rng = np.random.default_rng(6)
    return rng.integers(0, 400, (DECODE_BATCH, PROMPT + DECODE_STEPS))


def tiny():
    return tm.reduced(get_config("yi_9b"), dtype="float32", num_layers=2,
                      d_model=32, num_heads=4, num_kv_heads=2, head_dim=8,
                      d_ff=64, vocab_size=400)


def corpus():
    return CompressedCorpus.build(synthetic.make_table2_corpus("D"),
                                  vocab_size=400)


def model_on(cfg, mesh):
    model = tm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    return distribute_lm(model, mesh, default_rules(mesh))


def batch_on(cc, mesh, step, extra=None):
    """Step ``step``'s global batch as DTensors: this rank reads the rows
    of its ``data`` coordinate (of ``extra``, the global frames, too)."""
    d, c = mesh.shape[0], mesh.get_coordinate()[0]
    pl = elastic_pipeline(cc, global_batch=GLOBAL_BATCH, seq_len=SEQ,
                          seed=0, resume_step=step, shard=c, num_shards=d)
    x, y = pl.batch_at(step)
    rows = {"tokens": x, "labels": y}
    if extra is not None:
        n = GLOBAL_BATCH // d
        rows["extra_embeds"] = extra[c * n:(c + 1) * n]
    return {k: DTensor.from_local(torch.from_numpy(v), mesh,
                                  (Shard(0), Replicate()), run_check=False)
            for k, v in rows.items()}


def full_params(model):
    return {k: v.full_tensor().numpy() for k, v in
            flatten_with_paths(tm.lm_to_params(model))}


def scenario_step(cfg, cc, out, rank):
    mesh = tmesh.make_host_mesh(model=2, data=2, device_type="cpu")
    model = model_on(cfg, mesh)
    # every parameter's local shard is the rules' slice of the full tensor
    ref = tm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    rules = default_rules(mesh)
    coord = tuple(mesh.get_coordinate())
    worst, sharded = 0.0, 0
    for (name, p), (_, r) in zip(model.named_parameters(),
                                 ref.named_parameters()):
        axes = _axes_of(model, name)
        sh = NamedSharding(mesh, spec_for(axes, p.shape, mesh, rules))
        want = r.detach()[sh.index(coord, tuple(p.shape))]
        got = p.to_local()
        if got.shape != want.shape:
            worst = float("inf")
            continue
        worst = max(worst, float((got - want).abs().max()))
        sharded += int(any(pl.is_shard() for pl in p.placements))
    out["to_local_err"] = worst
    out["to_local_sharded"] = sharded

    opt = tt.AdamW(lr=LR)
    step = tt.make_train_step(cfg, opt)
    state = opt.init(tm.lm_to_params(model))
    model, state, met = step(model, state, batch_on(cc, mesh, 0))
    out["step_loss"] = float(met["loss"])
    out["moment_placements"] = str(state.mu["blocks"][0]["attn"]["wq"]
                                   .placements)
    params = full_params(model)
    if rank == 0:
        np.savez(os.path.join(out["dir"], "step_params.npz"), **params)


def _axes_of(model, dotted):
    node = model
    *path, leaf = dotted.split(".")
    for part in path:
        node = node[int(part)] if part.isdigit() else getattr(node, part)
    return node.axes[leaf]


def scenario_elastic(cfg, cc, out, rank):
    opt = tt.AdamW(lr=LR)
    step = tt.make_train_step(cfg, opt)

    def run(mesh, model, state, start, stop, losses):
        for s in range(start, stop):
            model, state, met = step(model, state, batch_on(cc, mesh, s))
            losses.append(float(met["loss"]))
        return model, state

    m41 = tmesh.make_host_mesh(model=1, data=4, device_type="cpu")
    model = model_on(cfg, m41)
    cont = []
    run(m41, model, opt.init(tm.lm_to_params(model)), 0, STEPS, cont)

    resumed = []
    model = model_on(cfg, m41)
    model, state = run(m41, model, opt.init(tm.lm_to_params(model)), 0, CUT,
                       resumed)
    with tempfile.TemporaryDirectory() as tmp:
        # rank 0's directory for every rank: the ranks share a file system
        obj = [tmp]
        dist.broadcast_object_list(obj, src=0)
        save_checkpoint(obj[0], CUT, {"params": tm.lm_to_params(model),
                                      "opt": state})
        template = {"params": tm.lm_to_params(model), "opt": state}
        tree, ck_step, _ = restore_checkpoint(obj[0], template)
        dist.barrier()
    m22 = tmesh.make_host_mesh(model=2, data=2, device_type="cpu")
    model = model_on(cfg, m22)
    tm.lm_load_params(model, tree["params"])
    flat_axes = tm.lm_axes(model)
    axes = unflatten(tree["opt"].mu, [
        flat_axes[k] for k, _ in flatten_with_paths(tree["opt"].mu)])
    rules = default_rules(m22)
    state = tt.AdamWState(
        count=torch.as_tensor(np.asarray(tree["opt"].count)),
        mu=reshard_tree(_tensors(tree["opt"].mu), axes, m22, rules),
        nu=reshard_tree(_tensors(tree["opt"].nu), axes, m22, rules))
    out["elastic_moment_placements"] = str(state.nu["embed"].placements)
    run(m22, model, state, ck_step, STEPS, resumed)
    out["elastic_continuous"] = cont
    out["elastic_resumed"] = resumed


def _tensors(tree):
    return unflatten(tree, [torch.as_tensor(np.asarray(v)) for _, v in
                            flatten_with_paths(tree)])


def scenario_policy(cfg, cc, out, rank):
    mesh = tmesh.make_host_mesh(model=2, data=2, device_type="cpu")
    model = model_on(cfg, mesh)
    tokens = batch_on(cc, mesh, 0)["tokens"]
    policy = {"act_btd": PartitionSpec("data", None, None),
              "logits": PartitionSpec("data", None, "model")}
    seen = []

    def spy(x, kind):
        y = tpart.constrain(x, kind)
        seen.append((kind, str(x.placements), str(y.placements)))
        return y
    real = ttransformer.constrain
    with torch.no_grad():
        plain, _ = tm.apply_lm(cfg, model, tokens)
        ttransformer.constrain = spy
        try:
            with tpart.activation_policy(policy):
                got, _ = tm.apply_lm(cfg, model, tokens)
        finally:
            ttransformer.constrain = real
    want = plain.full_tensor()
    out["policy_err"] = float((got.full_tensor() - want).abs().max()) / max(
        1.0, float(want.abs().max()))
    out["policy_logits_placements"] = str(got.placements)
    out["policy_constrained"] = seen


def scenario_compress(out):
    mesh = tmesh.make_host_mesh(model=2, data=2, device_type="cpu")
    g = torch.randn(8, 12, generator=torch.Generator().manual_seed(0))
    full = {"a": g, "b": [3 * g[:4]]}
    placed = {"a": DTensor.from_local(
        g[full_slices(mesh, (Shard(0), Shard(1)), g.shape)], mesh,
        (Shard(0), Shard(1)), run_check=False),
        "b": [distribute_tensor(3 * g[:4], mesh, (Shard(1), Replicate()))]}
    same = []
    for fn in (tt.int8_roundtrip,
               lambda t: tt.topk_compress(t, tt.init_error(t), 0.1)):
        want = flatten_with_paths(fn(full))
        got = flatten_with_paths(fn(placed))
        same.append(all(isinstance(x, DTensor)
                        and torch.equal(x.full_tensor(), y)
                        for (_, x), (_, y) in zip(got, want)))
    out["compress_equal"] = same


def full_slices(mesh, placements, shape):
    """This rank's slice of a tensor of ``shape`` split by ``placements``
    over a 2-d mesh (even splits)."""
    idx = [slice(None)] * len(shape)
    for mdim, p in enumerate(placements):
        if p.is_shard():
            n = shape[p.dim] // mesh.shape[mdim]
            c = mesh.get_coordinate()[mdim]
            idx[p.dim] = slice(c * n, (c + 1) * n)
    return tuple(idx)


def scenario_moe(cc, out, rank):
    mesh = tmesh.make_host_mesh(model=2, data=2, device_type="cpu")
    real_probs, real_plan = tmoe._router_probs, tmoe._plan
    try:
        for case, (arch, over) in MOE_CASES.items():
            cfg = tm.reduced(get_config(arch), **MOE_WIDTHS, **over)
            seen = {}

            def probs_spy(p, x):
                if "x" not in seen:
                    seen["x"] = x.full_tensor().detach().numpy()
                    seen["router"] = p["router"].full_tensor().detach(
                    ).numpy()
                return real_probs(p, x)

            def plan_spy(probs, cfg):
                res = real_plan(probs, cfg)
                seen.setdefault("idx", res[0].tolist())
                return res
            tmoe._router_probs, tmoe._plan = probs_spy, plan_spy
            model = model_on(cfg, mesh)
            opt = tt.AdamW(lr=LR)
            step = tt.make_train_step(cfg, opt)
            state = opt.init(tm.lm_to_params(model))
            losses = []
            for s in range(MOE_STEPS):
                model, state, met = step(model, state, batch_on(cc, mesh, s))
                losses.append(float(met["loss"]))
            tmoe._router_probs, tmoe._plan = real_probs, real_plan
            # layer 1 is a MoE layer of both archs
            out[f"moe_{case}"] = {
                "losses": losses, "idx": seen["idx"],
                "data_coord": mesh.get_coordinate()[0],
                "expert_placements": str(model.layers[1].moe.wi.placements)}
            params = full_params(model)
            if rank == 0:
                np.savez(os.path.join(out["dir"], f"moe_{case}.npz"),
                         x=seen["x"], router=seen["router"], **params)
    finally:
        tmoe._router_probs, tmoe._plan = real_probs, real_plan


def scenario_attention(cc, out, rank):
    real = ttransformer.constrain
    for case, (_, _, (d, m), policy) in ATTN_CASES.items():
        cfg = attn_cfg(case)
        mesh = tmesh.make_host_mesh(model=m, data=d, device_type="cpu")
        model = model_on(cfg, mesh)
        extra = frames(cfg) if cfg.family == "encdec" else None
        opt = tt.AdamW(lr=LR)
        step = tt.make_train_step(cfg, opt)
        seen = set()

        def spy(x, kind):
            y = real(x, kind)
            if kind == "attn_q":   # the model dim's placement
                seen.add(str(y.placements[-1]))
            return y
        ttransformer.constrain = spy
        try:
            with tpart.activation_policy(policy):
                model, _, met = step(model, opt.init(tm.lm_to_params(model)),
                                     batch_on(cc, mesh, 0, extra))
        finally:
            ttransformer.constrain = real
        out[f"attn_{case}"] = {
            "loss": float(met["loss"]),
            "wq_placements": str(model.layers[0].attn.wq.placements),
            "wk_placements": str(model.layers[0].attn.wk.placements),
            "q_model_placements": sorted(seen)}
        params = full_params(model)
        if rank == 0:
            np.savez(os.path.join(out["dir"], f"attn_{case}.npz"), **params)
    for case in SERVE_CASES:
        serve_case(case, out, rank)


def serve_case(case, out, rank):
    """A config of :data:`SERVE_CASES` serves on its mesh: the parallel
    logits of the prompt, then ``make_serve_step`` token by token."""
    cfg, (d, m) = serve_cfg(case)
    mesh = tmesh.make_host_mesh(model=m, data=d, device_type="cpu")
    model = model_on(cfg, mesh)
    toks = torch.from_numpy(decode_tokens())
    rep = (Replicate(), Replicate())
    with torch.no_grad():
        full, _ = tm.apply_lm(cfg, model, DTensor.from_local(
            toks[:, :PROMPT], mesh, rep, run_check=False))
        cache = tm.init_cache(cfg, DECODE_BATCH, PROMPT + DECODE_STEPS + 1,
                              device="cpu")
        shardings = cache_shardings(cfg, cache, mesh, default_rules(mesh))
        cache = map_leaves(cache, shardings)
        out[f"{case}_cache_placements"] = [
            str(v.placements) for v in cache["layers"][0].values()]
        serve = make_serve_step(cfg)
        steps, greedy = [], []
        for t in range(PROMPT + DECODE_STEPS):
            nxt, cache, logits = serve(model, cache, DTensor.from_local(
                toks[:, t:t + 1], mesh, rep, run_check=False))
            steps.append(logits.full_tensor()[:, 0].numpy())
            greedy.append(nxt.full_tensor()[:, 0].tolist())
        out[f"{case}_greedy"] = greedy
        split = distribute_tensor(logits.full_tensor()[:, 0], mesh,
                                  (Replicate(), Shard(1)))
        out[f"{case}_argmax_over_a_split_vocabulary"] = torch.equal(
            serve_argmax(split).full_tensor(),
            torch.argmax(split.full_tensor(), dim=-1))
    parallel = full.full_tensor().numpy()   # a collective: every rank
    if rank == 0:
        np.savez(os.path.join(out["dir"], f"{case}_decode.npz"),
                 parallel=parallel, steps=np.stack(steps))


def map_leaves(tree, shardings):
    """The cache ``tree`` with each tensor distributed by its sharding."""
    if isinstance(tree, dict):
        return {k: map_leaves(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_leaves(v, s) for v, s in zip(tree, shardings)]
    if isinstance(tree, torch.Tensor):
        return distribute_tensor(tree, shardings.mesh,
                                 shardings.placements)
    return tree


def scenario_raises(out):
    try:
        tmesh.make_host_mesh(model=1, data=3, device_type="cpu")
    except ValueError as e:
        out["mesh_3x1_error"] = str(e)


def main():
    mode, rank, world, rendezvous, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    # eight ranks beside the suite's other workers: run below them, on
    # the cores they leave idle, so the ranks do not slow the suite's
    # longest tests
    os.nice(10)
    if mode == "launcher":
        # as torchrun starts it: env:// on the port ``rendezvous``
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                          MASTER_PORT=rendezvous)
        res = tlaunch.main(["--device", "cpu", "--reduced", "--steps", "3",
                            "--global-batch", "4", "--seq-len", "16",
                            "--mesh", "2x2"])
        out = {"launcher": res["history"],
               "launcher_initialized_after": dist.is_initialized()}
        name = f"launcher{rank}.json"
    else:
        out = {"dir": out_dir}
        dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                                rank=rank, world_size=world)
        cfg, cc = tiny(), corpus()
        scenario_step(cfg, cc, out, rank)
        scenario_elastic(cfg, cc, out, rank)
        scenario_policy(cfg, cc, out, rank)
        scenario_compress(out)
        scenario_moe(cc, out, rank)
        scenario_attention(cc, out, rank)
        scenario_raises(out)
        dist.destroy_process_group()
        name = f"rank{rank}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
