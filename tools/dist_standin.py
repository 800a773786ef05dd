#!/usr/bin/env python3
"""Two gloo ranks on one card: a stand-in mesh of CUDA tensors.

    python3 tools/dist_standin.py [--out FILE]

NCCL refuses two ranks on one device, so a machine with one card cannot
run a mesh of more than one rank on NCCL.  This tries the next thing: two
processes on ``cuda:0`` joined by gloo, the tiny float32 config of
``tests/_multidevice_worker.py`` (``yi-9b`` cut to 2 layers, d_model 32,
vocab 400) placed by the sharding rules on a 2x1 ``(data, model)`` mesh
and trained for one AdamW step, against the same step of the plain path
on the card.  First each of :data:`PROBES` runs in a pair of processes
of its own: one collective of torch on a ``cuda:0`` tensor over gloo,
with no code of the port.  It prints one JSON line: the torch version,
whether each probe and every rank of the step ran clean, the losses,
the largest parameter difference, the seconds, and on failure each
rank's error and the last stage it reached.  A process that crashes
leaves no traceback, so each rank prints its Python frames to stderr on
a fatal signal (``faulthandler``); a probe that dies as the step does
puts the fault in torch.
"""

import argparse
import faulthandler
import json
import os
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

GLOBAL_BATCH, SEQ, LR = 8, 16, 1e-2


def _tiny():
    from repro_torch import models as tm
    from repro_torch.configs import get_config
    return tm.reduced(get_config("yi_9b"), dtype="float32", num_layers=2,
                      d_model=32, num_heads=4, num_kv_heads=2, head_dim=8,
                      d_ff=64, vocab_size=400)


def _batch(shard, num_shards):
    from repro_torch.data import BatchPipeline, CompressedCorpus, synthetic
    cc = CompressedCorpus.build(synthetic.make_table2_corpus("D"),
                                vocab_size=400)
    return BatchPipeline(cc, global_batch=GLOBAL_BATCH, seq_len=SEQ,
                         seed=0, shard=shard, num_shards=num_shards,
                         prefetch=0).batch_at(0)


def _trace() -> str:
    """The current exception's traceback, its head and tail."""
    tb = traceback.format_exc()
    return tb if len(tb) <= 3000 else tb[:1500] + "\n...\n" + tb[-1500:]


def rank_main(rank, world, init, out_dir):
    faulthandler.enable()
    import torch
    import torch.distributed as dist
    res = {"rank": rank}
    stage_file = os.path.join(out_dir, f"stage{rank}")

    def stage(name):
        # the last stage a rank reached survives a crash of the process
        with open(stage_file, "w") as f:
            f.write(name)
    try:
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from repro_torch import models as tm
        from repro_torch import training as tt
        from repro_torch.checkpoint import flatten_with_paths
        from repro_torch.distributed import default_rules, distribute_lm
        from repro_torch.launch.mesh import make_host_mesh
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        stage("init_process_group")
        dist.init_process_group("gloo", init_method=f"file://{init}",
                                rank=rank, world_size=world)
        stage("make_host_mesh")
        mesh = make_host_mesh(model=1, data=world, device_type="cuda")
        cfg = _tiny()
        stage("distribute_lm")
        model = distribute_lm(tm.init_lm(
            cfg, torch.Generator().manual_seed(0), device=dev), mesh,
            default_rules(mesh))
        x, y = _batch(rank, world)
        batch = {k: DTensor.from_local(torch.from_numpy(v).to(dev), mesh,
                                       (Shard(0), Replicate()),
                                       run_check=False)
                 for k, v in (("tokens", x), ("labels", y))}
        opt = tt.AdamW(lr=LR)
        t0 = time.perf_counter()
        stage("train_step")
        model, _, met = tt.make_train_step(cfg, opt)(
            model, opt.init(tm.lm_to_params(model)), batch)
        res["loss"] = float(met["loss"])
        res["seconds"] = time.perf_counter() - t0
        stage("full_tensor")
        params = {k: v.full_tensor().cpu() for k, v in
                  flatten_with_paths(tm.lm_to_params(model))}
        if rank == 0:
            torch.save(params, os.path.join(out_dir, "params.pt"))
        dist.destroy_process_group()
        res["ok"] = True
    except Exception:
        res["ok"] = False
        res["error"] = _trace()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _probe_all_gather(dist, t):
    out = t.new_empty((2 * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t)
    return out


def _probe_funcol_all_gather(dist, t):
    # the collective DTensor's redistribute issues (all_gather_tensor,
    # then wait_tensor)
    from torch.distributed import _functional_collectives as funcol
    return funcol.all_gather_tensor(t, 0, dist.group.WORLD).wait()


def _probe_funcol_all_reduce(dist, t):
    from torch.distributed import _functional_collectives as funcol
    return funcol.all_reduce(t, "sum", dist.group.WORLD).wait()


def _probe_dtensor_gather(dist, t):
    # DTensor's Shard(0) -> Replicate() of a tensor split over the ranks
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = init_device_mesh("cuda", (dist.get_world_size(),))
    return DTensor.from_local(t, mesh, (Shard(0),)).redistribute(
        mesh, (Replicate(),)).to_local()


# name -> fn(torch.distributed, a [4, 8] float32 tensor on cuda:0)
PROBES = {"c10d_all_gather": _probe_all_gather,
          "funcol_all_gather": _probe_funcol_all_gather,
          "funcol_all_reduce": _probe_funcol_all_reduce,
          "dtensor_gather": _probe_dtensor_gather}


def probe_main(rank, world, init, out_dir, name):
    faulthandler.enable()
    import torch
    import torch.distributed as dist
    res = {"rank": rank}
    try:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=f"file://{init}",
                                rank=rank, world_size=world)
        t = torch.full((4, 8), float(rank + 1), device=dev)
        out = PROBES[name](dist, t)
        torch.cuda.synchronize()
        res["sum"] = float(out.sum())
        dist.destroy_process_group()
        res["ok"] = True
    except Exception:
        res["ok"] = False
        res["error"] = _trace()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _spawn(fn, world, extra=()):
    """``fn(rank, world, init, tmp, *extra)`` in ``world`` processes: each
    rank's result (its JSON file, else the crash) and the wall seconds."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        try:
            mp.spawn(fn, args=(world, os.path.join(tmp, "init"), tmp) +
                     tuple(extra), nprocs=world, join=True)
            crash = None
        except mp.ProcessExitedException as e:
            crash = str(e)
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.json")
            res = (json.load(open(path)) if os.path.exists(path) else
                   {"rank": r, "ok": False, "error": crash})
            stage = os.path.join(tmp, f"stage{r}")
            if os.path.exists(stage):
                res["last_stage"] = open(stage).read()
            ranks.append(res)
        params = os.path.join(tmp, "params.pt")
        got = None
        if os.path.exists(params):
            import torch
            got = torch.load(params)
    return ranks, wall, got


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("dist_standin: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import models as tm
    from repro_torch import training as tt
    from repro_torch.checkpoint import flatten_with_paths
    out = {"world": args.world, "backend": "gloo", "device": "cuda:0",
           "torch": torch.__version__, "probes": {}}
    for name in PROBES:
        ranks, wall, _ = _spawn(probe_main, args.world, (name,))
        out["probes"][name] = {"ok": all(r["ok"] for r in ranks),
                               "seconds": wall, "ranks": ranks}
    ranks, wall, got = _spawn(rank_main, args.world)
    out.update(ok=all(r["ok"] for r in ranks), seconds=wall, ranks=ranks)
    if out["ok"]:
        cfg = _tiny()
        dev = torch.device("cuda", 0)
        model = tm.init_lm(cfg, torch.Generator().manual_seed(0),
                           device=dev)
        x, y = _batch(0, 1)
        opt = tt.AdamW(lr=LR)
        model, _, met = tt.make_train_step(cfg, opt)(
            model, opt.init(tm.lm_to_params(model)),
            {"tokens": torch.from_numpy(x).to(dev),
             "labels": torch.from_numpy(y).to(dev)})
        want = dict(flatten_with_paths(tm.lm_to_params(model)))
        out["plain_loss"] = float(met["loss"])
        out["max_param_diff"] = max(
            float((got[k] - want[k].cpu()).abs().max()) for k in want)
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
