#!/usr/bin/env python3
"""Two gloo ranks on one card: a stand-in mesh of CUDA tensors.

    python3 tools/dist_standin.py [--out FILE]

NCCL refuses two ranks on one device, so a machine with one card cannot
run a mesh of more than one rank on NCCL.  This tries the next thing: two
processes on ``cuda:0`` joined by gloo, the tiny float32 config of
``tests/_multidevice_worker.py`` (``yi-9b`` cut to 2 layers, d_model 32,
vocab 400) placed by the sharding rules on a 2x1 ``(data, model)`` mesh
and trained for one AdamW step, against the same step of the plain path
on the card.  It prints one JSON line: whether every rank ran clean, the
losses, the largest parameter difference, the seconds, and on failure
each rank's error and the last stage it reached (a process that crashes
leaves no traceback).
"""

import argparse
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


def rank_main(rank, world, init, out_dir):
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
        res["error"] = traceback.format_exc()[-3000:]
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        print("dist_standin: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import models as tm
    from repro_torch import training as tt
    from repro_torch.checkpoint import flatten_with_paths
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        try:
            mp.spawn(rank_main, args=(args.world, os.path.join(tmp, "init"),
                                      tmp), nprocs=args.world, join=True)
            crash = None
        except mp.ProcessExitedException as e:
            crash = str(e)
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(args.world):
            path = os.path.join(tmp, f"rank{r}.json")
            res = (json.load(open(path)) if os.path.exists(path) else
                   {"rank": r, "ok": False, "error": crash})
            stage = os.path.join(tmp, f"stage{r}")
            if os.path.exists(stage):
                res["last_stage"] = open(stage).read()
            ranks.append(res)
        out = {"world": args.world, "backend": "gloo", "device": "cuda:0",
               "ok": all(r["ok"] for r in ranks), "seconds": wall,
               "ranks": ranks}
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
            got = torch.load(os.path.join(tmp, "params.pt"))
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
