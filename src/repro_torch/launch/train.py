"""Training launcher, the port of the JAX package's ``launch/train.py``
(the same flags and the same two output lines, plus ``--device``).

    python -m repro_torch.launch.train --device cpu --reduced --steps 3
    python -m repro_torch.launch.train --arch qwen2-0.5b --steps 100 \\
        --global-batch 2 --seq-len 4096 --microbatches 2
    torchrun --nproc-per-node 8 -m repro_torch.launch.train --mesh 4x2 ...

It runs on the card unless given ``--device cpu``, and raises without
one.  ``--reduced`` (off by default, as in the JAX launcher) trains the
family's tiny float32 config; without it the published config trains in
its own dtype.  Batches come from a compressed corpus (``--corpus``, an
``.npz`` of ``CompressedCorpus.save``; default the synthetic Table II
corpus E) through the deterministic ``BatchPipeline``.

Without ``--mesh`` it trains plain tensors on one device, with no process
group.  ``--mesh DxM`` trains on a ``(data, model)`` DeviceMesh of D*M
ranks, one process a card: it joins the process group from ``torchrun``'s
environment when that is set, else from ``--coordinator HOST:PORT`` with
``--num-hosts`` ranks (this one ``--host-id``), else as a world of one
(``1x1``).  NCCL on the card, gloo only under ``--device cpu``.  The
parameters, AdamW moments and batches are placed as DTensors by the
sharding rules (``distributed/sharding.py``), and a rank reads the batch
rows of its ``data`` coordinate (ranks that differ only in ``model`` read
the same rows).  Every family trains on a mesh (the MoE dispatch runs
one shard a rank, ``models/moe.py``); should an op DTensor cannot shard
raise ``NotImplementedError``, the launcher re-raises it naming the
family.  ``--num-layers`` cuts the depth of the published config (a
smoke run at full width).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import socket
from typing import Dict, List, Optional

import torch


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def _process_group(args, dev: torch.device, world: int):
    """Join (and on exit leave) the process group of a ``world``-rank mesh:
    torchrun's environment, else ``--coordinator``, else a world of one.
    Yields this process's device (``cuda:LOCAL_RANK`` under torchrun)."""
    import torch.distributed as dist
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
        kw = dict(init_method="env://")
    elif args.coordinator:
        kw = dict(init_method=f"tcp://{args.coordinator}",
                  world_size=args.num_hosts, rank=args.host_id)
    else:
        kw = dict(init_method=f"tcp://localhost:{_free_port()}",
                  world_size=1, rank=0)
    if dev.type == "cuda":
        kw["device_id"] = dev
    dist.init_process_group(backend, **kw)
    try:
        if dist.get_world_size() != world:
            raise ValueError(f"--mesh {args.mesh} needs {world} ranks; the "
                             f"world has {dist.get_world_size()}")
        yield dev
    finally:
        dist.destroy_process_group()


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU containers)")
    ap.add_argument("--num-layers", type=int, default=None,
                    help="cut the config's depth to this many layers "
                         "(widths unchanged)")
    ap.add_argument("--corpus", default=None,
                    help=".npz compressed corpus (default: synthetic E)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--mesh", default=None,
                    help="DxM data x model ranks (default: one device, no "
                         "mesh)")
    # multi-host wiring: one process a card
    ap.add_argument("--coordinator", default=None,
                    help="HOST:PORT of rank 0 (without torchrun)")
    ap.add_argument("--num-hosts", type=int, default=1,
                    help="ranks in all, with --coordinator")
    ap.add_argument("--host-id", type=int, default=0,
                    help="this process's rank, with --coordinator")
    ap.add_argument("--device", default=None,
                    help="'cpu' or a CUDA device (default: the card)")
    args = ap.parse_args(argv)

    from repro_torch.kernels._common import resolve_device
    dev = resolve_device(args.device)
    if args.mesh is None:
        if args.coordinator or args.num_hosts != 1:
            raise ValueError("--coordinator / --num-hosts need --mesh")
        return _train(args, dev, None)
    d, m = (int(x) for x in args.mesh.split("x"))
    with _process_group(args, dev, d * m) as dev:
        from repro_torch.launch.mesh import make_host_mesh
        return _train(args, dev, make_host_mesh(model=m, data=d,
                                                device_type=dev.type))


def _train(args, dev: torch.device, mesh) -> Dict:
    from repro_torch.configs import get_config
    from repro_torch.data import BatchPipeline, CompressedCorpus, synthetic
    from repro_torch.models import init_lm, reduced
    from repro_torch.training import (AdamW, StragglerWatchdog,
                                      make_train_step, train)

    rank = 0
    if mesh is not None:
        import torch.distributed as dist
        rank = dist.get_rank()
    say = print if rank == 0 else (lambda *a, **k: None)
    if args.corpus:
        cc = CompressedCorpus.load(args.corpus)
    else:
        spec = synthetic.TABLE2["E"]
        cc = CompressedCorpus.build(synthetic.make_table2_corpus("E"),
                                    vocab_size=spec.vocab)
    say(f"[train] corpus: {cc.stats()}")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg, vocab_size=max(cc.ga.vocab_size + 1, 257),
                      dtype="float32")
    if args.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    model = init_lm(cfg, torch.Generator().manual_seed(0), device=dev)

    opt = AdamW(lr=args.lr, warmup_steps=min(100, args.steps // 10 + 1),
                schedule="cosine", total_steps=args.steps)
    step_fn = make_train_step(cfg, opt, microbatches=args.microbatches)

    shard_id, num_shards, place_batch = 0, 1, None
    if mesh is not None:
        from repro_torch.distributed import (batch_shardings, default_rules,
                                             distribute_lm)
        from torch.distributed.tensor import DTensor
        rules = default_rules(mesh)
        distribute_lm(model, mesh, rules)
        probe = torch.empty((args.global_batch, args.seq_len),
                            device="meta")
        placements = batch_shardings(probe, mesh, rules).placements
        if any(p.is_shard() for p in placements):
            # this rank's rows: its coordinate on ``data``
            shard_id = mesh.get_coordinate()[0]
            num_shards = mesh.shape[0]

        def place_batch(batch):
            return {k: DTensor.from_local(v, mesh, placements,
                                          run_check=False)
                    for k, v in batch.items()}

    pipeline = BatchPipeline(cc, global_batch=args.global_batch,
                             seq_len=args.seq_len, seed=0, shard=shard_id,
                             num_shards=num_shards, prefetch=2)
    wd = StragglerWatchdog(on_straggler=lambda s, dt, ema: print(
        f"[watchdog] host {rank}: step {s} {dt:.2f}s vs ema {ema:.2f}s"))
    try:
        out = train(cfg, model, opt, pipeline, steps=args.steps,
                    ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                    train_step=step_fn, watchdog=wd, log=say,
                    place_batch=place_batch)
    except NotImplementedError as e:
        if mesh is None:
            raise
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family} family) cannot train on a DTensor "
            f"mesh: {e}") from e
    finally:
        pipeline.close()
    say(f"[train] done: loss {out['history'][0]:.3f} -> "
        f"{out['history'][-1]:.3f}, stragglers {out['straggler_events']}")
    return out


if __name__ == "__main__":
    main()
