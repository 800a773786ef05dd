"""Training launcher, the port of the JAX package's ``launch/train.py``
(the same flags and the same two output lines, plus ``--device``).

    python -m repro_torch.launch.train --device cpu --reduced --steps 3
    python -m repro_torch.launch.train --arch qwen2-0.5b --steps 100 \\
        --global-batch 2 --seq-len 4096 --microbatches 2

It runs on the card unless given ``--device cpu``, and raises without
one.  ``--reduced`` (off by default, as in the JAX launcher) trains the
family's tiny float32 config; without it the published config trains in
its own dtype.  Batches come from a compressed corpus (``--corpus``, an
``.npz`` of ``CompressedCorpus.save``; default the synthetic Table II
corpus E) through the deterministic ``BatchPipeline``.  Multi-card
training (``--mesh`` other than ``1x1``, ``--coordinator``) needs the
sharding layer (``distributed/sharding.py``), which the port does not
have yet: it raises.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import torch

_NOT_PORTED = ("multi-card training needs the sharding layer "
               "(distributed/sharding.py), which the port does not have "
               "yet")


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU containers)")
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
                    help="DxM data x model (only 1x1: one device)")
    # multi-host wiring
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' or a CUDA device (default: the card)")
    args = ap.parse_args(argv)

    if args.coordinator or args.num_hosts != 1 or (
            args.mesh and tuple(int(x) for x in args.mesh.split("x"))
            != (1, 1)):
        raise NotImplementedError(_NOT_PORTED)

    from repro_torch.configs import get_config
    from repro_torch.data import BatchPipeline, CompressedCorpus, synthetic
    from repro_torch.kernels._common import resolve_device
    from repro_torch.models import init_lm, reduced
    from repro_torch.training import (AdamW, StragglerWatchdog,
                                      make_train_step, train)

    dev = resolve_device(args.device)
    if args.corpus:
        cc = CompressedCorpus.load(args.corpus)
    else:
        spec = synthetic.TABLE2["E"]
        cc = CompressedCorpus.build(synthetic.make_table2_corpus("E"),
                                    vocab_size=spec.vocab)
    print(f"[train] corpus: {cc.stats()}")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg, vocab_size=max(cc.ga.vocab_size + 1, 257),
                      dtype="float32")
    model = init_lm(cfg, torch.Generator().manual_seed(0), device=dev)

    opt = AdamW(lr=args.lr, warmup_steps=min(100, args.steps // 10 + 1),
                schedule="cosine", total_steps=args.steps)
    step_fn = make_train_step(cfg, opt, microbatches=args.microbatches)

    shard_id = 0
    pipeline = BatchPipeline(cc, global_batch=args.global_batch,
                             seq_len=args.seq_len, seed=0, shard=shard_id,
                             num_shards=1, prefetch=2)
    wd = StragglerWatchdog(on_straggler=lambda s, dt, ema: print(
        f"[watchdog] host {shard_id}: step {s} {dt:.2f}s vs ema {ema:.2f}s"))
    try:
        out = train(cfg, model, opt, pipeline, steps=args.steps,
                    ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                    train_step=step_fn, watchdog=wd)
    finally:
        pipeline.close()
    print(f"[train] done: loss {out['history'][0]:.3f} -> "
          f"{out['history'][-1]:.3f}, stragglers {out['straggler_events']}")
    return out


if __name__ == "__main__":
    main()
