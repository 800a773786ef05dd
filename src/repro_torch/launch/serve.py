"""Serving launcher: batched KV-cache decode of one architecture of the
zoo with random weights, the port of the JAX package's
``launch/serve.py`` (same flags and the same two output lines).

    python -m repro_torch.launch.serve --arch yi-9b --batch 8 --steps 32
    python -m repro_torch.launch.serve --arch qwen2-0.5b --no-reduced

It runs on the card unless given ``--device cpu``, and raises without
one.  ``--reduced`` (the default) serves the family's tiny float32
config; unlike the JAX launcher, whose ``store_true`` flag defaults to
on and so can never be turned off, ``--no-reduced`` serves the published
widths in the config's own dtype.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="'cpu' or a CUDA device (default: the card)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.kernels._common import resolve_device
    from repro_torch.models import init_cache, init_lm, reduced
    from repro_torch.serving import make_serve_step

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg, dtype="float32")
    model = init_lm(cfg, torch.Generator().manual_seed(0), device=dev)

    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    ).to(dev)
    cache = init_cache(cfg, args.batch, args.prompt_len + args.steps,
                       device=dev)
    sample = "greedy" if args.temperature == 0 else "categorical"
    step = make_serve_step(cfg, sample=sample,
                           temperature=max(args.temperature, 1e-3))
    gen_rng = torch.Generator(device=dev).manual_seed(0)

    tok = None
    for t in range(args.prompt_len):
        tok, cache, _ = step(model, cache, prompts[:, t:t + 1], gen_rng)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    gen = []
    for _ in range(args.steps):
        gen.append(int(tok[0, 0]))
        tok, cache, _ = step(model, cache, tok, gen_rng)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    tok_s = args.batch * args.steps / dt
    print(f"[serve] {args.arch}: {tok_s:.0f} tok/s (batch {args.batch})")
    print(f"[serve] request 0 ids: {gen[:16]}")
    return {"tok_s": tok_s, "ids": gen, "seconds": dt}


if __name__ == "__main__":
    main()
