"""Run the port's dry-run grid one arch x shape x mesh a process, several
processes at once.

    PYTHONPATH=src python tools/dryrun_grid.py [--jobs N] [--out DIR]
        [--arch A ...] [--shape S ...] [--mesh single|multi|both]

Each cell is ``python -m repro_torch.launch.dryrun --arch A --shape S
--mesh M --out DIR --force`` in a process of its own (a cell holds its
fake process group, DTensor's caches and the meta model for its whole
run; a jamba or mamba2 cell takes minutes), ``--jobs`` of them at a time
(default: the host's cores), each writing its record into ``DIR``.  When
all have ended, prints the roofline table of ``DIR``
(``launch/roofline.py``), each failed cell's error, and one JSON line:
the torch version, the counts by status, and the wall seconds of the
grid, of each arch's processes summed and of each cell.  Exits 1 when a
cell recorded an error or its process failed.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
sys.path.insert(0, SRC)

from repro_torch.configs import ALIASES  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.models.config import LM_SHAPES  # noqa: E402

CELL_TIMEOUT_S = 3000   # a cell's process; the longest took ~20 min


def run_cell(arch: str, shape: str, mesh: str, out: str) -> dict:
    """One cell in its own process: its status (``"no record"`` when the
    process wrote none), wall seconds and, failing, the error."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape, "--mesh", mesh, "--out", out, "--force"]
    path = os.path.join(out, f"{ALIASES.get(arch, arch)}__{shape}__{mesh}"
                        ".json")
    if os.path.exists(path):
        os.remove(path)
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=CELL_TIMEOUT_S)
        tail = (proc.stdout + proc.stderr)[-1500:]
    except subprocess.TimeoutExpired:
        tail = f"timed out after {CELL_TIMEOUT_S} s"
    cell = {"cell": f"{arch}/{shape}/{mesh}", "arch": arch,
            "wall_s": time.time() - t0}
    if not os.path.exists(path):
        return dict(cell, status="no record", error=tail)
    with open(path) as f:
        rec = json.load(f)
    return dict(cell, status=rec["status"], error=rec.get("error", ""))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--out", default=roofline.DRYRUN_DIR)
    ap.add_argument("--arch", nargs="*", default=list(ALIASES))
    ap.add_argument("--shape", nargs="*", default=list(LM_SHAPES))
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    args = ap.parse_args(argv)
    import torch
    os.makedirs(args.out, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = [(a, s, m) for m in meshes for a in args.arch
             for s in args.shape]
    t0 = time.time()
    with cf.ThreadPoolExecutor(args.jobs) as pool:
        done = list(pool.map(lambda c: run_cell(*c, args.out), cells))
    wall = time.time() - t0
    print(roofline.render(roofline.load_all(args.out)))
    counts, per_arch = {}, {}
    for c in done:
        counts[c["status"]] = counts.get(c["status"], 0) + 1
        per_arch[c["arch"]] = per_arch.get(c["arch"], 0.0) + c["wall_s"]
        if c["status"] not in ("ok", "skipped"):
            print(f"{c['cell']}: {c['status']}: {c['error'][-500:]}")
    print(json.dumps({
        "torch": torch.__version__, "cells": len(done), "counts": counts,
        "jobs": args.jobs, "cores": os.cpu_count(), "wall_s": round(wall, 1),
        "arch_wall_s": {k: round(v, 1) for k, v in per_arch.items()},
        "cell_wall_s": {c["cell"]: round(c["wall_s"], 1) for c in done}}))
    return 0 if set(counts) <= {"ok", "skipped"} else 1


if __name__ == "__main__":
    raise SystemExit(main())
