"""Roofline extraction: dry-run records -> three-term analysis per cell,
the port of the JAX package's ``launch/roofline.py`` on an NVIDIA H100
machine model.

NVIDIA H100 80GB HBM3 (SXM), at its 700 W power limit, from NVIDIA's data
sheet (dense rates, no sparsity):
    peak bf16 compute   989.4 TFLOP/s per card
    HBM bandwidth       3.35 TB/s per card
    link bandwidth      50 GB/s per card (collective term)

The link figure: a 16x16 mesh (256 cards) spans 32 nodes of 8 cards, so
most of a collective's bytes leave the node, through the card's 400 Gb/s
NDR InfiniBand adapter (50 GB/s).  NVLink's 450 GB/s a direction holds
only between the 8 cards inside a node.

Terms (seconds, per card, per step):
    compute    = flops / PEAK_FLOPS
    memory     = bytes / HBM_BW
    collective = collective_bytes / LINK_BW

The dry run (``launch/dryrun.py``) counts the eager program's FLOPs and
bytes per rank (``utils/hlo_analysis.py``), where the JAX package reads
XLA's cost analysis.  "useful" = MODEL_FLOPS / counted FLOPs (6*N_active*D
train, 2*N_active*D forward): how much of the counted compute is model
math, not remat, attention or dispatch.  "roofline_frac" = useful compute
time / the dominant term.  A record without ``temp_bytes`` (the port's:
an eager run has no compiler's buffer plan) counts its memory as the
arguments alone.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional

PEAK_FLOPS = 989.4e12
HBM_BW = 3.35e12
LINK_BW = 50e9

DRYRUN_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "dryrun_out")


def analyze(rec: Dict) -> Optional[Dict]:
    if rec.get("status") != "ok":
        return None
    dev = rec["devices"]
    flops = rec["cost"]["flops_per_device"]
    hbm_bytes = rec["cost"]["bytes_per_device"]
    coll_bytes = rec["collective_bytes_per_device"]
    approx = False
    if rec.get("counting") == "scan_body_once":
        # a JAX record counted each scan body once: correct per-layer
        # quantities by the trip count ("~" in tables)
        rep = max(int(rec.get("scan_repeats", 1)), 1)
        flops *= rep
        hbm_bytes *= rep
        coll_bytes *= rep
        approx = True
    t_c = flops / PEAK_FLOPS
    t_m = hbm_bytes / HBM_BW
    t_x = coll_bytes / LINK_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    dominant = max(terms, key=terms.get)
    model_per_dev = rec["model_flops_total"] / dev
    useful = model_per_dev / flops if flops > 0 else 0.0
    bound = max(terms.values())
    if rec["shape"].startswith(("decode", "long")):
        # decode is memory-bound by nature: compare the intrinsic bytes
        # (active params in bf16, read once a step) against the bound
        useful_bytes = rec["params_active"] * 2 / dev
        frac = (useful_bytes / HBM_BW) / bound if bound > 0 else 0.0
    else:
        frac = (model_per_dev / PEAK_FLOPS) / bound if bound > 0 else 0.0
    mem_gib = (rec["memory"]["argument_bytes"] +
               (rec["memory"]["temp_bytes"] or 0)) / 2**30
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "tag": rec.get("tag", ""), "approx": approx,
        "compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
        "dominant": dominant, "bound_s": bound,
        "useful_flop_ratio": useful, "roofline_frac": frac,
        "hbm_gib_per_dev": mem_gib,
        "flops_per_dev": flops, "coll_gib": coll_bytes / 2**30,
    }


def load_all(dryrun_dir: str = DRYRUN_DIR, tag: str = "") -> List[Dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("tag", "") != tag:
            continue
        a = analyze(rec)
        if a:
            rows.append(a)
        elif rec.get("status") == "skipped":
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "mesh": rec["mesh"], "skipped": rec["reason"]})
    return rows


def render(rows: List[Dict], fmt: str = "md") -> str:
    out = []
    if fmt == "md":
        out.append("| arch | shape | mesh | compute s | memory s | "
                   "collective s | dominant | useful | roofline | GiB/dev |")
        out.append("|---|---|---|---|---|---|---|---|---|---|")
        for r in rows:
            if "skipped" in r:
                out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                           f"— | — | — | SKIP ({r['skipped'][:40]}…) | | | |")
                continue
            ap = "~" if r.get("approx") else ""
            out.append(
                f"| {r['arch']}{ap} | {r['shape']} | {r['mesh']} | "
                f"{r['compute_s']:.4f} | {r['memory_s']:.4f} | "
                f"{r['collective_s']:.4f} | **{r['dominant']}** | "
                f"{r['useful_flop_ratio']:.2f} | {r['roofline_frac']:.3f} | "
                f"{r['hbm_gib_per_dev']:.1f} |")
    else:
        out.append("arch,shape,mesh,compute_s,memory_s,collective_s,"
                   "dominant,useful,roofline_frac,gib_per_dev")
        for r in rows:
            if "skipped" in r:
                continue
            out.append(f"{r['arch']},{r['shape']},{r['mesh']},"
                       f"{r['compute_s']:.5f},{r['memory_s']:.5f},"
                       f"{r['collective_s']:.5f},{r['dominant']},"
                       f"{r['useful_flop_ratio']:.3f},"
                       f"{r['roofline_frac']:.3f},"
                       f"{r['hbm_gib_per_dev']:.2f}")
    return "\n".join(out)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=DRYRUN_DIR)
    ap.add_argument("--fmt", default="md", choices=["md", "csv"])
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    print(render(load_all(args.dir, tag=args.tag), args.fmt))


if __name__ == "__main__":
    main()
