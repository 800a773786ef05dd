#!/usr/bin/env python3
"""The readings that the correctness limits are set from, on the card.

    python3 tadoc_bench/tools/control.py --workload a-nsfraa.analytics \
        --seconds 10 --seeds 101 102 103

For each seed: one run of the cell with a short window at its own load,
then each number the check compares, read twice: from the program's
answers (the lower reading) and from the control, the reference computed
in bfloat16 (the precision below the deployment's float32) put in the
program's place (the upper reading).  One JSON line a seed.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    import torch
    from tadoc_bench import harness
    cell = harness.load_cell(ROOT, args.workload)
    for seed in args.seeds:
        rec, files = harness.run_cell(cell, seed, args.seconds, False,
                                      lambda: harness.card(cell.chips),
                                      time.monotonic(), log=lambda m: None)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        program, p_kind = harness.check(cell, files, rec)
        t1 = time.monotonic()
        control, c_kind = harness.check(cell, files, rec, control=True)
        print(json.dumps({
            "seed": seed, "answers": len(rec.answers),
            "reference_s": t1 - t0,
            "program": {k: v["value"] for k, v in program.items()},
            "control": {k: v["value"] for k, v in control.items()},
            "program_by_kind": p_kind, "control_by_kind": c_kind}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
