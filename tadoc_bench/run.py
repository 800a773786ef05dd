#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the card this machine holds.

    python3 tadoc_bench/run.py --workload a-nsfraa.analytics --seed 7 \
        --seconds 30 --trace 0

from the root of a checkout.  With ``--trace 0`` the last line of standard
output is one JSON object with the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, the device's busy and window seconds
and a breakdown of the device trace.  The numbers the correctness check
compared, each beside its limit, are the last lines of standard error and
the ``checks`` key of that object.  Without a CUDA card (or with fewer than
the cell asks for) the run exits with code 2 and prints no result.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def log(msg: str) -> None:
    print(msg, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from tadoc_bench import harness
    cell = harness.load_cell(ROOT, args.workload)
    # the program's tuned-shape table: a fixed path in the checkout that
    # this benchmark never writes, so every run launches the shipped shapes
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(
        ROOT / harness.BENCH.name / "_cache" / "AUTOTUNE_cache.json")
    try:
        rec, files = harness.run_cell(
            cell, args.seed % 2 ** 64, args.seconds, bool(args.trace),
            lambda: harness.card(cell.chips), T0, log=log)
    except harness.NoCard as e:
        print(f"{args.workload} {e}", file=sys.stderr)
        return 2
    import torch
    for line in harness.summary_lines(rec):
        log(line)
    peak = max(torch.cuda.max_memory_allocated(d)
               for d in range(cell.chips))
    gc.collect()
    torch.cuda.empty_cache()
    t_check = time.monotonic()
    checks, by_kind = harness.check(cell, files, rec)
    log(f"[check] {len(rec.answers)} requests' answers held to the "
        f"reference in {time.monotonic() - t_check:.3f} s; wrong entries "
        f"by kind {by_kind}")
    line = harness.result_line(cell, rec, checks, bool(args.trace), "gpu",
                               peak)
    # last, once every module of the run (kinds, readers) is in
    loaded = sorted({m.split(".")[0] for m in sys.modules}
                    & set(harness.FORBIDDEN))
    if loaded:
        print(f"the run loaded {loaded}, which the port may not use",
              file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
