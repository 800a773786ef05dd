"""FLOPs of one dry-run cell by the line of the port that ran each
counted op, to tell where two torch versions count the same step apart.

    PYTHONPATH=src python tools/flops_by_line.py ARCH SHAPE [--mesh M]
        [--top N]

Runs ``launch/dryrun.run_cell`` of the cell at full width on its fake
process group (256 ranks for ``single``, 512 for ``multi``), with each
FLOP formula of ``utils/hlo_analysis.py`` wrapped to add its count under
"<op> <file>:<line>", the innermost frame of ``src/repro_torch`` that ran
it (a backward pass shows as the line that called ``backward``).  Prints
the record's status and FLOPs, then two JSON objects of the ``--top``
lines in GFLOP a rank: by line, and by line and the op's local operand
shapes.
"""

import argparse
import collections
import json
import os
import sys
import tempfile
import traceback

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.utils import hlo_analysis as ha  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    tally, by_shape = collections.Counter(), collections.Counter()

    def wrap(packet, formula):
        def counted(*a, **k):
            flops = formula(*a, **k)
            ours = [f for f in traceback.extract_stack()
                    if "repro_torch" in f.filename
                    and "hlo_analysis" not in f.filename]
            where = (f"{os.path.basename(ours[-1].filename)}:"
                     f"{ours[-1].lineno}" if ours else "?")
            tally[f"{packet} {where}"] += flops
            shapes = " @ ".join(str(tuple(t.shape)) for t in a
                                if isinstance(t, torch.Tensor))
            by_shape[f"{packet} {where} {shapes}"] += flops
            return flops
        return counted

    for packet, formula in list(ha.flop_registry.items()):
        ha.flop_registry[packet] = wrap(packet, formula)
    ranks = 512 if args.mesh == "multi" else 256
    with tempfile.TemporaryDirectory() as tmp, dryrun.fake_world(ranks):
        rec = dryrun.run_cell(args.arch, args.shape, args.mesh, out_dir=tmp,
                              force=True)
    print(f"{args.arch}/{args.shape}/{args.mesh}: {rec['status']} (torch "
          f"{torch.__version__}), "
          f"{rec.get('cost', {}).get('flops_per_device', 0) / 1e9:.1f} "
          f"GFLOP/dev")
    for t in (tally, by_shape):
        print(json.dumps({k: round(v / 1e9, 1)
                          for k, v in t.most_common(args.top)}))


if __name__ == "__main__":
    main()
