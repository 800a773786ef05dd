#!/usr/bin/env python3
"""Time kernels 3 and 4 of several source trees in turns on one card.

    python3 tools/kernel_ab.py --tree parent=_checkout/parent \\
        --tree change=. [--trial LABEL=FILE.cu ...] [--rounds 10]

run from the root of a checkout, on a machine with one Hopper card.  A
``--tree`` is a checkout root holding ``src/repro_torch`` (an older commit
unpacked with ``git archive``, or this one).  A ``--trial`` is this
checkout's package and card tests with one kernel source replaced by the
named file (the file of the same name under ``csrc/``), assembled under
``_checkout/trials/<label>``; its card tests for that kernel run first
(``-k`` the source's name without ``.cu``), and a trial whose tests fail
is not timed.

The inputs are those ``chip_smoke.py`` times, built once on the host from
its data and saved under ``_checkout/``: the per-file subset's vector round
(kernel 3, ``ops.ell_propagate_vector``) and the pack's word histogram
(kernel 4), flat (``ops.weighted_bincount``) and as the engine calls it
(``ops.weighted_bincount_batched``).  Each round then runs every tree once,
each in a process of its own, in an order reversed every other round.  The
process checks each call bit for bit against its plain version and reads
``ms``, ``device_ms`` and ``host_us`` with ``chip_smoke.py``'s own timers.
Prints the card's name and power limit, one line a run, each tree's
medians and, for every two trees, the rounds in which the later-named one
read less; writes all of it as JSON to ``--out`` (default
``_checkout/kernel_ab.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRATCH = os.path.join(REPO, "_checkout")
INPUTS = os.path.join(SCRATCH, "kernel_ab_inputs.pt")
CALLS = ("k3", "k4", "k4_batched")
METRICS = ("ms", "device_ms", "host_us")


def build_inputs(path: str) -> None:
    """chip_smoke.py's kernel 3 and 4 inputs, made on the host."""
    sys.path[:0] = [os.path.join(REPO, "src"), REPO]
    import torch

    import chip_smoke as cs
    from repro_torch.core import GrammarBatch
    from repro_torch.core import batch as tb
    cpu = torch.device("cpu")
    corpora = cs.make_corpora(cs.N_CORPORA, cs.N_FILES, cs.TOKENS_PER_FILE,
                              cs.VOCAB)
    corpora = corpora[:cs.fit_scalar_pack(corpora)]
    gb = GrammarBatch.build([ga for _, ga in corpora], device=cpu)
    sub = GrammarBatch.build(
        [ga for _, ga in cs.fit_vector_subset(corpora, cs.VOCAB)],
        device=cpu)
    # kernel 3: level-1 non-root parents active, real per-file weights
    vsrc, vfreq, vlevel, _ = sub.ell_plan()
    W = tb.batched_per_file_weights(sub, "frontier")
    nonroot = (torch.arange(vsrc.shape[1]) > 0)[None, :]
    vactive = ((vlevel == 1) & nonroot).to(torch.float32)
    # kernel 4: the word table weighted by the rules' weights
    w = tb.batched_top_down_weights(gb, "frontier")
    vals = gb.tw_cnt * torch.gather(w, 1, gb.tw_rule)
    n = gb.tw_word.shape[0]
    valid = (gb.tw_word >= 0) & (gb.tw_word < gb.V_pad)
    offs = (torch.arange(n) * gb.V_pad)[:, None]
    ids = torch.where(valid, gb.tw_word + offs, -1).reshape(-1).to(
        torch.int32)
    torch.save({"k3": (W, vactive, vsrc, vfreq),
                "k4": (ids, vals.reshape(-1).contiguous(), n * gb.V_pad),
                "k4_batched": (gb.tw_word, vals, gb.V_pad)}, path)


def child(tree: str, path: str) -> dict:
    """One tree's readings on the card (run in a process of its own)."""
    sys.path[:0] = [os.path.join(os.path.abspath(tree), "src"), REPO]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _common, ops, ref
    dev = torch.device("cuda", 0)
    _common.build_library()
    inp = {k: tuple(t.to(dev) if isinstance(t, torch.Tensor) else t
                    for t in v)
           for k, v in torch.load(path).items()}
    calls = {"k3": (ops.ell_propagate_vector, ref.ell_propagate_vector_ref),
             "k4": (ops.weighted_bincount, ref.weighted_bincount_ref),
             "k4_batched": (ops.weighted_bincount_batched, None)}
    out = {}
    for name, (fn, plain) in calls.items():
        args = inp[name]
        got = fn(*args)
        if plain is None:       # the batched call: the plain version a row
            ids, vals, nbins = args
            want = torch.stack([ref.weighted_bincount_ref(ids[i], vals[i],
                                                          nbins)
                                for i in range(ids.shape[0])])
        else:
            want = plain(*args)
        got, want = ((x,) if isinstance(x, torch.Tensor) else x
                     for x in (got, want))
        cs.check(all(torch.equal(g, p) for g, p in zip(got, want)),
                 f"{name}: kernel differs from its plain version")
        ms = cs.time_ms(lambda: fn(*args), dev)
        dev_ms, host_us, ops_ = cs.device_split(lambda: fn(*args), dev)
        out[name] = {"ms": ms, "device_ms": dev_ms, "host_us": host_us,
                     "device_ops": [o["name"] for o in ops_]}
    return out


def make_trial(label: str, cu: str) -> str:
    """This checkout's package and card tests with ``cu`` in place of the
    kernel source of the same name."""
    root = os.path.join(SCRATCH, "trials", label)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "src", "repro_torch"),
                    os.path.join(root, "src", "repro_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    os.makedirs(os.path.join(root, "tests"))
    for f in ("conftest.py", "_torch_inputs.py", "test_torch_gpu.py"):
        shutil.copy(os.path.join(REPO, "tests", f),
                    os.path.join(root, "tests", f))
    target = os.path.join(root, "src", "repro_torch", "kernels", "csrc",
                          os.path.basename(cu))
    if not os.path.isfile(target):
        raise SystemExit(f"kernel_ab: no csrc/{os.path.basename(cu)} to "
                         f"replace")
    shutil.copy(os.path.join(REPO, cu), target)
    return root


def run_tree(tree: str) -> dict:
    p = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                        tree], capture_output=True, text=True, timeout=600)
    lines = p.stdout.strip().splitlines()
    if p.returncode != 0 or not lines:
        return {"error": (p.stderr or p.stdout)[-2000:]}
    return json.loads(lines[-1])


def summarize(labels, runs) -> dict:
    """Per tree and call, the median and range of each metric; for every
    two trees, the rounds in which the later one read less."""
    med, wins = {}, {}
    for lab in labels:
        ok = [r for r in runs[lab] if "error" not in r]
        med[lab] = {c: {m: {"median": statistics.median(r[c][m] for r in ok),
                            "min": min(r[c][m] for r in ok),
                            "max": max(r[c][m] for r in ok)}
                        for m in METRICS}
                    for c in CALLS} if ok else None
    for i, a in enumerate(labels):
        for b in labels[i + 1:]:
            pairs = [(x, y) for x, y in zip(runs[a], runs[b])
                     if "error" not in x and "error" not in y]
            wins[f"{b} below {a}"] = {
                c: {m: f"{sum(y[c][m] < x[c][m] for x, y in pairs)}"
                       f"/{len(pairs)}" for m in METRICS} for c in CALLS}
    return {"medians": med, "rounds_below": wins}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    metavar="LABEL=PATH")
    ap.add_argument("--trial", action="append", default=[],
                    metavar="LABEL=FILE.cu")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--out", default=os.path.join(SCRATCH, "kernel_ab.json"))
    ap.add_argument("--child", metavar="PATH", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        print(json.dumps(child(a.child, INPUTS)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available", file=sys.stderr)
        return 1
    trees = dict(t.split("=", 1) for t in a.tree)
    tests = {}
    for spec in a.trial:
        label, cu = spec.split("=", 1)
        root = make_trial(label, cu)
        key = os.path.splitext(os.path.basename(cu))[0]
        p = subprocess.run([sys.executable, "-m", "pytest", "-q", "-x",
                            "tests/test_torch_gpu.py", "-k", key],
                           cwd=root, capture_output=True, text=True,
                           timeout=900)
        tests[label] = p.stdout.strip().splitlines()[-1:]
        print(f"[trial] {label}: card tests -k {key}: {tests[label]}",
              flush=True)
        if p.returncode == 0:
            trees[label] = root
        else:
            print(p.stdout[-4000:], p.stderr[-2000:], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    os.makedirs(SCRATCH, exist_ok=True)
    build_inputs(INPUTS)
    labels = list(trees)
    runs = {lab: [] for lab in labels}
    for r in range(a.rounds):
        for lab in (labels if r % 2 == 0 else labels[::-1]):
            res = run_tree(trees[lab])
            runs[lab].append(res)
            if "error" in res:
                print(f"[run] round {r} {lab}: FAILED {res['error']}",
                      flush=True)
                continue
            print(f"[run] round {r} {lab}: " + "; ".join(
                f"{c} " + " ".join(f"{m} {res[c][m]:.6g}" for m in METRICS)
                for c in CALLS), flush=True)
    summary = summarize(labels, runs)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump({"card": smi, "trees": trees, "trial_tests": tests,
                   "runs": runs, **summary}, f, indent=1)
    print(json.dumps(summary), flush=True)
    failed = [lab for lab in labels if any("error" in r for r in runs[lab])]
    failed += [lab for lab in tests if lab not in trees]
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
