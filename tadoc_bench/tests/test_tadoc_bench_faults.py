"""The check catches what it is for.

Runs of tiny copies of the cells on the CPU (the harness's look for a card
skipped, everything else as a run on the card does it): the program's
answers hold; the control (the reference in bfloat16 in the program's
place) fails; and so does a run with the timed path broken underneath,
once for each fault the cell can have: an answer altered where it is
produced, and (where a batch holds several partitions) half of the batch
left out, the rest standing in for it; and an engine that fails, whose
answers never come.
"""

import json
import shutil
import time

import numpy as np
import pytest
import torch

from repro_torch.serving.analytics_server import AnalyticsServer
from tadoc_bench import harness

ROOT = harness.BENCH.parent
TINY = {"files_per_partition": 8, "tokens_per_file": 400, "vocab": 500}
CELL = "a-nsfraa.analytics"


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny")
    shutil.copytree(harness.BENCH, root / harness.BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for cfg in (root / harness.BENCH.name / "configs").glob("*.json"):
        c = json.loads(cfg.read_text())
        c["text"].update(TINY, partitions=min(3, c["text"]["partitions"]))
        cfg.write_text(json.dumps(c))
    return root


def _altered(answer):
    """The answer with one entry changed."""
    if isinstance(answer, (tuple, list)):       # (ids, counts): the counts
        return type(answer)(list(answer[:-1]) + [_altered(answer[-1])])
    a = np.array(answer, copy=True)
    flat = a.reshape(-1)
    flat[0] = ~flat[0] if a.dtype == bool else flat[0] + 1
    return a


def alter_one(vals):
    return [_altered(vals[0])] + list(vals[1:])


def half_left_out(vals):
    keep = len(vals) - len(vals) // 2
    return list(vals[:keep]) + list(vals[:len(vals) - keep])


def raises(vals):
    raise RuntimeError("the engine failed")


def _run(root, cell_name, fault=None, monkeypatch=None):
    if fault is not None:
        orig, warm_up = AnalyticsServer._execute_batched, harness.warm_up

        def broken(self, *a, **kw):
            return fault(orig(self, *a, **kw))

        def warm_then_break(*a):           # the window's path only
            warm_up(*a)
            monkeypatch.setattr(AnalyticsServer, "_execute_batched", broken)
        monkeypatch.setattr(harness, "warm_up", warm_then_break)
    cell = harness.load_cell(root, cell_name)
    rec, files = harness.run_cell(cell, 2**31 + 17, 1.5, False,
                                  lambda: torch.device("cpu"),
                                  time.monotonic(), log=lambda m: None)
    return cell, rec, files


def _correct(checks):
    return all(c["value"] <= c["limit"] for c in checks.values())


@pytest.mark.parametrize("cell", [CELL])
def test_program_holds_and_control_fails(tiny_root, cell):
    c, rec, files = _run(tiny_root, cell)
    assert rec.answers and len(rec.done()) == len(rec.requests)
    assert _correct(harness.check(c, files, rec)[0])
    assert not _correct(harness.check(c, files, rec, control=True)[0])


@pytest.mark.parametrize("cell,fault", [
    (CELL, alter_one),
    (CELL, half_left_out),
    (CELL, raises),
])
def test_broken_timed_path_fails(tiny_root, monkeypatch, cell, fault):
    c, rec, files = _run(tiny_root, cell, fault, monkeypatch)
    checks, _ = harness.check(c, files, rec)
    assert not _correct(checks)
    line = harness.result_line(c, rec, checks, False, "cpu", 0)
    assert line["correct"] is False and list(line)[-1] == "checks"
    assert line["failed"] == (len(rec.requests) if fault is raises else 0)


@pytest.mark.parametrize("cell", [CELL])
def test_traced_run_reads_its_layers(tiny_root, cell):
    c = harness.load_cell(tiny_root, cell)
    rec, files = harness.run_cell(c, 11, 1.5, True,
                                  lambda: torch.device("cpu"),
                                  time.monotonic(), log=lambda m: None)
    line = harness.result_line(c, rec, harness.check(c, files, rec)[0],
                               True, "cpu", 0)
    assert line["correct"] is True
    assert rec.trace is not None and rec.trace["window_s"] > 0
    # the CPU has no device ops, so the device readers read nothing
    want = {m["name"] for m in c.per_layer} - {
        "device_idle_pct", "kernels_roofline"}
    assert set(line["metrics"]) == want
