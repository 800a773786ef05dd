"""Every cell, run by its command line, on the card (skips without one).

    python -m pytest -q tadoc_bench/tests -m card
"""

import json
import subprocess
import sys

import pytest

from tadoc_bench import harness

ROOT = harness.BENCH.parent
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run these tests on the card)")


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(cuda, cell, trace):
    out = subprocess.run(
        [sys.executable, "tadoc_bench/run.py", "--workload", cell,
         "--seed", "2147483659", "--seconds", "5", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    if trace:
        assert line["device"]["busy_s"] > 0
