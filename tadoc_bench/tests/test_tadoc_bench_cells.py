"""Every cell and metric of ``BENCHMARK.json`` is found as data, and the
file keeps to the form and limits its readers expect."""

import json
import re

import pytest

from tadoc_bench import harness

ROOT = harness.BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    for x in names + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(x), x
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / c["file"]).is_file()
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in SPEC["workloads"]]
                 + [c["why"] for c in SPEC["configs"]]
                 + [c["source"] for c in SPEC["configs"]]
                 + [m["layer"] for m in SPEC["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_bounds_and_budget():
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    rs = SPEC["run_seconds"]
    assert 1 <= rs <= 51
    # a full check of 24 cells fits its 43200 seconds
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert all(w["chips"] == 1 for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_found_as_data(cell):
    c = harness.load_cell(ROOT, cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.end_to_end:
        assert hasattr(harness.reader(c, "e2e", m["name"]), "read")
    for m in c.per_layer:
        assert m["moves"] in e2e
        assert hasattr(harness.reader(c, "metrics", m["name"]), "read")
    for kind in c.mix["kinds"]:
        mod = harness.kind_module(c, kind)
        assert hasattr(mod, "reference") and hasattr(mod, "input_bytes")


def test_every_metric_reaches_a_cell():
    reported = set()
    for cell in CELLS:
        c = harness.load_cell(ROOT, cell)
        reported |= {m["name"] for m in c.end_to_end + c.per_layer}
    assert reported == {m["name"] for m in SPEC["end_to_end"]
                        + SPEC["per_layer"]}
