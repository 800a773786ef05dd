"""A configuration, a mix and a metric added as files in a copy of the
benchmark are found by name, with no edit to a file that is there."""

import json
import shutil

from tadoc_bench import harness
from tadoc_bench.load import Request, Traffic

ROOT = harness.BENCH.parent


def test_added_files_are_found(tmp_path):
    shutil.copytree(harness.BENCH, tmp_path / harness.BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = tmp_path / harness.BENCH.name
    cfg = json.loads((bench / "configs" / "tadoc-a-nsfraa.json").read_text())
    cfg["name"] = "tadoc-x"
    cfg["text"]["partitions"] = 2
    (bench / "configs" / "tadoc-x.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "wc-only.json").write_text(json.dumps(
        {"kinds": {"word_count": 1}}))
    (bench / "metrics" / "requests_traced.py").write_text(
        "def read(run):\n    return float(len(run.traced))\n")
    spec["configs"].append({"name": "tadoc-x", "source": "a test",
                            "file": "tadoc_bench/configs/tadoc-x.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "x.wc", "config": "tadoc-x",
                              "traffic": "wc-only", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "requests_traced", "unit": "requests",
                              "better": "higher", "source": "program_counter",
                              "layer": "serving", "moves": "tokens_per_s",
                              "workloads": ["x.wc"]})
    spec["end_to_end"][1]["workloads"].append("x.wc")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.load_cell(tmp_path, "x.wc")
    assert cell.config["text"]["partitions"] == 2
    assert list(cell.mix["kinds"]) == ["word_count"]
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "tokens_per_s"}
    assert [m["name"] for m in cell.per_layer] == ["requests_traced"]
    traffic = Traffic(cell.mix, 2, 7)
    reqs = [next(traffic.closed()) for _ in range(2)]
    assert all(r.kind == "word_count" and len(r.items) == 2 for r in reqs)
    rec = harness.RunRecord(cell=cell, device_name="cpu", setup_s=1.0,
                            window=(0.0, 2.0), requests=reqs, tokens=[5, 6],
                            sizes=[], traced=reqs[:1])
    for r in reqs:
        r.start, r.end = 0.0, 1.0
    assert harness.read_metrics(cell, rec, trace=True) == {
        "requests_traced": {"value": 1.0, "unit": "requests"}}
    assert harness.read_metrics(cell, rec, trace=False) == {
        "setup_s": {"value": 1.0, "unit": "s"},
        "tokens_per_s": {"value": 11.0, "unit": "tokens/s"}}


def test_closed_blocks_hold_every_kind_once():
    mix = json.loads((harness.BENCH / "traffic" / "analytics.json"
                      ).read_text())
    gen = Traffic(mix, 3, 5).closed()
    reqs = [next(gen) for _ in range(18)]
    for b in range(3):
        assert sorted(r.kind for r in reqs[6 * b: 6 * b + 6]) == \
            sorted(mix["kinds"])
    assert all(isinstance(r, Request) and len(r.items) == 3 for r in reqs)
