"""The cell ``b-wiki.analytics`` (one corpus of four long files) and the
reader of ``traverse_host_rounds``.

The cell runs here the way ``test_tadoc_bench_faults.py`` runs the others:
a tiny copy of its configuration on the CPU, the harness's look for a card
skipped.  Its one partition is served through the server's single-corpus
path, so the faults that apply are an answer altered where it is produced
and an engine that fails (no batch holds a second partition to leave out).
"""

import time

import pytest
import torch

from repro_torch.obs import Span
from tadoc_bench import harness
from tadoc_bench.load import Request
from test_tadoc_bench_faults import (_correct, _run, alter_one, raises,
                                     tiny_root)  # noqa: F401 (a fixture)

CELL = "b-wiki.analytics"


def test_program_holds_and_control_fails(tiny_root):  # noqa: F811
    c, rec, files = _run(tiny_root, CELL)
    assert len(files) == 1             # one corpus
    assert rec.answers and len(rec.done()) == len(rec.requests)
    assert _correct(harness.check(c, files, rec)[0])
    assert not _correct(harness.check(c, files, rec, control=True)[0])


@pytest.mark.parametrize("fault", [alter_one, raises])
def test_broken_timed_path_fails(tiny_root, monkeypatch, fault):  # noqa: F811
    c, rec, files = _run(tiny_root, CELL, fault, monkeypatch)
    checks, _ = harness.check(c, files, rec)
    line = harness.result_line(c, rec, checks, False, "cpu", 0)
    assert line["correct"] is False and list(line)[-1] == "checks"
    assert line["failed"] == (len(rec.requests) if fault is raises else 0)


def test_traced_run_reads_its_layers(tiny_root):  # noqa: F811
    c = harness.load_cell(tiny_root, CELL)
    rec, files = harness.run_cell(c, 2**33 + 5, 1.5, True,
                                  lambda: torch.device("cpu"),
                                  time.monotonic(), log=lambda m: None)
    line = harness.result_line(c, rec, harness.check(c, files, rec)[0],
                               True, "cpu", 0)
    assert line["correct"] is True
    # the CPU has no device ops, so the device readers read nothing
    want = {m["name"] for m in c.per_layer} - {
        "device_idle_pct", "kernels_roofline"}
    assert set(line["metrics"]) == want
    # one corpus a request: every chunk is the single-corpus branch
    chunks = [s for tree in rec.span_trees() for s in tree.walk()
              if s.name == "chunk"]
    assert chunks and {s.attrs["n_corpora"] for s in chunks} == {1}


def _request(*rounds_by_execute):
    """A served request whose span tree holds one ``execute`` stage a
    round list, with a ``traverse`` child for each of its entries."""
    root = Span("query", 0.0, 1.0)
    for rounds in rounds_by_execute:
        chunk = Span("chunk", 0.0, 1.0, attrs={"kind": "word_count"})
        ex = Span("execute", 0.0, 1.0)
        ex.children = [Span("traverse", 0.0, 1.0,
                            attrs={"method": "frontier", "per_file": False,
                                   "host_rounds": r}) for r in rounds]
        chunk.children = [Span("pack_build", 0.0, 0.1), ex]
        root.children.append(chunk)
    req = Request(items=[(0, "word_count", ())], start=0.0, end=1.0)
    req.span = root
    return req


def _record(requests):
    cell = harness.load_cell(harness.BENCH.parent, CELL)
    return harness.RunRecord(cell=cell, device_name="cpu", setup_s=1.0,
                             window=(0.0, 1.0), requests=requests,
                             tokens=[10], sizes=[])


def test_traverse_host_rounds_reader():
    mod = harness.reader(_record([]).cell, "metrics", "traverse_host_rounds")
    # three execute stages: 10 + 9 rounds, none, 0 (a loop on the device)
    rec = _record([_request([10, 9]), _request([]), _request([0])])
    assert mod.read(rec) == pytest.approx(19 / 3)
    # spans without any traverse (a program that records none), or none
    assert mod.read(_record([_request([])])) is None
    assert mod.read(_record([])) is None
