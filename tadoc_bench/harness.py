"""The benchmark of the port (``repro_torch``): one run of one cell.

A cell of ``BENCHMARK.json`` names a configuration (a deployment, in
``configs/<config>.json``) and a traffic mix (``traffic/<mix>.json``).  A
run

1. brings up the card, makes the deployment's raw text from the seed
   (``corpus.py``) and compresses each partition with the port's
   ``CompressedCorpus.build``;
2. registers every partition's ``GrammarArrays`` on one
   ``AnalyticsServer`` and warms up the shapes the mix sends;
3. measures for ``seconds``, to the end of the block of the mix in
   progress: a closed loop of ``AnalyticsServer.run`` calls (``load.py``),
   every request timed on the host clock to its answer on the host; a
   traced run also records the server's spans and profiles the device over
   a steady stretch of the window (``profile.py``);
4. after the window, with the program's state freed, holds a sample of the
   served answers, drawn from the seed, to the plain reference
   (``reference.py`` and ``kinds/<kind>.py``);
5. reads each metric with its reader (``e2e/<metric>.py``,
   ``metrics/<metric>.py``).

Everything that belongs to one configuration, mix, kind or metric is a
file of its own, found by its name; nothing here names a cell.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional, Tuple

import numpy as np

from tadoc_bench import corpus, roofline
from tadoc_bench.load import Request, Traffic
from tadoc_bench.profile import REQUEST, DeviceTrace
from tadoc_bench.reference import Partition, bad_entries

BENCH = Path(__file__).resolve().parent
#: Top-level modules that may not be loaded in a run (compared whole:
#: the port ``repro_torch`` is not the JAX package ``repro``).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: The window keeps, of each kind, one of its first few answers
#: (drawn from the seed) and its last.
EARLY_SAMPLE = 3


# --------------------------------------------------------------------- #
# The cell, as data                                                      #
# --------------------------------------------------------------------- #
@dataclass
class Cell:
    name: str
    root: Path                      # holds BENCHMARK.json and tadoc_bench/
    chips: int
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def bench(self) -> Path:
        return self.root / BENCH.name


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration,
    its mix and the metrics it reports."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; the cells are "
                       f"{sorted(cells)}")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    return Cell(name=name, root=root, chips=int(w["chips"]),
                config=load_json(root / cfg["file"]),
                mix=load_json(root / BENCH.name / "traffic"
                              / f"{w['traffic']}.json"),
                end_to_end=e2e, per_layer=per_layer)


def load_module(path: Path) -> ModuleType:
    """A metric reader or a kind, by its file (names may hold dots)."""
    name = "tadoc_bench_" + "_".join(path.with_suffix("").parts[-2:]
                                     ).replace(".", "_").replace("-", "_")
    mod = sys.modules.get(name)
    if mod is None or getattr(mod, "__file__", None) != str(path):
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
    return mod


def kind_module(cell: Cell, kind: str) -> ModuleType:
    return load_module(cell.bench / "kinds" / f"{kind}.py")


def reader(cell: Cell, folder: str, metric: str) -> ModuleType:
    return load_module(cell.bench / folder / f"{metric}.py")


# --------------------------------------------------------------------- #
# Set-up                                                                 #
# --------------------------------------------------------------------- #
@dataclass
class Deployment:
    names: List[str]
    files: List[List[np.ndarray]]
    sizes: List[dict]
    tokens: List[int]
    server: object
    device: object
    compress_s: float
    ready_s: float                  # the card and the server's imports


class NoCard(RuntimeError):
    """The machine holds fewer CUDA cards than the cell asks for."""


def card(chips: int):
    """Bring up the first CUDA card; :class:`NoCard` where the machine
    holds fewer than ``chips``."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise NoCard(f"needs {chips} CUDA card(s); torch.cuda.is_available()"
                     f" is {torch.cuda.is_available()}, device_count() is "
                     f"{torch.cuda.device_count()}")
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)
    torch.cuda.synchronize(device)
    return device


def deploy(cell: Cell, seed: int, bring_up, trace: bool) -> Deployment:
    """Bring up the device (``bring_up()``: the card, or the CPU in
    tests), then make, compress and register the configuration's
    partitions one after another.  The text is made by the benchmark
    (``corpus.py``); the grammars are the program's
    (``CompressedCorpus.build``)."""
    t0 = time.monotonic()
    device = bring_up()
    from repro_torch.data import CompressedCorpus
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serving import AnalyticsServer
    ready_s = time.monotonic() - t0
    text = cell.config["text"]
    n = int(text["partitions"])
    files = [corpus.partition_files(text, seed, p) for p in range(n)]
    gas = [CompressedCorpus.build(fs, text["vocab"]).ga for fs in files]
    compress_s = time.monotonic() - t0
    srv_cfg = cell.config["server"]
    srv = AnalyticsServer(max_batch=int(srv_cfg["max_batch"]),
                          method=srv_cfg["method"], device=device,
                          registry=MetricsRegistry(enabled=trace))
    names = [f"p{p:03d}" for p in range(n)]
    for name, ga in zip(names, gas):
        srv.register(name, ga)
    return Deployment(names=names, files=files,
                      sizes=[roofline.grammar_sizes(ga) for ga in gas],
                      tokens=[sum(len(f) for f in fs) for fs in files],
                      server=srv, device=device,
                      compress_s=compress_s, ready_s=ready_s)


def queries(dep: Deployment, req: Request) -> list:
    from repro_torch.serving import Query
    return [Query(dep.names[p], kind, **dict(params))
            for p, kind, params in req.items]


def as_tuple(answer):
    """A served answer with its lists made tuples (the reference's
    shape)."""
    return tuple(answer) if isinstance(answer, list) else answer


def answer_bytes(answer) -> int:
    if isinstance(answer, (tuple, list)):
        return sum(answer_bytes(a) for a in answer)
    return int(np.asarray(answer).nbytes)


# --------------------------------------------------------------------- #
# The run's record, which the readers read                               #
# --------------------------------------------------------------------- #
@dataclass
class RunRecord:
    cell: Cell
    device_name: str
    setup_s: float
    window: Tuple[float, float]
    requests: List[Request]
    tokens: List[int]
    sizes: List[dict]
    trace: Optional[dict] = None
    traced: List[Request] = field(default_factory=list)
    answers: Dict[int, list] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def done(self) -> List[Request]:
        return [r for r in self.requests
                if r.error is None and np.isfinite(r.end)]

    def request_tokens(self, req: Request) -> int:
        return sum(self.tokens[p] for p, _, _ in req.items)

    def bytes_needed(self, req: Request) -> int:
        """What the request's analytics must move through device memory:
        the grammar read (by the kind's count) and every answer
        written."""
        kinds = {k: kind_module(self.cell, k) for _, k, _ in req.items}
        return req.out_bytes + sum(
            kinds[k].input_bytes(self.sizes[p], dict(params))
            for p, k, params in req.items)

    def span_trees(self) -> list:
        """The server's span trees of the window (a traced run), one a
        request."""
        return [r.span for r in self.requests if r.span is not None]

    def peaks(self) -> Optional[dict]:
        return roofline.peaks(self.device_name)


# --------------------------------------------------------------------- #
# Warm-up and the window                                                 #
# --------------------------------------------------------------------- #
def _annotate(req: Request, trace: Optional[DeviceTrace]):
    if trace is None or not trace.active:
        return nullcontext()
    from torch.profiler import record_function
    return record_function(REQUEST + req.kind)


@dataclass
class Window:
    span: Tuple[float, float]       # host clock: the window's start, end
    requests: List[Request]
    answers: Dict[int, list]        # request index -> answers kept
    traced: List[Request] = field(default_factory=list)


def closed_window(dep: Deployment, traffic: Traffic, seconds: float,
                  seed: int, trace: Optional[DeviceTrace]) -> Window:
    """One client: each request is sent when the last has returned.  The
    window runs from the first request's start to the end of the block of
    the mix in progress when ``seconds`` have passed, so that it holds
    whole blocks, the same work for every seed.  Of each kind the answers
    of one of its first ``EARLY_SAMPLE`` requests (drawn from the seed)
    and of its last are kept for the check.  A traced run profiles whole
    blocks from a third of the way in, for at least ``min(5, seconds /
    3)`` seconds."""
    gen = traffic.closed()
    block = traffic.block
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x5A3, 1]))
    early = {k: int(rng.integers(EARLY_SAMPLE)) for k in traffic.kinds}
    seen: Dict[str, int] = {}
    latest: Dict[str, int] = {}
    kept_early = set()
    win = Window(span=(0.0, 0.0), requests=[], answers={})
    prof_at, prof_len, prof_t0 = seconds / 3, min(5.0, seconds / 3), None
    t_start = time.monotonic()
    while True:
        i = len(win.requests)
        now = time.monotonic() - t_start
        if i and i % block == 0 and now >= seconds:
            break
        if trace is not None and i % block == 0:
            if prof_t0 is None and now >= prof_at:
                trace.start()
                prof_t0 = time.monotonic() - t_start
            elif trace.active and now - prof_t0 >= prof_len:
                trace.stop()
        req = next(gen)
        qs = queries(dep, req)
        req.start = time.monotonic()
        try:
            with _annotate(req, trace):
                res = dep.server.run(qs)
        except Exception as e:          # noqa: BLE001 — counted as failed
            req.error = f"{type(e).__name__}: {e}"
            res = None
        req.end = time.monotonic()
        win.requests.append(req)
        if trace is not None and trace.active:
            win.traced.append(req)
        if res is not None:
            req.out_bytes = answer_bytes(res)
            req.span = qs[0].trace
            k = req.kind
            seen[k] = seen.get(k, 0) + 1
            if seen[k] - 1 == early[k]:
                kept_early.add(i)
            prev = latest.get(k)
            if prev is not None and prev not in kept_early:
                del win.answers[prev]
            win.answers[i] = res
            latest[k] = i
    if trace is not None and trace.active:
        trace.stop()
    win.span = (t_start, win.requests[-1].end)
    return win


def warm_up(dep: Deployment, traffic: Traffic) -> None:
    """Every shape the window's requests use: each kind of the mix over
    every partition, once."""
    everyone = list(range(len(dep.names)))
    for k in traffic.kinds:
        dep.server.run(queries(dep, Request(traffic.items(k, everyone))))


# --------------------------------------------------------------------- #
# The check                                                              #
# --------------------------------------------------------------------- #
def check(cell: Cell, dep_files: List[List[np.ndarray]], rec: RunRecord,
          control: bool = False) -> Tuple[Dict[str, dict], Dict[str, int]]:
    """The number the check compares, with its limit, and its split by
    kind.  ``wrong_entries`` counts the entries of the kept answers that
    differ from the reference's, and every entry of each answer that never
    came or came as an error.  The deployment states exact answers, so its
    limit is 0.  ``control=True`` puts the reference computed in the
    precision below the deployment's in the program's place."""
    vocab = int(cell.config["text"]["vocab"])
    wrong: Dict[str, int] = {k: 0 for k in cell.mix["kinds"]}
    failed = {i for i, r in enumerate(rec.requests)
              if r.error is not None or not np.isfinite(r.end)}
    # every answer of one (partition, kind, parameters) against one
    # reference, a partition at a time, so that its counts are freed
    # before the next partition's are made
    jobs: Dict[tuple, list] = {}
    for i in sorted(set(rec.answers) | failed):
        req = rec.requests[i]
        served = rec.answers.get(i, [None] * len(req.items))
        for item, ans in zip(req.items, served):
            jobs.setdefault(item, []).append(None if i in failed
                                             else as_tuple(ans))
    for p in sorted({item[0] for item in jobs}):
        truth = Partition(dep_files[p], vocab)
        low = Partition(dep_files[p], vocab, low=True)
        for (q, kind, params), got in jobs.items():
            if q != p:
                continue
            mod = kind_module(cell, kind)
            want = mod.reference(truth, dict(params))
            lower = mod.reference(low, dict(params)) if control else None
            for g in got:
                wrong[kind] += bad_entries(
                    lower if control and g is not None else g, want)
    return {"wrong_entries": {"value": sum(wrong.values()),
                              "limit": 0}}, wrong


# --------------------------------------------------------------------- #
# One run                                                                #
# --------------------------------------------------------------------- #
def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, bring_up,
             t0: float, log=print) -> Tuple[RunRecord, list]:
    """Set up, measure and free the program's state; returns the record
    and the raw files the check compares against.  ``bring_up()`` returns
    the device (``card`` on the chip)."""
    t_deploy = time.monotonic()
    dep = deploy(cell, seed, bring_up, trace)
    import torch                    # brought in by ``bring_up`` already
    device = dep.device
    log(f"[setup] {len(dep.names)} partitions, {sum(dep.tokens)} tokens, "
        f"made and compressed in {dep.compress_s:.3f} s; rules "
        f"{[s['rules'] for s in dep.sizes]}")
    traffic = Traffic(cell.mix, len(dep.names), seed)
    t_warm = time.monotonic()
    warm_up(dep, traffic)
    dev_trace = DeviceTrace(device) if trace else None
    if dev_trace is not None:
        dev_trace.prime()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.monotonic() - t0
    log(f"[setup] {setup_s:.3f} s: {t_deploy - t0:.3f} s to the deployment, "
        f"the device ready after {dep.ready_s:.3f} s and the text made and "
        f"compressed after {dep.compress_s:.3f} s of it, registered "
        f"{t_warm - t_deploy - dep.compress_s:.3f} s later, warm-up "
        f"{time.monotonic() - t_warm:.3f} s")
    win = closed_window(dep, traffic, seconds, seed, dev_trace)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    rec = RunRecord(cell=cell, device_name=name, setup_s=setup_s,
                    window=win.span, requests=win.requests, tokens=dep.tokens,
                    sizes=dep.sizes,
                    trace=dev_trace.summary if dev_trace else None,
                    traced=win.traced, answers=win.answers)
    files = dep.files
    dep.server = None
    del dep, win
    gc.collect()
    return rec, files


def read_metrics(cell: Cell, rec: RunRecord, trace: bool) -> Dict[str, dict]:
    """The cell's end-to-end metrics (``trace=False``) or its per-layer
    ones, each by its reader; a reader that finds nothing to read returns
    None and its metric is left out."""
    entries = cell.per_layer if trace else cell.end_to_end
    folder = "metrics" if trace else "e2e"
    out = {}
    for m in entries:
        v = reader(cell, folder, m["name"]).read(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def result_line(cell: Cell, rec: RunRecord, checks: Dict[str, dict],
                trace: bool, platform: str, memory_peak_bytes: int) -> dict:
    """The run's last line: ``checks``, each number compared beside its
    limit, comes last."""
    device = {"platform": platform, "kind": rec.device_name,
              "count": cell.chips, "memory_peak_bytes": memory_peak_bytes}
    line = {"correct": all(c["value"] <= c["limit"]
                           for c in checks.values()),
            "attempted": len(rec.requests),
            "failed": len(rec.requests) - len(rec.done()),
            "metrics": read_metrics(cell, rec, trace), "device": device}
    if trace and rec.trace is not None:
        device["busy_s"] = rec.trace["busy_s"]
        device["window_s"] = rec.trace["window_s"]
        line["breakdown"] = {"device_ops": rec.trace["device_ops"],
                             "idle_gaps": rec.trace["idle_gaps"]}
    line["checks"] = checks
    return line


def summary_lines(rec: RunRecord) -> List[str]:
    """The sample counts and the spread of the window, for the log."""
    done = rec.done()
    by_kind: Dict[str, int] = {}
    for r in done:
        by_kind[r.kind] = by_kind.get(r.kind, 0) + 1
    lines = [f"[window] {len(rec.requests)} requests, {len(done)} answered "
             f"in {rec.window_s:.3f} s; by kind {by_kind}; answers kept for "
             f"the check {len(rec.answers)}"]
    ms = {k: np.asarray([(r.end - r.start) * 1e3 for r in done
                         if r.kind == k]) for k in by_kind}
    lines.append("[window] ms a request by kind (median / p90 / max): "
                 + ", ".join(f"{k} {np.median(v):.2f} / "
                             f"{np.percentile(v, 90):.2f} / {v.max():.2f}"
                             for k, v in ms.items()))
    if done:
        t0, t1 = rec.window
        thirds = [[r for r in done if t0 + j * (t1 - t0) / 3 <= r.end
                   < t0 + (j + 1) * (t1 - t0) / 3 + (j == 2)]
                  for j in range(3)]
        lines.append("[window] tokens/s by third of the window: " + ", ".join(
            f"{sum(rec.request_tokens(r) for r in th) * 3 / (t1 - t0):.6g}"
            for th in thirds))
    return lines
