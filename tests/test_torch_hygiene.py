"""Structural rules of the PyTorch port, checked on the CPU.

* ``src/repro_torch`` and ``chip_smoke.py`` import neither JAX nor the JAX
  package (``repro``) — the port stands alone on the card's machine.
* Entry points run on the card unless the caller asks for the CPU; without
  a CUDA device the default raises instead of falling back.
* Kernel wrappers take the plain version only for CPU tensors.
* Every C entry point a wrapper binds exists in ``csrc`` with the argument
  count the wrapper declares (nothing compiles the sources here).
* ``chip_smoke.py`` fails, printing no result, without a card or outside a
  checkout.
"""

import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import GrammarBatch, compress_files, flatten, run_batched
from repro_torch.core import (analytics, bottom_up_tables, per_file_weights,
                              sequence_count, traversal)
from repro_torch.data import CompressedCorpus
from repro_torch.kernels import _common, ops
from repro_torch.kernels import (bincount, propagate, propagate_batched,
                                 propagate_fused, propagate_vector,
                                 rank_files)
from repro_torch.obs import global_registry, plan_stage, span

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tools" / "kernel_ab.py"]
KERNEL_MODULES = (bincount, propagate, propagate_batched, propagate_fused,
                  propagate_vector, rank_files)


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def _tiny_gas():
    g, nf = compress_files([np.array([1, 2, 1, 2, 3, 1, 2])], 4)
    return [flatten(g, 4, nf)]


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GrammarBatch.build(_tiny_gas())
    with pytest.raises(RuntimeError, match="CUDA"):
        _common.resolve_device("cuda")
    assert GrammarBatch.build(_tiny_gas(), device="cpu").device.type == "cpu"


def test_cuda_without_index_names_the_current_card(monkeypatch):
    """"cuda" resolves to the current card's index, so it equals the
    device of the tensors made there and keys one memo entry per card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    for name in ("cuda", torch.device("cuda"), None):
        assert _common.resolve_device(name) == torch.device("cuda", 3)
    assert _common.resolve_device("cuda:1") == torch.device("cuda", 1)


def test_single_corpus_entry_points_raise_without_cuda(monkeypatch):
    """The single-corpus engine and the store run on the card unless the
    caller asks for the CPU; with no card the default raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ga = _tiny_gas()[0]
    corpus = CompressedCorpus.build([np.array([1, 2, 1, 2, 3])], 4)
    for call in (lambda: traversal.top_down_weights(ga),
                 lambda: analytics.word_count(ga),
                 lambda: corpus.top_down_weights(),
                 lambda: per_file_weights(ga),
                 lambda: bottom_up_tables(ga),
                 lambda: sequence_count(ga)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    w = traversal.top_down_weights(ga, device="cpu")
    assert w.device.type == "cpu"
    assert corpus.top_down_weights(device="cpu").device.type == "cpu"
    assert analytics.word_count(ga, weights=w, device="cpu").shape == (4,)


def test_unsupported_devices_raise():
    with pytest.raises(ValueError, match="unsupported device"):
        _common.resolve_device("meta")
    t = torch.zeros((1, 4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="not supported"):
        ops.ell_propagate_batched(torch.zeros((1, 4), device="meta"),
                                  torch.zeros((1, 4), device="meta"), t,
                                  torch.zeros((1, 4, 2), device="meta"))


def _c_entry_points():
    """{symbol: parameter count} of every ``extern "C"`` function."""
    out = {}
    for src in _common.sources():
        text = src.read_text()
        for m in re.finditer(r'extern "C" [\w\s\*]+?\b(repro_\w+)\(([^)]*)\)',
                             text):
            out[m.group(1)] = len([p for p in m.group(2).split(",")
                                   if p.strip()])
    return out


@pytest.mark.parametrize("module", KERNEL_MODULES,
                         ids=[m.__name__.rsplit(".", 1)[1]
                              for m in KERNEL_MODULES])
def test_wrappers_bind_existing_entry_points(module):
    entry = _c_entry_points()
    text = Path(module.__file__).read_text()
    symbols = re.findall(r'kernel_fn\("(repro_\w+)"', text)
    assert len(symbols) == 1
    assert symbols[0] in entry, f"{symbols[0]} is not defined in csrc"
    assert entry[symbols[0]] == len(module._ARGTYPES)
    assert module.launches.count >= 0
    assert module.launches.name in _common.launch_counts()


def test_every_source_is_built_and_keys_the_library(tmp_path, monkeypatch):
    names = {p.name for p in _common.sources()}
    assert {"propagate_batched.cu", "propagate_fused.cu",
            "propagate_vector.cu", "bincount.cu", "row_sums.cu"} <= names
    before = _common.library_path()
    copy = tmp_path / "csrc"
    shutil.copytree(_common.CSRC_DIR, copy)
    monkeypatch.setattr(_common, "CSRC_DIR", copy)
    assert _common.library_path() == before
    hdr = copy / "ell_common.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    assert _common.library_path() != before


def test_launch_counters_reset():
    propagate_batched.launches.inc()
    assert _common.launch_counts()["ell_propagate_batched"] >= 1
    _common.reset_launch_counts()
    assert set(_common.launch_counts().values()) == {0}


@pytest.mark.parametrize("where", ["alone", "no_card"])
def test_chip_smoke_fails_without_card_or_checkout(where, tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    if where == "alone":
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    else:
        cwd = REPO
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_metrics_record_ingest_plans_and_dispatch():
    """The port meters what the JAX package meters on its process
    registry: Sequitur ingest, plan builds (attached to the ambient span:
    here the traversal that needed the plan) and kernel dispatch
    decisions."""
    reg = global_registry()
    files = reg.counter("repro_ingest_files_total")
    before_files = files.value
    gb = GrammarBatch.build(_tiny_gas(), device="cpu")
    assert files.value == before_files + 1
    plans = reg.histogram("repro_plan_build_seconds", "",
                          ("plan",)).labels("ell")
    execs = reg.counter("repro_kernel_dispatch_total", "",
                        ("decision", "path")).labels("exec:ell_batched",
                                                     "plain")
    before_plans, before_execs = plans.count, execs.value
    with span("request") as root:
        run_batched(gb, "word_count", "leveled_ell")
    assert plans.count == before_plans + 1
    assert [c.name for c in root.children] == ["traverse"]
    assert [c.name for c in root.children[0].children] == ["plan:ell"]
    assert root.children[0].children[0].finished
    assert execs.value > before_execs
    with pytest.raises(ValueError, match="already registered"):
        reg.histogram("repro_kernel_dispatch_total")
    with pytest.raises(ValueError, match="invalid metric name"):
        reg.counter("bad name")
    with plan_stage("unit"):
        pass
    assert reg.histogram("repro_plan_build_seconds", "",
                         ("plan",)).labels("unit").count >= 1
