"""Nothing the harness, its traffic or its reference loads is JAX or the
JAX package ``repro`` (top-level names compared whole: the port's name
``repro_torch`` begins with ``repro``)."""

import ast
import subprocess
import sys
from pathlib import Path

from tadoc_bench import harness

BENCH = harness.BENCH
ROOT = BENCH.parent


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_no_jax():
    for path in BENCH.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), (path, tops)


def test_reference_imports_nothing_of_the_program():
    paths = [BENCH / "reference.py", BENCH / "corpus.py", BENCH / "load.py",
             *sorted((BENCH / "kinds").glob("*.py"))]
    for path in paths:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert tops <= {"numpy", "tadoc_bench", "__future__", "functools",
                        "typing", "dataclasses"}, (path, tops)


def test_loaded_modules_hold_no_jax():
    """Import the harness, every kind and every reader in a fresh process,
    as a run does, and list the top-level names it loaded."""
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from tadoc_bench import harness\n"
        "import repro_torch.serving, repro_torch.data\n"
        f"for d in ('kinds', 'metrics', 'e2e'):\n"
        f"    for p in sorted((harness.BENCH / d).glob('*.py')):\n"
        "        harness.load_module(p)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    loaded = set(eval(out.strip().splitlines()[-1]))
    assert "repro_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN), loaded & set(
        harness.FORBIDDEN)
