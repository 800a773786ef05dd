"""Distribution layer: sharding rules (single device) + 8-device subprocess
(sharded==single, gpipe, elastic resharding)."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro.distributed import MeshRules, default_rules, spec_for


class FakeMesh:
    """Just enough of a Mesh for spec_for (axis sizes + names)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def test_spec_for_divisibility_fallback():
    mesh = FakeMesh({"data": 16, "model": 16})
    rules = MeshRules(rules={"vocab": "model", "embed": "data",
                             "heads": "model"}, batch_axes=("data",))
    # divisible -> sharded
    assert spec_for(("vocab", "embed"), (160, 32), mesh, rules) == \
        P("model", "data")
    # heads=14 not divisible by 16 -> replicated on that dim
    assert spec_for(("embed", "heads", None), (32, 14, 64), mesh, rules) == \
        P("data",)
    # one mesh axis never used twice
    rules2 = MeshRules(rules={"a": "model", "b": "model"},
                       batch_axes=("data",))
    assert spec_for(("a", "b"), (16, 16), mesh, rules2) == P("model")


def test_default_rules_multipod_fsdp():
    mesh = FakeMesh({"pod": 2, "data": 16, "model": 16})
    r = default_rules(mesh, fsdp_over_pod=True)
    assert r.assign("embed") == ("pod", "data")
    r2 = default_rules(mesh, fsdp_over_pod=False)
    assert r2.assign("embed") == "data"
    assert r2.batch_axes == ("pod", "data")


def test_trailing_nones_trimmed():
    mesh = FakeMesh({"data": 4, "model": 2})
    rules = MeshRules(rules={"embed": "data"}, batch_axes=("data",))
    spec = spec_for((None, "embed", None, None), (3, 8, 5, 7), mesh, rules)
    assert spec == P(None, "data")


@pytest.mark.slow
def test_multidevice_subprocess():
    """sharded==single, gpipe==sequential, elastic dp 4->2 (8 devices)."""
    worker = os.path.join(os.path.dirname(__file__),
                          "_multidevice_worker.py")
    r = subprocess.run([sys.executable, worker], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert "MULTIDEVICE ALL OK" in r.stdout
