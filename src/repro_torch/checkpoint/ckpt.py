"""Fault-tolerant checkpointing: the port of the JAX package's
``checkpoint/ckpt.py``, in the same on-disk layout.

Layout per step::

    <dir>/step_000123/
        manifest.json     # step, leaf keys, shard map, dtypes, extra
        shard_00000.npz   # flat {leaf key: array} (chunked by size budget)
    <dir>/LATEST          # atomic pointer file (rename-published)

Guarantees, kept as the JAX package has them:
  * atomic publish: a checkpoint is visible only after its LATEST pointer
    renames in — a killed writer never corrupts the previous checkpoint;
  * self-describing: the manifest lists every leaf key, so a template of
    the same structure restores it;
  * keep-last-k garbage collection;
  * host-agnostic: tensors are copied to the host and saved unsharded.

DESIGN — the leaf keys.  The JAX package names each leaf by
``jax.tree_util.keystr`` of its path in ``tree_flatten_with_path``.  The
port flattens nested ``dict`` / ``list`` / ``tuple`` / namedtuple trees
itself (:func:`flatten_with_paths`) with the same order and the same
strings — plain dict keys sorted (an ``OrderedDict`` keeps its order),
``['ga']['rule_ptr']`` for dict keys, ``[0]`` for sequence indices,
``.name`` for namedtuple fields, ``None`` an empty subtree, every other
object a leaf — and npz member names escape ``/`` as ``|``.  So a
checkpoint written by either package restores in the other.
:func:`restore_checkpoint` returns numpy leaves, as the JAX package does;
placing them on a device is the caller's job.
"""

from __future__ import annotations

import collections
import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_SHARD_BUDGET = 1 << 30     # 1 GiB per npz shard


# ----------------------------------------------------------------------- #
# Flattening (jax.tree_util's order and key strings, without jax)          #
# ----------------------------------------------------------------------- #
def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """``[(key string, child)]`` of an interior node in flattening order,
    or None for a leaf."""
    if isinstance(node, dict):
        keys = (list(node) if isinstance(node, collections.OrderedDict)
                else sorted(node))
        return [(f"[{k!r}]", node[k]) for k in keys]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    return None


def flatten_with_paths(tree) -> List[Tuple[str, Any]]:
    """``[(key, leaf)]`` of ``tree`` in ``jax.tree_util`` leaf order, each
    key the ``keystr`` of the leaf's path (module DESIGN note)."""
    out: List[Tuple[str, Any]] = []

    def walk(node, prefix: str) -> None:
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out.append((prefix, node))
            return
        for key, child in kids:
            walk(child, prefix + key)

    walk(tree, "")
    return out


def _unflatten(template, leaves: List[Any]):
    """``template``'s structure with its leaves replaced, in order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            keys = (list(node) if isinstance(node, collections.OrderedDict)
                    else sorted(node))
            vals = {k: build(node[k]) for k in keys}
            out = type(node)() if isinstance(
                node, collections.OrderedDict) else {}
            for k in node:              # the template's own key order
                out[k] = vals[k]
            return out
        if _is_namedtuple(node):
            return type(node)(*(build(getattr(node, f))
                                for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(build(c) for c in node)
        return next(it)

    return build(template)


def _host_array(leaf) -> np.ndarray:
    """A leaf as a host numpy array (tensors are copied off the device)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


# ----------------------------------------------------------------------- #
# Generic trees                                                            #
# ----------------------------------------------------------------------- #
def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[Dict] = None, keep: int = 3) -> str:
    """Write ``tree`` as step ``step`` under ``directory``, publish it as
    ``LATEST`` and keep the last ``keep`` steps.  Returns the step dir."""
    flat = [(k, _host_array(v)) for k, v in flatten_with_paths(tree)]
    step_dir = os.path.join(directory, f"step_{step:09d}")
    tmp_dir = step_dir + ".tmp"
    os.makedirs(tmp_dir, exist_ok=True)

    shards: List[Dict[str, np.ndarray]] = [{}]
    sizes = [0]
    shard_map: Dict[str, int] = {}
    for key, arr in flat:
        if sizes[-1] + arr.nbytes > _SHARD_BUDGET and shards[-1]:
            shards.append({})
            sizes.append(0)
        sid = len(shards) - 1
        shards[sid][key] = arr
        sizes[sid] += arr.nbytes
        shard_map[key] = sid

    for sid, shard in enumerate(shards):
        # npz member names cannot contain '/': escape
        np.savez(os.path.join(tmp_dir, f"shard_{sid:05d}.npz"),
                 **{k.replace("/", "|"): v for k, v in shard.items()})
    manifest = {
        "step": step,
        "keys": [k for k, _ in flat],
        "shard_map": shard_map,
        "dtypes": {k: str(v.dtype) for k, v in flat},
        "extra": extra or {},
    }
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.replace(tmp_dir, step_dir)
    # atomic LATEST pointer
    ptr_tmp = os.path.join(directory, "LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(f"{step}\n")
    os.replace(ptr_tmp, os.path.join(directory, "LATEST"))
    _gc(directory, keep)
    return step_dir


def latest_step(directory: str) -> Optional[int]:
    ptr = os.path.join(directory, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        return int(f.read().strip())


def _step_or_latest(directory: str, step: Optional[int]) -> int:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    return step


def restore_checkpoint(directory: str, template: Any,
                       step: Optional[int] = None
                       ) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``template`` (leaves replaced by the
    saved numpy arrays).  Returns ``(tree, step, extra)``."""
    step = _step_or_latest(directory, step)
    step_dir = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    cache: Dict[int, Any] = {}

    def shard(sid: int):
        if sid not in cache:
            cache[sid] = np.load(os.path.join(step_dir,
                                              f"shard_{sid:05d}.npz"))
        return cache[sid]

    values = [shard(manifest["shard_map"][key])[key.replace("/", "|")]
              for key, _ in flatten_with_paths(template)]
    return (_unflatten(template, values), manifest["step"],
            manifest.get("extra", {}))


# ----------------------------------------------------------------------- #
# Corpus snapshots                                                         #
# ----------------------------------------------------------------------- #
def save_corpus(directory: str, step: int, corpus, keep: int = 3) -> str:
    """Checkpoint a :class:`~repro_torch.data.store.CompressedCorpus`
    mid-ingest.

    The grammar arrays and the file table ride the sharded-npz tree;
    scalar metadata and the ingest ``epoch`` ride the manifest's ``extra``
    blob, so a snapshot taken between two ``append_files`` calls restores
    at the exact same epoch (the staleness guard keeps working across a
    restart).  Lazy import: checkpoint sits below the data layer."""
    from repro_torch.data.store import _ARRAY_FIELDS, _META_FIELDS
    tree = {
        "ga": {name: getattr(corpus.ga, name) for name in _ARRAY_FIELDS},
        "files": {"file_starts": corpus.file_starts,
                  "file_lens": corpus.file_lens},
    }
    extra = {
        "kind": "compressed_corpus",
        "epoch": int(corpus.epoch),
        "meta": {name: int(getattr(corpus.ga, name))
                 for name in _META_FIELDS},
    }
    return save_checkpoint(directory, step, tree, extra, keep)


def restore_corpus(directory: str, step: Optional[int] = None):
    """Restore a :func:`save_corpus` snapshot.  Returns
    ``(CompressedCorpus, step)``; the corpus resumes at its saved epoch
    with empty memos (derived state, recomputed and epoch-stamped on first
    use) and no live compressor state (rebuilt by replay on the first
    post-restore ``append_files``)."""
    from repro_torch.core import GrammarArrays
    from repro_torch.data.store import _ARRAY_FIELDS, CompressedCorpus
    step = _step_or_latest(directory, step)
    # vet the manifest before restoring: a non-corpus checkpoint has a
    # different leaf set and would fail with an opaque KeyError otherwise
    with open(os.path.join(directory, f"step_{step:09d}",
                           "manifest.json")) as f:
        kind = json.load(f).get("extra", {}).get("kind")
    if kind != "compressed_corpus":
        raise ValueError(f"checkpoint at {directory} step {step} is not a "
                         f"corpus snapshot (kind={kind!r})")
    template = {
        "ga": {name: 0 for name in _ARRAY_FIELDS},
        "files": {"file_starts": 0, "file_lens": 0},
    }
    tree, step, extra = restore_checkpoint(directory, template, step)
    ga = GrammarArrays(**tree["ga"], **extra["meta"])
    corpus = CompressedCorpus(ga=ga,
                              file_starts=tree["files"]["file_starts"],
                              file_lens=tree["files"]["file_lens"],
                              epoch=int(extra["epoch"]))
    return corpus, step


def _gc(directory: str, keep: int) -> None:
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:09d}"),
                      ignore_errors=True)


class CheckpointManager:
    """Every-N-steps save + resume."""

    def __init__(self, directory: str, every: int = 100, keep: int = 3):
        self.directory = directory
        self.every = every
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def maybe_save(self, step: int, tree: Any,
                   extra: Optional[Dict] = None) -> bool:
        if step % self.every:
            return False
        save_checkpoint(self.directory, step, tree, extra, self.keep)
        return True

    def restore_or_none(self, template: Any):
        if latest_step(self.directory) is None:
            return None
        return restore_checkpoint(self.directory, template)
