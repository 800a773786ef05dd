"""Corpus-sharded execution of :class:`~repro_torch.core.batch.GrammarBatch`
across cards.

The port of the JAX package's ``distributed/shard_batch.py``.  There a 1-D
jax ``Mesh`` splits the packed ``[N, ...]`` arrays row-wise and
``shard_map`` runs the single-device program on every shard.  In PyTorch's
idiom:

* :class:`CorpusMesh` is a tuple of ``torch.device`` s, in shard order,
  with a small pool of one host thread per shard.  :meth:`CorpusMesh.map`
  runs one function per shard, each on its own thread with its card
  current (PyTorch's current device is per thread), so the per-round host
  syncs of one shard's engine loop never wait for another card; the
  results come back in shard order and a shard's exception reaches the
  caller.  :func:`corpus_mesh` builds one over every visible card (``None``
  with fewer than two: the single-card pack) or over an explicit device
  sequence, in which a device may repeat — ``("cpu",) * 4`` or
  ``("cuda:0",) * 3`` — the stand-in for the JAX package's
  ``--xla_force_host_platform_device_count``, so that one card (or the CPU)
  drives 2-4 shards.
* :func:`pad_corpora` pads a corpus list up to a multiple of the shard
  count by repeating the smallest grammar (no padded dim grows), and
  :func:`shard_batch` packs, pads and shards
  (:meth:`GrammarBatch.shard`: one row-slice sub-pack per device, with the
  padded dims identical on every shard and ``n_real`` real rows).
* The engines notice ``gb.mesh`` and run the unsharded engine on each
  shard's sub-pack, on that shard's device, gather the results in row
  order and drop the padding rows.  Nothing crosses shards, so each
  shard's frontier loop stops when its own corpora finish.

Results are bit-identical to the unsharded pack: corpus rows never
interact, each shard runs the single-pack code on its rows, and every
count is integer-valued float32 far below 2**24.
"""

from __future__ import annotations

import concurrent.futures
import contextvars
import threading
from contextlib import nullcontext
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.batch import GrammarBatch, run_batched
from repro_torch.core.grammar import GrammarArrays
from repro_torch.kernels._common import resolve_device

__all__ = ["CorpusMesh", "corpus_mesh", "mesh_size", "pad_corpora",
           "shard_batch", "run_sharded"]

_WORKER = threading.local()


class CorpusMesh:
    """The devices a sharded pack's rows split over, in shard order, and
    the host threads that drive them (one a shard, started at first use)."""

    def __init__(self, devices: Sequence):
        self.devices: Tuple[torch.device, ...] = tuple(
            resolve_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a corpus mesh needs at least one device")
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._lock = threading.Lock()

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"CorpusMesh({[str(d) for d in self.devices]})"

    def _executor(self) -> concurrent.futures.ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=self.size, thread_name_prefix="corpus-shard")
            return self._pool

    def _scope(self, i: int):
        dev = self.devices[i]
        return torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()

    def _run(self, fn: Callable, i: int, item):
        _WORKER.active = True
        try:
            with self._scope(i):
                return fn(item)
        finally:
            _WORKER.active = False

    def map(self, fn: Callable, items: Sequence) -> List:
        """``[fn(items[i]) for shard i]``, each call on its own host thread
        with shard i's card current (the caller's tracing context goes
        along).  Every call finishes before this returns; the first failure
        in shard order is raised.  A call made from inside a shard runs its
        items in turn on that thread."""
        if len(items) != self.size:
            raise ValueError(f"{len(items)} items for a mesh of "
                             f"{self.size} shards")
        if getattr(_WORKER, "active", False):
            out = []
            for i, item in enumerate(items):
                with self._scope(i):
                    out.append(fn(item))
            return out
        pool = self._executor()
        futures = [pool.submit(contextvars.copy_context().run, self._run, fn,
                               i, item) for i, item in enumerate(items)]
        concurrent.futures.wait(futures)
        return [f.result() for f in futures]

    def close(self) -> None:
        """Stop the shard threads (a later :meth:`map` starts new ones)."""
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)


def corpus_mesh(devices: Optional[Sequence] = None
                ) -> Optional[CorpusMesh]:
    """A corpus mesh over ``devices`` (default: every visible card), or
    ``None`` when fewer than two are given — callers treat ``None`` as the
    plain single-device pack.  A device may repeat (module docstring)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if len(devices) < 2:
        return None
    return CorpusMesh(devices)


def mesh_size(mesh: Optional[CorpusMesh]) -> int:
    """Shard count of a corpus mesh (1 for the ``None`` single pack)."""
    return 1 if mesh is None else int(mesh.size)


def pad_corpora(gas: Sequence[GrammarArrays], multiple: int
                ) -> Tuple[List[GrammarArrays], int]:
    """Pad ``gas`` to a length divisible by ``multiple`` by repeating the
    smallest grammar (by rule count): no padded dim grows, and the padding
    rows are the cheapest any shard could traverse.  Returns
    ``(padded_list, n_real)``."""
    gas = list(gas)
    if not gas:
        raise ValueError("pad_corpora needs at least one corpus")
    if multiple < 1:
        raise ValueError("multiple must be >= 1")
    n_real = len(gas)
    if n_real % multiple:
        pad = min(gas, key=lambda ga: ga.num_rules)
        gas.extend([pad] * (multiple - n_real % multiple))
    return gas, n_real


def shard_batch(gas: Sequence[GrammarArrays],
                mesh: Optional[CorpusMesh] = None, bucket: bool = True,
                epochs: Optional[Sequence[int]] = None,
                device=None) -> GrammarBatch:
    """Pack ``gas`` and shard the pack row-wise across ``mesh``.

    ``mesh=None`` takes :func:`corpus_mesh` over the visible cards; if
    that is ``None`` too (one card) the result is the plain pack on
    ``device`` (the card unless ``"cpu"``).  N is padded to a mesh
    multiple (:func:`pad_corpora`), packed on the host and cut into one
    sub-pack per mesh device.  ``epochs`` (one per corpus) stamps the pack
    for the staleness guard; padding rows inherit the epoch of the real
    grammar they repeat."""
    gas = list(gas)
    if epochs is not None and len(epochs) != len(gas):
        raise ValueError(f"epochs stamps {len(epochs)} corpora but "
                         f"{len(gas)} were passed")
    if mesh is None:
        mesh = corpus_mesh()
    if mesh is None:
        return GrammarBatch.build(gas, bucket=bucket, device=device,
                                  epochs=epochs)
    padded, n_real = pad_corpora(gas, mesh_size(mesh))
    if epochs is not None:
        # padding repeats a grammar object from gas: match by identity
        epochs = tuple(epochs) + tuple(
            next(e for g, e in zip(gas, epochs) if g is pad)
            for pad in padded[n_real:])
    gb = GrammarBatch.build(padded, bucket=bucket, device="cpu",
                            epochs=epochs)
    return gb.shard(mesh, n_real=n_real)


def run_sharded(gas: Sequence[GrammarArrays], kind: str,
                mesh: Optional[CorpusMesh] = None, method: str = "frontier",
                backend: str = "torch", l: int = 3, bucket: bool = True,
                terms=None, k: int = 10, predicate=None, agg=None,
                device=None) -> List:
    """One-call sharded analytics: pad, pack, shard, run, unpad.

    Results align with ``gas`` and are bit-identical to ``run_batched`` on
    one pack.  Besides the six analytics this serves the retrieval kinds
    (``search_bm25`` / ``search_tfidf``, by ``terms`` / ``k``) through
    :func:`repro_torch.search.engine.batched_search` and the query kinds
    (``filter_count`` / ``agg_terms`` / ``phrase_count``, by ``predicate``
    / ``terms`` / ``agg``) through
    :func:`repro_torch.query.engine.run_batched_query`.  This re-packs per
    call; recurring traffic keeps the pack (:func:`shard_batch`, or the
    serving layer's pack cache)."""
    gb = shard_batch(gas, mesh=mesh, bucket=bucket, device=device)
    if kind in ("search_bm25", "search_tfidf"):
        # lazy import: repro_torch.search sits above this module
        from repro_torch.search.engine import batched_search
        from repro_torch.search.scoring import KIND_SCHEME
        return batched_search(gb, terms, k=k, scheme=KIND_SCHEME[kind],
                              method=method)
    if kind in ("filter_count", "agg_terms", "phrase_count"):
        # lazy import: repro_torch.query sits above this module
        from repro_torch.query.engine import run_batched_query
        return run_batched_query(gb, kind, predicate=predicate, terms=terms,
                                 agg=agg, method=method)
    return run_batched(gb, kind, method=method, backend=backend, l=l)
