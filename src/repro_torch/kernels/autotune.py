"""Launch-shape autotuner for the CUDA kernels, and the ELL-vs-segment_sum
routing table.

The port of the JAX package's ``kernels/autotune.py``.  The kernels ship
with fixed launch shapes (threads, warps or block size a kernel) and the
dispatch predicates in ops.py with static heuristics.  This module
measures the card instead:

* ``tune_ell_batched`` / ``tune_ell_fused`` / ``tune_ell_vector`` /
  ``tune_row_sums`` / ``tune_bincount`` launch each kernel at every
  candidate shape on real inputs, hold every candidate's output to the
  kernel's plain version (exactly: the sweeps take engine inputs, whose
  values are integer-valued float32, where every launch shape is exact),
  time the candidates on the card and record the winner;
  ``tune_ell_vs_seg`` times a pack's two engine paths (``frontier`` on
  segment_sum, ``frontier_ell`` on kernel 1) and records the routing;
* winners persist in a small JSON table keyed ``(backend, kind,
  shape-bucket)`` — the backend names the card
  (``torch.cuda.get_device_name``) or ``cpu``; the buckets are the pow2
  rounding of the packing layer, so one run covers every pack of the same
  padded shape;
* ops.py consults the table (``tuned_use_ref`` / ``tuned_blocks``) and
  falls back to the shipped shapes and heuristics on a miss — a missing or
  corrupt table launches exactly what launches without one, and no entry
  can change an answer, only a launch shape or a route.

The table is the JAX package's file format at the same path
(``AUTOTUNE_cache.json`` unless ``REPRO_AUTOTUNE_CACHE`` points
elsewhere): on the CPU both packages key their ``ell_vs_seg`` routes
``cpu|ell_vs_seg|...`` and read each other's.

Unlike the JAX package's sweeps, the plain version is not a candidate: a
plain version never serves a tensor on the card, so the sweeps refuse CPU
tensors.  Candidates are timed on the device only: a spin kernel
(``torch.cuda._sleep``) holds the card while the host enqueues the calls
between two CUDA events, so the host's launch cost does not count.  The
JAX package's ``sweep_xla_flags`` has no CUDA counterpart (there are no
XLA flags).  :func:`hlo_profile` counts an eager run with
``utils/hlo_analysis.py`` where the JAX package reads compiled HLO.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from . import ref
from ._common import resolve_device, round_up_pow2

CACHE_ENV = "REPRO_AUTOTUNE_CACHE"
DEFAULT_CACHE_PATH = "AUTOTUNE_cache.json"
CACHE_VERSION = 1

# Opt-in profiler annotations: when this env var is set (non-empty, not
# "0"), every timed candidate runs inside a named
# ``torch.profiler.record_function`` range, so a captured trace attributes
# kernel time to the sweep candidate that launched it.
ANNOTATE_ENV = "REPRO_PROFILE_ANNOTATIONS"


def annotations_enabled() -> bool:
    return os.environ.get(ANNOTATE_ENV, "") not in ("", "0")


def trace_annotation(name: str) -> contextlib.AbstractContextManager:
    """A context manager naming the enclosed work in profiler traces; a
    free ``nullcontext`` unless ``REPRO_PROFILE_ANNOTATIONS`` is set."""
    if not annotations_enabled():
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


_BACKENDS: Dict[int, str] = {}


def backend_name(device=None) -> str:
    """The backend part of a table key: the card's name for a CUDA device
    (``None``: the current card, or ``cpu`` without one), else ``cpu``."""
    if device is None:
        if not torch.cuda.is_available():
            return "cpu"
        device = torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    name = _BACKENDS.get(idx)
    if name is None:
        name = _BACKENDS[idx] = torch.cuda.get_device_name(idx)
    return name


def shape_bucket(*dims: int) -> Tuple[int, ...]:
    """Pow2-bucketed shape key — the rounding the packing layer uses, so
    every pack of the same padded shape shares a tuning entry."""
    return tuple(round_up_pow2(int(d)) for d in dims)


def _key(kind: str, bucket: Sequence[int], backend: Optional[str]) -> str:
    b = backend if backend is not None else backend_name()
    return "|".join([b, kind, "x".join(str(int(d)) for d in bucket)])


# ----------------------------------------------------------------------- #
# The persistent table                                                     #
# ----------------------------------------------------------------------- #
def cache_path() -> str:
    return os.environ.get(CACHE_ENV) or DEFAULT_CACHE_PATH


_TABLE: Optional[Dict[str, Any]] = None
_TABLE_PATH: Optional[str] = None
_TABLE_LOCK = threading.Lock()


def load_table(path: Optional[str] = None) -> Dict[str, Any]:
    """Load (and memoize) the tuned table; a missing or corrupt file is an
    empty table — the autotuner can only ever change launch shapes."""
    global _TABLE, _TABLE_PATH
    p = path or cache_path()
    table = _TABLE
    if table is not None and _TABLE_PATH == p:
        return table                    # every launch looks here: no lock
    with _TABLE_LOCK:
        if _TABLE is not None and _TABLE_PATH == p:
            return _TABLE
        table = {}
        try:
            with open(p) as f:
                data = json.load(f)
            if (isinstance(data, dict)
                    and data.get("version") == CACHE_VERSION):
                table = dict(data.get("entries", {}))
        except (OSError, ValueError):
            table = {}
        _TABLE, _TABLE_PATH = table, p
        return table


def save_table(path: Optional[str] = None) -> str:
    p = path or cache_path()
    table = load_table(p)
    with open(p, "w") as f:
        json.dump({"version": CACHE_VERSION, "entries": table}, f,
                  indent=1, sort_keys=True)
    return p


def reset_table() -> None:
    """Drop the in-memory table memo (the next lookup re-reads the file)."""
    global _TABLE, _TABLE_PATH
    with _TABLE_LOCK:
        _TABLE, _TABLE_PATH = None, None


def put_entry(kind: str, bucket: Sequence[int], entry: Dict[str, Any],
              backend: Optional[str] = None) -> None:
    load_table()[_key(kind, bucket, backend)] = entry


def get_entry(kind: str, bucket: Sequence[int],
              backend: Optional[str] = None) -> Optional[Dict[str, Any]]:
    table = load_table()
    if not table:
        return None
    return table.get(_key(kind, bucket, backend))


def tuned_use_ref(kind: str, bucket: Sequence[int],
                  backend: Optional[str] = None) -> Optional[bool]:
    """Tuned routing (True: segment_sum); None on a table miss (callers
    fall back to the static heuristics in ops.py)."""
    e = get_entry(kind, bucket, backend)
    if e is None or "use_ref" not in e:
        return None
    return bool(e["use_ref"])


def tuned_blocks(kind: str, bucket: Sequence[int],
                 backend: Optional[str] = None) -> Dict[str, int]:
    """Tuned launch shape ({} on a miss; callers merge over defaults)."""
    e = get_entry(kind, bucket, backend)
    if e is None:
        return {}
    return {k: int(v) for k, v in e.get("blocks", {}).items()}


# ----------------------------------------------------------------------- #
# Timing on the card                                                       #
# ----------------------------------------------------------------------- #
# SM clock cycles a millisecond of the spin kernel takes at most (the
# H100's boost clock is 1.98 GHz): a lower clock only spins longer.
_CYCLES_PER_MS = 2_000_000


def _device_ms(fn: Callable[[], Any], dev: torch.device, reps: int,
               name: str) -> float:
    """Device time of one ``fn()`` call, in ms: a spin kernel holds the
    card while the host enqueues ``reps`` calls between two events, so the
    events bracket the calls' device work back to back.  The spin is
    lengthened until the host finished enqueueing well inside it."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spin_ms = 2.0
    with torch.cuda.device(dev), trace_annotation(name):
        for _ in range(6):
            torch.cuda.synchronize(dev)
            torch.cuda._sleep(int(spin_ms * _CYCLES_PER_MS))
            t0 = time.perf_counter()
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            host_ms = (time.perf_counter() - t0) * 1e3
            end.synchronize()
            if host_ms < 0.5 * spin_ms:
                return start.elapsed_time(end) / reps
            spin_ms = 4.0 * host_ms
    raise RuntimeError(f"{name}: the host could not enqueue {reps} calls "
                       f"inside a {spin_ms:.1f} ms spin")


def _wall_ms(fn: Callable[[], Any], dev: torch.device, name: str) -> float:
    """Time of one ``fn()`` call between two CUDA events (host work and
    its syncs included), in ms."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(dev), trace_annotation(name):
        torch.cuda.synchronize(dev)
        start.record()
        fn()
        end.record()
        end.synchronize()
    return start.elapsed_time(end)


def _median(xs: List[float]) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _require_cuda(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"the sweeps time the kernels on one card; got tensors on "
                f"{sorted({str(x.device) for x in tensors})}")
    return dev


def _as_tuple(out) -> Tuple[torch.Tensor, ...]:
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _sweep(kind: str, bucket: Tuple[int, ...], param: str,
           candidates: Sequence[int], default: int,
           launch: Callable[[int], Any], plain, dev: torch.device,
           repeat: int, reps: int, save: bool) -> Dict[str, Any]:
    """Launch, check and time every candidate shape of one kernel; record
    the winner under ``(backend of dev, kind, bucket)``.

    Each candidate's output must equal ``plain`` (the plain version's, on
    the same inputs) bit for bit before its time counts; a disagreeing
    candidate raises.  Candidates are timed in turns, ``repeat`` rounds of
    ``reps`` calls each, and the median a call decides."""
    shapes = [default] + [c for c in candidates if c != default]
    names = {c: "default" if c == default else f"{param}{c}"
             for c in shapes}
    want = _as_tuple(plain)
    for c in shapes:
        got = _as_tuple(launch(c))
        if len(got) != len(want) or not all(
                g.shape == w.shape and torch.equal(g, w.to(g.dtype))
                for g, w in zip(got, want)):
            raise ValueError(f"{kind}: launch shape {param}={c} disagrees "
                             f"with the plain version")
    times: Dict[int, List[float]] = {c: [] for c in shapes}
    for r in range(repeat):
        for c in shapes:
            times[c].append(_device_ms(lambda c=c: launch(c), dev, reps,
                                       f"autotune:{kind}:{names[c]}"))
    ms = {c: _median(ts) for c, ts in times.items()}
    best = min(shapes, key=lambda c: ms[c])
    entry = {
        "winner": names[best],
        "blocks": {param: best},
        "use_ref": False,
        "us": ms[best] * 1e3,
        "default_us": ms[default] * 1e3,
        "table_us": {names[c]: ms[c] * 1e3 for c in shapes},
    }
    put_entry(kind, bucket, entry, backend=backend_name(dev))
    if save:
        save_table()
    return entry


# ----------------------------------------------------------------------- #
# The sweeps                                                               #
# ----------------------------------------------------------------------- #
def tune_ell_batched(weights, active, src, freq,
                     threads: Optional[Sequence[int]] = None,
                     repeat: int = 5, reps: int = 20,
                     save: bool = False) -> Dict[str, Any]:
    """Sweep kernel 1's threads a block on a real plan; record the
    winner (kind ``ell_batched``, bucket (N, rows, K))."""
    from .propagate_batched import (DEFAULT_THREADS, THREADS_CANDIDATES,
                                    ell_propagate_batched_cuda)
    dev = _require_cuda(weights, active, src, freq)
    n, rows, k = src.shape
    return _sweep(
        "ell_batched", shape_bucket(n, rows, k), "threads",
        threads or THREADS_CANDIDATES, DEFAULT_THREADS,
        lambda t: ell_propagate_batched_cuda(weights, active, src, freq,
                                             threads=t),
        ref.ell_propagate_batched_ref(weights, active, src, freq), dev,
        repeat, reps, save)


def tune_ell_fused(weights0, in_deg, src, freq, max_rounds: int,
                   blocks: Optional[Sequence[int]] = None,
                   repeat: int = 5, reps: int = 20,
                   save: bool = False) -> Dict[str, Any]:
    """Sweep kernel 2's threads a block (its cooperative grid is sized by
    the occupancy API for each); kind ``ell_fused``, bucket (N, R, K,
    max_rounds)."""
    from .propagate_fused import (BLOCK_CANDIDATES, DEFAULT_BLOCK,
                                  ell_frontier_fused_cuda)
    dev = _require_cuda(weights0, in_deg, src, freq)
    n, rows, k = src.shape
    return _sweep(
        "ell_fused", shape_bucket(n, rows, k, max_rounds), "block",
        blocks or BLOCK_CANDIDATES, DEFAULT_BLOCK,
        lambda b: ell_frontier_fused_cuda(weights0, in_deg, src, freq,
                                          max_rounds, block=b),
        ref.ell_frontier_fused_ref(weights0, in_deg, src, freq, max_rounds),
        dev, repeat, reps, save)


def tune_ell_vector(W, active, src, freq,
                    warps: Optional[Sequence[int]] = None,
                    repeat: int = 5, reps: int = 20,
                    save: bool = False) -> Dict[str, Any]:
    """Sweep kernel 3's warps a block; kind ``ell_vector``, bucket (N,
    rows, K, F)."""
    from .propagate_vector import (DEFAULT_WARPS, WARPS_CANDIDATES,
                                   ell_propagate_vector_cuda)
    dev = _require_cuda(W, active, src, freq)
    n, rows, k = src.shape
    return _sweep(
        "ell_vector", shape_bucket(n, rows, k, W.shape[-1]), "warps",
        warps or WARPS_CANDIDATES, DEFAULT_WARPS,
        lambda w: ell_propagate_vector_cuda(W, active, src, freq, warps=w),
        ref.ell_propagate_vector_ref(W, active, src, freq), dev, repeat,
        reps, save)


def tune_row_sums(weights, src, freq,
                  threads: Optional[Sequence[int]] = None,
                  repeat: int = 5, reps: int = 20,
                  save: bool = False) -> Dict[str, Any]:
    """Sweep kernel 5's threads a block; kind ``row_sums``, bucket (rows,
    W)."""
    from .propagate import (DEFAULT_THREADS, THREADS_CANDIDATES,
                            ell_row_sums_cuda)
    dev = _require_cuda(weights, src, freq)
    rows, k = src.shape
    return _sweep(
        "row_sums", shape_bucket(rows, k), "threads",
        threads or THREADS_CANDIDATES, DEFAULT_THREADS,
        lambda t: ell_row_sums_cuda(weights, src, freq, threads=t),
        ref.ell_row_sums_ref(weights, src, freq), dev, repeat, reps, save)


def bincount_dims(ids: torch.Tensor, nbins: int) -> Tuple[int, int, int]:
    """The dims a histogram call is bucketed by: (rows, T, nbins), a 1-D
    call being one row."""
    rows, t = (1, ids.shape[0]) if ids.ndim == 1 else ids.shape
    return rows, t, nbins


def tune_bincount(ids, vals, nbins: int,
                  threads: Optional[Sequence[int]] = None,
                  repeat: int = 5, reps: int = 20,
                  save: bool = False) -> Dict[str, Any]:
    """Sweep kernel 4's threads a block on ``[T]`` or ``[rows, T]`` ids;
    kind ``bincount``, bucket (rows, T, nbins)."""
    from .bincount import (DEFAULT_THREADS, THREADS_CANDIDATES,
                           weighted_bincount_cuda)
    dev = _require_cuda(ids, vals)
    plain = ref.weighted_bincount_ref(ids, vals, nbins)
    return _sweep(
        "bincount", shape_bucket(*bincount_dims(ids, nbins)), "threads",
        threads or THREADS_CANDIDATES, DEFAULT_THREADS,
        lambda t: weighted_bincount_cuda(ids, vals, nbins, threads=t),
        plain, dev, repeat, reps, save)


def tune_ell_vs_seg(gb, repeat: int = 3, save: bool = False
                    ) -> Dict[str, Any]:
    """Time a pack's two engine paths for the scalar traversal —
    ``frontier`` (segment_sum) and ``frontier_ell`` (kernel 1 a round) —
    and record the faster as the ``ell_vs_seg`` route for the pack's
    per-shard bucket (N / shards, R_pad, K): the entry
    ``kernels.ops.ell_batched_use_ref`` consults.  Both paths must give
    the same weights.  What the JAX package's benchmark seeds from its
    traversal timings."""
    from repro_torch.core.batch import (batched_top_down_weights,
                                        resolve_batch_method)
    if gb.device.type != "cuda":
        raise ValueError(f"the sweeps time the engine on a card; the pack "
                         f"is on {gb.device}")
    if resolve_batch_method(gb, "frontier_ell") != "frontier_ell":
        raise ValueError("the pack's dense ELL plan is ineligible "
                         "(frontier_ell falls back to frontier)")
    seg = batched_top_down_weights(gb, "frontier")
    ell = batched_top_down_weights(gb, "frontier_ell")
    if not torch.equal(seg, ell):
        raise ValueError("frontier and frontier_ell disagree on the pack")
    t_seg, t_ell = [], []
    for _ in range(repeat):
        t_seg.append(_wall_ms(lambda: batched_top_down_weights(
            gb, "frontier"), gb.device, "autotune:ell_vs_seg:segment_sum"))
        t_ell.append(_wall_ms(lambda: batched_top_down_weights(
            gb, "frontier_ell"), gb.device, "autotune:ell_vs_seg:ell"))
    seg_ms, ell_ms = _median(t_seg), _median(t_ell)
    entry = {"winner": "segment_sum" if ell_ms > seg_ms else "ell",
             "use_ref": bool(ell_ms > seg_ms),
             "us": min(seg_ms, ell_ms) * 1e3,
             "default_us": seg_ms * 1e3,
             "table_us": {"segment_sum": seg_ms * 1e3, "ell": ell_ms * 1e3}}
    put_entry("ell_vs_seg",
              shape_bucket(max(gb.n // gb.shards, 1), gb.R_pad,
                           gb.ell_plan_width()),
              entry, backend=backend_name(gb.device))
    if save:
        save_table()
    return entry


# ----------------------------------------------------------------------- #
# Op counts (utils/hlo_analysis + launch/roofline)                         #
# ----------------------------------------------------------------------- #
def hlo_profile(fn: Callable[..., Any], *args: Any,
                device=None) -> Dict[str, Any]:
    """Run ``fn(*args)`` once, its tensor arguments on ``device`` (the
    card unless the caller asks for the CPU), and report what it does:
    the op histogram (``utils.hlo_analysis.op_histogram``), collective
    traffic, FLOPs and bytes accessed per rank, and the roofline class
    (compute- or bandwidth-bound against ``launch/roofline.py``'s H100
    ridge, ``PEAK_FLOPS / HBM_BW``)."""
    from repro_torch.launch import roofline
    from repro_torch.utils import hlo_analysis
    dev = resolve_device(device)
    args = tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                 for a in args)
    with hlo_analysis.count_ops() as rec:
        fn(*args)
    out: Dict[str, Any] = {
        "ops": hlo_analysis.op_histogram(rec),
        "collective_bytes": hlo_analysis.total_collective_bytes(rec),
        "flops": rec.flops,
        "bytes": rec.bytes,
    }
    if rec.bytes > 0:
        out["intensity"] = rec.flops / rec.bytes
        ridge = roofline.PEAK_FLOPS / roofline.HBM_BW
        out["bound"] = ("compute" if out["intensity"] >= ridge
                        else "bandwidth")
    return out
