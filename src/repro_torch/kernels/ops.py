"""Dispatch wrappers for the kernels, and the engine's routing predicates.

The port of the JAX package's ``kernels/ops.py``.  Each wrapper routes by
the device of the tensors it is handed: a CPU tensor takes the plain torch
version (kernels/ref.py), a CUDA tensor launches the hand-written kernel
whatever its size — the plain version serves nothing on the card.

DESIGN — ELL vs segment_sum dispatch: the batched engine (core/batch.py)
asks ``ell_batched_use_ref`` whether a round should run on the dense
``[N, R, K]`` ELL edge plan or stay on the COO segment_sum path.  The
predicate is an occupancy model over (edge count, plan width K, batch
width N).  The constants and predicates keep the JAX package's values, so
every traversal method resolves exactly as it does there.

The tuned table (kernels/autotune.py) is consulted as the JAX package
consults its own: an ``ell_vs_seg`` entry overrides the occupancy
heuristics, and each kernel's launch shape is the tuned one merged over
the shipped default (``_blocks``).  A table miss launches exactly the
shipped shapes.  Every lookup is counted on
``repro_kernel_tuned_table_total{kind, result}``.
"""

from __future__ import annotations

import torch

from repro_torch.obs import global_registry

from . import _common, autotune, ref
from . import bincount as _bincount
from . import propagate as _propagate
from . import propagate_batched as _batched
from . import propagate_fused as _fused
from . import propagate_vector as _vector
from .bincount import weighted_bincount_cuda
from .propagate_batched import ell_propagate_batched_cuda
from .propagate import ell_row_sums_cuda
from .propagate_fused import ell_frontier_fused_cuda
from .propagate_vector import ell_propagate_vector_cuda
from .rank_files import rank_files_cuda

__all__ = [
    "weighted_bincount", "weighted_bincount_batched", "ell_row_sums",
    "ell_propagate_batched", "ell_propagate_vector", "ell_frontier_fused",
    "bincount_batch_rows", "ell_batched_use_ref", "ell_fused_use_kernel",
    "ell_vector_plan_ok", "masked_top_k", "rank_files",
]

# weighted_bincount_batched flattens [N, T] ids into N*nbins disjoint bins;
# above this flat-bin count the batch is chunked instead.
BINCOUNT_BATCH_FLAT_LIMIT = 1 << 22
# Batched ELL-plan occupancy gates (see module docstring).
ELL_BATCH_MIN_ROWS = 64
ELL_BATCH_MAX_WIDTH = 2048
ELL_BATCH_MIN_FILL = 1.0 / 256.0
# Absolute dense-plan budget (N * rows * K entries, ~1 GB of src+freq at the
# limit): the safety valve for explicit ELL requests.
ELL_PLAN_MAX_ENTRIES = 1 << 27
# The rule count above which the engines run the per-round path instead of
# the fused kernel.  This is still the TPU's number (six VMEM-resident
# [R_pad] float32 vectors, ~24 B/rule); the CUDA fused kernel keeps its
# state in device memory (60 B/rule of scratch, N * R < 2^31) and has no
# such limit, so the gate is kept only for routing parity with the JAX
# package.
ELL_FUSED_MAX_RULES = 1 << 18


# the shipped launch shapes (what a table miss launches)
_BATCHED_DEFAULTS = {"threads": _batched.DEFAULT_THREADS}
_FUSED_DEFAULTS = {"block": _fused.DEFAULT_BLOCK}
_VECTOR_DEFAULTS = {"warps": _vector.DEFAULT_WARPS}
_BINCOUNT_DEFAULTS = {"threads": _bincount.DEFAULT_THREADS}
_ROW_SUMS_DEFAULTS = {"threads": _propagate.DEFAULT_THREADS}

_CHILDREN = {}


def _count(family: str, help_: str, labelnames, values) -> None:
    """Add one to a labelled counter of the process registry (the child is
    looked up once per label values and kept)."""
    key = (family,) + tuple(values)
    child = _CHILDREN.get(key)
    if child is None:
        child = global_registry().counter(family, help_,
                                          labelnames).labels(*values)
        _CHILDREN[key] = child
    child.inc()


def _count_dispatch(decision: str, path: str) -> None:
    """Meter one dispatch decision."""
    _count("repro_kernel_dispatch_total",
           "kernel dispatch decisions at plan/call time",
           ("decision", "path"), (decision, path))


def _count_tuned(kind: str, result: str) -> None:
    """Meter one tuned-table lookup (``hit`` / ``miss``) per kind."""
    _count("repro_kernel_tuned_table_total",
           "autotune tuned-table lookups by result", ("kind", "result"),
           (kind, result))


def _blocks(kind: str, dims, defaults: dict, dev: torch.device) -> dict:
    """The launch shape of one call: the tuned shape of ``(card, kind,
    shape_bucket(*dims))`` merged over the shipped ``defaults`` (unknown
    keys dropped; the wrapper checks the values before it launches).  An
    empty table costs one lookup of it: no key is built."""
    tuned = (autotune.tuned_blocks(kind, autotune.shape_bucket(*dims),
                                   backend=autotune.backend_name(dev))
             if autotune.load_table() else {})
    _count_tuned(kind, "hit" if tuned else "miss")
    if not tuned:
        return defaults
    merged = dict(defaults)
    for key, val in tuned.items():
        if key in merged:
            merged[key] = val
    return merged


def _exec_path(t: torch.Tensor) -> str:
    return "cuda" if _common.on_cuda(t) else "plain"


def bincount_batch_rows(n: int, nbins: int) -> int:
    """Rows per flattened chunk for weighted_bincount_batched: ``n`` while
    n*nbins stays under BINCOUNT_BATCH_FLAT_LIMIT, else the largest row
    count whose flat bin range fits (>= 1)."""
    if n * nbins <= BINCOUNT_BATCH_FLAT_LIMIT:
        return n
    return max(1, BINCOUNT_BATCH_FLAT_LIMIT // nbins)


def ell_batched_use_ref(num_edges: int, n: int, rows: int, k: int,
                        shards: int = 1) -> bool:
    """True when a batched propagation round should stay on segment_sum:
    tiny batches, very wide plans (K beyond ELL_BATCH_MAX_WIDTH) and plans
    so sparse that the K-padded gather does >256x the real edge work.

    ``shards`` > 1 judges the launch-overhead gate per shard: a sharded
    pack runs each shard's N / shards rows on its own card, so that is the
    width a launch must amortize; fill is a ratio and shard-invariant.  A
    tuned ``ell_vs_seg`` entry for the per-shard bucket (both engine paths
    timed on this machine, autotune.tune_ell_vs_seg) overrides all of the
    static heuristics."""
    shards = max(int(shards), 1)
    tuned = autotune.tuned_use_ref(
        "ell_vs_seg", autotune.shape_bucket(max(n // shards, 1), rows, k))
    if tuned is not None:
        _count_tuned("ell_vs_seg", "hit")
        use_ref = tuned
    else:
        _count_tuned("ell_vs_seg", "miss")
        use_ref = ((n // shards) * rows < ELL_BATCH_MIN_ROWS
                   or k > ELL_BATCH_MAX_WIDTH
                   or num_edges / max(n * rows * k, 1) < ELL_BATCH_MIN_FILL)
    _count_dispatch("ell_vs_seg", "segment_sum" if use_ref else "ell")
    return use_ref


def ell_fused_use_kernel(rows: int) -> bool:
    """True when the fused multi-round traversal is routed to (see
    ELL_FUSED_MAX_RULES); engines that get False run the per-round path."""
    fused = rows <= ELL_FUSED_MAX_RULES
    _count_dispatch("fused_vs_per_round", "fused" if fused else "per_round")
    return fused


def ell_vector_plan_ok(n: int, rows: int, k: int, f: int) -> bool:
    """True when the vector-payload [N, rows, K] x [R, F] round fits the
    dense-plan budget (its plain version materializes N*rows*K*F
    contributions)."""
    return n * rows * k * max(f, 1) <= ELL_PLAN_MAX_ENTRIES


def _histogram_inputs(ids: torch.Tensor, vals: torch.Tensor):
    """ids (int32 or int64) and float32 values as the kernel takes them,
    converted only where they are not already (each conversion is a
    launch)."""
    if ids.dtype not in (torch.int32, torch.int64):
        ids = ids.to(torch.int32)
    if vals.dtype is not torch.float32:
        vals = vals.to(torch.float32)
    if not ids.is_contiguous():
        ids = ids.contiguous()
    if not vals.is_contiguous():
        vals = vals.contiguous()
    return ids, vals


def weighted_bincount(ids: torch.Tensor, vals: torch.Tensor,
                      nbins: int) -> torch.Tensor:
    """Histogram: out[b] = sum(vals[ids == b]); ids outside [0, nbins)
    ignored.  CUDA tensors run the kernel (see bincount.py)."""
    if ids.ndim != 1 or vals.shape != ids.shape:
        raise ValueError(f"expected matching [n] inputs, got "
                         f"{tuple(ids.shape)} / {tuple(vals.shape)}")
    if ids.shape[0] == 0:
        return torch.zeros(nbins, dtype=torch.float32, device=ids.device)
    if not _common.on_cuda(ids):
        return ref.weighted_bincount_ref(ids, vals, nbins)
    return weighted_bincount_cuda(*_histogram_inputs(ids, vals), nbins,
                                  **_bincount_blocks(ids, nbins))


def _bincount_blocks(ids: torch.Tensor, nbins: int) -> dict:
    return _blocks("bincount", autotune.bincount_dims(ids, nbins),
                   _BINCOUNT_DEFAULTS, ids.device)


def weighted_bincount_batched(ids: torch.Tensor, vals: torch.Tensor,
                              nbins: int) -> torch.Tensor:
    """Batched histogram: out[i, b] = sum(vals[i][ids[i] == b]); ids
    outside ``[0, nbins)`` are padding.

    CUDA tensors make one kernel launch per row chunk, each writing its
    rows of one output (the kernel has a batch axis); the JAX package
    instead offsets row i's ids into the flat bin range ``[i * nbins,
    (i+1) * nbins)`` and histograms the flattened stream.  The row chunks
    of ``bincount_batch_rows(n, nbins)`` are kept on both paths for parity
    with it.
    """
    if ids.ndim != 2 or vals.shape != ids.shape:
        raise ValueError(f"expected matching [N, T] inputs, got "
                         f"{tuple(ids.shape)} / {tuple(vals.shape)}")
    n, t = ids.shape
    if n == 0 or t == 0:
        return torch.zeros((n, nbins), dtype=torch.float32,
                           device=ids.device)
    rows = bincount_batch_rows(n, nbins)
    if not _common.on_cuda(ids):
        return torch.cat([ref.weighted_bincount_ref(ids[s: s + rows],
                                                    vals[s: s + rows], nbins)
                          for s in range(0, n, rows)], dim=0)
    ids, vals = _histogram_inputs(ids, vals)
    if rows >= n:
        return weighted_bincount_cuda(ids, vals, nbins,
                                      **_bincount_blocks(ids, nbins))
    out = torch.empty((n, nbins), dtype=torch.float32, device=ids.device)
    for s in range(0, n, rows):
        weighted_bincount_cuda(ids[s: s + rows], vals[s: s + rows], nbins,
                               out=out[s: s + rows],
                               **_bincount_blocks(ids[s: s + rows], nbins))
    return out


def ell_row_sums(weights: torch.Tensor, src: torch.Tensor,
                 freq: torch.Tensor) -> torch.Tensor:
    """ELL gather row sums over a [rows, W] plan: ``out[r] = sum_k
    freq[r, k] * weights[src[r, k]]`` (semantics in propagate.py).

    CUDA tensors run the kernel whatever the size: the JAX package's
    ``ell_use_ref`` row floor only kept tiny inputs off a TPU kernel."""
    if weights.ndim != 1 or src.ndim != 2 or freq.shape != src.shape:
        raise ValueError(f"expected [R] weights and matching [rows, W] "
                         f"plans, got {tuple(weights.shape)} / "
                         f"{tuple(src.shape)} / {tuple(freq.shape)}")
    if src.shape[0] == 0:
        return torch.zeros(0, dtype=torch.float32, device=src.device)
    _count_dispatch("exec:ell_row_sums", _exec_path(src))
    if not _common.on_cuda(src):
        return ref.ell_row_sums_ref(weights, src, freq)
    blocks = _blocks("row_sums", src.shape, _ROW_SUMS_DEFAULTS, src.device)
    return ell_row_sums_cuda(weights.to(torch.float32).contiguous(),
                             src.to(torch.int32).contiguous(),
                             freq.to(torch.float32).contiguous(), **blocks)


def _check_plan(src: torch.Tensor, freq: torch.Tensor) -> None:
    if src.ndim != 3 or freq.shape != src.shape:
        raise ValueError(f"expected matching [N, rows, K] plans, got "
                         f"{tuple(src.shape)} / {tuple(freq.shape)}")


def ell_propagate_batched(weights: torch.Tensor, active: torch.Tensor,
                          src: torch.Tensor, freq: torch.Tensor):
    """One round over the dense [N, rows, K] ELL plan: ``(delta, seen)``,
    both [N, rows] float32 (semantics in propagate_batched.py)."""
    _check_plan(src, freq)
    n, rows, k = src.shape
    if n == 0 or rows == 0 or k == 0:
        z = torch.zeros((n, rows), dtype=torch.float32, device=src.device)
        return z, z.clone()
    _count_dispatch("exec:ell_batched", _exec_path(src))
    if not _common.on_cuda(src):
        return ref.ell_propagate_batched_ref(weights, active, src, freq)
    blocks = _blocks("ell_batched", (n, rows, k), _BATCHED_DEFAULTS,
                     src.device)
    return ell_propagate_batched_cuda(weights, active, src, freq, **blocks)


def ell_propagate_vector(W: torch.Tensor, active: torch.Tensor,
                         src: torch.Tensor, freq: torch.Tensor):
    """One vector-payload round over the [N, rows, K] plan: ``(delta
    [N, rows, F], seen [N, rows])`` (semantics in propagate_vector.py)."""
    _check_plan(src, freq)
    if W.ndim != 3:
        raise ValueError(f"expected [N, R, F] payload, got {tuple(W.shape)}")
    n, rows, k = src.shape
    if n == 0 or rows == 0 or k == 0 or W.shape[-1] == 0:
        return (torch.zeros((n, rows, W.shape[-1]), dtype=torch.float32,
                            device=src.device),
                torch.zeros((n, rows), dtype=torch.float32,
                            device=src.device))
    _count_dispatch("exec:ell_vector", _exec_path(src))
    if not _common.on_cuda(src):
        return ref.ell_propagate_vector_ref(W, active, src, freq)
    blocks = _blocks("ell_vector", (n, rows, k, W.shape[-1]),
                     _VECTOR_DEFAULTS, src.device)
    return ell_propagate_vector_cuda(W, active, src, freq, **blocks)


def ell_frontier_fused(weights0: torch.Tensor, in_deg: torch.Tensor,
                       src: torch.Tensor, freq: torch.Tensor,
                       max_rounds: int, with_rounds: bool = False):
    """The whole frontier traversal in one dispatch (propagate_fused.py).

    weights0/in_deg: [N, R]; src/freq: [N, R, K]; ``max_rounds`` must bound
    the round count (the DAG's ``num_levels`` is exact).  Returns weights
    [N, R] — or ``(weights, rounds [N])`` when ``with_rounds``.  Callers
    pre-gate with ``ell_fused_use_kernel(R)`` for routing parity.
    """
    _check_plan(src, freq)
    n, rows, k = src.shape
    if n == 0 or rows == 0 or k == 0:
        w = weights0.to(torch.float32)
        rounds = torch.zeros(n, dtype=torch.int32, device=src.device)
        return (w, rounds) if with_rounds else w
    _count_dispatch("exec:ell_fused", _exec_path(src))
    if not _common.on_cuda(src):
        w, rounds = ref.ell_frontier_fused_ref(weights0, in_deg, src, freq,
                                               max_rounds)
    else:
        blocks = _blocks("ell_fused", (n, rows, k, max_rounds),
                         _FUSED_DEFAULTS, src.device)
        w, rounds = ell_frontier_fused_cuda(weights0, in_deg, src, freq,
                                            max_rounds, **blocks)
    return (w, rounds) if with_rounds else w


def rank_files(tv: torch.Tensor, num_files, vocab_size):
    """Each word's files ranked by count: per corpus i, ``(ranking
    [vocab_size[i], num_files[i]] int32, counts aligned to it)`` of the
    word-major term vector ``tv [N, V_pad, F_pad]`` (counts descending,
    ties to the lower file id, files past ``num_files[i]`` left out).

    A CUDA tensor launches the kernel (one launch for the pack, any
    ``F_pad``, contiguous outputs), a CPU tensor takes the plain version.
    Each call is metered on ``repro_kernel_dispatch_total
    {decision="rank_files", path="kernel" | "plain"}``."""
    if tv.ndim != 3:
        raise ValueError(f"expected an [N, V_pad, F_pad] term vector, got "
                         f"{tuple(tv.shape)}")
    if not _common.on_cuda(tv):
        _count_dispatch("rank_files", "plain")
        return ref.rank_files_ref(tv, num_files, vocab_size)
    _count_dispatch("rank_files", "kernel")
    return rank_files_cuda(tv.to(torch.float32).contiguous(), num_files,
                           vocab_size)


def masked_top_k(scores: torch.Tensor, valid: torch.Tensor, k: int):
    """Top-k over the trailing axis with invalid slots masked out.

    The search subsystem's ranking primitive (the JAX package's
    ``masked_top_k``, which is ``jax.lax.top_k`` and no Pallas kernel):
    ``scores [..., M]`` and a ``valid`` mask of the same shape; masked
    slots become ``-inf`` so any finite real score outranks them.  Returns
    ``(values, indices int32)`` of the ``k`` largest per row, values
    descending, equal values toward the LOWER index — ``lax.top_k``'s
    tie-break, the deterministic file-id order the retrieval layer
    promises.  ``torch.topk`` promises no order among equal values, so this
    is a stable descending sort cut to ``k``: plain torch on every device.
    """
    k = int(k)
    if k < 1:
        raise ValueError(f"masked_top_k needs k >= 1, got {k}")
    if k > scores.shape[-1]:
        raise ValueError(f"k={k} exceeds the candidate axis "
                         f"({scores.shape[-1]})")
    masked = torch.where(valid, scores, float("-inf"))
    vals, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)
