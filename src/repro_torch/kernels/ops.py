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
every traversal method resolves exactly as it does there.  The tuned table
(kernels/autotune.py there) is not part of the port yet: every lookup
behaves as a miss and the static heuristics decide.
"""

from __future__ import annotations

import torch

from repro_torch.obs import global_registry

from . import _common, ref
from .bincount import weighted_bincount_cuda
from .propagate_batched import ell_propagate_batched_cuda
from .propagate import ell_row_sums_cuda
from .propagate_fused import ell_frontier_fused_cuda
from .propagate_vector import ell_propagate_vector_cuda

__all__ = [
    "weighted_bincount", "weighted_bincount_batched", "ell_row_sums",
    "ell_propagate_batched", "ell_propagate_vector", "ell_frontier_fused",
    "bincount_batch_rows", "ell_batched_use_ref", "ell_fused_use_kernel",
    "ell_vector_plan_ok", "masked_top_k",
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


_DISPATCH = {}


def _count_dispatch(decision: str, path: str) -> None:
    """Meter one dispatch decision on the process registry (the labelled
    child is looked up once per (decision, path) and kept)."""
    child = _DISPATCH.get((decision, path))
    if child is None:
        child = global_registry().counter(
            "repro_kernel_dispatch_total",
            "kernel dispatch decisions at plan/call time",
            ("decision", "path")).labels(decision, path)
        _DISPATCH[(decision, path)] = child
    child.inc()


def _exec_path(t: torch.Tensor) -> str:
    return "cuda" if _common.on_cuda(t) else "plain"


def bincount_batch_rows(n: int, nbins: int) -> int:
    """Rows per flattened chunk for weighted_bincount_batched: ``n`` while
    n*nbins stays under BINCOUNT_BATCH_FLAT_LIMIT, else the largest row
    count whose flat bin range fits (>= 1)."""
    if n * nbins <= BINCOUNT_BATCH_FLAT_LIMIT:
        return n
    return max(1, BINCOUNT_BATCH_FLAT_LIMIT // nbins)


def ell_batched_use_ref(num_edges: int, n: int, rows: int, k: int) -> bool:
    """True when a batched propagation round should stay on segment_sum:
    tiny batches, very wide plans (K beyond ELL_BATCH_MAX_WIDTH) and plans
    so sparse that the K-padded gather does >256x the real edge work."""
    use_ref = (n * rows < ELL_BATCH_MIN_ROWS
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
    return weighted_bincount_cuda(*_histogram_inputs(ids, vals), nbins)


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
        return weighted_bincount_cuda(ids, vals, nbins)
    out = torch.empty((n, nbins), dtype=torch.float32, device=ids.device)
    for s in range(0, n, rows):
        weighted_bincount_cuda(ids[s: s + rows], vals[s: s + rows], nbins,
                               out=out[s: s + rows])
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
    return ell_row_sums_cuda(weights.to(torch.float32).contiguous(),
                             src.to(torch.int32).contiguous(),
                             freq.to(torch.float32).contiguous())


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
    return ell_propagate_batched_cuda(weights, active, src, freq)


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
    return ell_propagate_vector_cuda(W, active, src, freq)


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
        w, rounds = ell_frontier_fused_cuda(weights0, in_deg, src, freq,
                                            max_rounds)
    return (w, rounds) if with_rounds else w


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
