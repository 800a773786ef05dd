"""Batched multi-corpus analytics: pack N grammars, traverse them together.

The port of the JAX package's ``core/batch.py``.  A :class:`GrammarBatch`
packs N :class:`GrammarArrays` into padded, bucketed ``[N, ...]`` tensors
on one device (the pre-planned memory pool of paper §IV-C, extended across
corpora), and every analytic runs over the whole batch at once:

* ``frontier`` — masked rounds over the COO edges, two ``index_add_``
  scatters per round (segment_sum in the JAX package); the round loop runs
  until no corpus has an active rule (finished corpora idle harmlessly);
* ``leveled`` — per-level edge segments padded to a common width across
  corpora, so each real edge is touched exactly once;
* ``frontier_ell`` / ``leveled_ell`` — the same schedules over the dense
  ELL plan (:meth:`GrammarBatch.ell_plan`), one gather kernel per round
  (kernels/propagate_batched.py, kernels/propagate_vector.py per-file);
* ``frontier_fused`` — the whole frontier loop in one kernel launch
  (kernels/propagate_fused.py);
* ``auto`` — occupancy dispatch (``resolve_traversal_method``).

DESIGN — corpus-sharded packs (:meth:`GrammarBatch.shard`, the port of the
JAX package's ``shard_map`` path): a sharded pack holds one row-slice
sub-pack per device of its mesh (``shard_packs``), with the padded dims of
the whole pack on every shard, and ``n_real`` real rows (the rest repeat a
real grammar to fill the last shard, distributed/shard_batch.py).  Every
``batched_*`` entry and ``run_batched`` resolve the traversal method once,
against the whole pack and its shard count, then run the unsharded engine
on each sub-pack on its own device and host thread
(``CorpusMesh.map``), gather the results in row order (tensors on the
pack's first device) and drop the padding rows.  Nothing crosses shards,
so each shard's round loop stops when its own corpora finish, and the
results are bit-identical to the unsharded pack's.

All six analytics (word count, sort, inverted index, term vector, sequence
count, ranked inverted index) are bit-identical to the JAX package's
``run_batched``: every traversal count is integer-valued float32 far below
2**24, so float32 arithmetic is exact in any summation order — scatters,
atomics and gathers alike.

Padding convention: padded edges carry ``freq == 0`` and are additionally
masked by ``edge_valid``; padded rule slots have ``in_deg == out_deg == 0``
(they become "ready" in round 0 with weight 0 and never contribute).
Dimensions are bucketed (rounded up to powers of two) as in the JAX
package.  The JAX package's ``vmap`` over corpora is the leading batch
dimension written out here; its ``while_loop`` is a Python loop that reads
one flag per round.  Packing and plans are host numpy; the packed arrays
live on ``device`` (the card unless the caller passes ``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from dataclasses import field as dataclass_field
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels._common import resolve_device
from repro_torch.obs import plan_stage as _plan_stage
from repro_torch.obs import traverse as _traverse

from .grammar import GrammarArrays, StaleGrammarError
from .grammar import pow2_bucket as _pow2_bucket
from .host_copy import to_host
from . import sequence as _sequence
from .sequence import _K_HEAD, _K_LIT, _K_TAIL


# ----------------------------------------------------------------------- #
# Packed layout                                                            #
# ----------------------------------------------------------------------- #
def _round_up_pow2(x: int, minimum: int = 8) -> int:
    if x <= minimum:
        return minimum
    return 1 << (int(x) - 1).bit_length()


def _pad_stack(arrs: Sequence[np.ndarray], width: int, fill=0,
               dtype=np.int64) -> np.ndarray:
    out = np.full((len(arrs), width), fill, dtype)
    for i, a in enumerate(arrs):
        out[i, : len(a)] = a
    return out


@dataclass(frozen=True, eq=False)
class GrammarBatch:
    """N grammars packed into padded ``[N, ...]`` tensors on ``device``.

    Index arrays are int64 (torch's gather/scatter index type); the ELL
    plan's ``src`` is int32, the kernels' index type."""

    gas: Tuple[GrammarArrays, ...]      # originals (host, for finalization)
    device: torch.device

    # padded dims (bucketed)
    R_pad: int
    E_pad: int
    T_pad: int
    F_pad: int
    V_pad: int
    Tf_pad: int

    # per-corpus true sizes (host)
    num_rules: np.ndarray               # [N]
    vocab_sizes: np.ndarray             # [N]
    num_files: np.ndarray               # [N]

    # packed DAG
    edge_parent: torch.Tensor           # [N, E_pad] int64
    edge_child: torch.Tensor            # [N, E_pad] int64
    edge_freq: torch.Tensor             # [N, E_pad] float32 (0 on padding)
    edge_valid: torch.Tensor            # [N, E_pad] bool
    in_deg: torch.Tensor                # [N, R_pad] int32
    root_seen: torch.Tensor             # [N, R_pad] int32 (in-edges from root)

    # packed local word tables
    tw_rule: torch.Tensor               # [N, T_pad] int64
    tw_word: torch.Tensor               # [N, T_pad] int64
    tw_cnt: torch.Tensor                # [N, T_pad] float32 (0 on padding)

    # packed per-file root segments
    fedge_file: torch.Tensor            # [N, Ef_pad] int64
    fedge_child: torch.Tensor           # [N, Ef_pad] int64
    fedge_freq: torch.Tensor            # [N, Ef_pad] float32
    fword_file: torch.Tensor            # [N, Tf_pad] int64
    fword_word: torch.Tensor            # [N, Tf_pad] int64
    fword_cnt: torch.Tensor             # [N, Tf_pad] float32

    # leveled schedule: per-level segments padded to shared widths
    lv_parent: torch.Tensor             # [N, EL] int64
    lv_child: torch.Tensor              # [N, EL] int64
    lv_freq: torch.Tensor               # [N, EL] float32 (0 on padding)
    lv_slices: Tuple[Tuple[int, int], ...]   # shared (start, end) per level

    # ingest-tier staleness guard: the source-corpus epoch of each packed
    # row at pack time (None when the pack was built from bare immutable
    # GrammarArrays with no mutable store behind them).  A pack snapshots
    # its gas, so it (and every lazy plan on it) stays internally
    # consistent, but serving it for a corpus whose store has since
    # absorbed appended files would answer with pre-append data;
    # check_epochs is the loud guard against that.
    epochs: Optional[Tuple[int, ...]] = None

    # corpus-sharded execution (module DESIGN note): the mesh the rows split
    # over, the count of real rows when the pack was padded to a mesh
    # multiple (None: all rows real), and one row-slice sub-pack per mesh
    # device.  A sharded pack's own [N, ...] tensor fields are None: its
    # rows live on its shards.
    mesh: Any = None
    n_real: Optional[int] = None
    shard_packs: Tuple["GrammarBatch", ...] = ()

    # per-batch memo for host-side plans (keyed by plan name / window l)
    _plan_cache: dict = dataclass_field(default_factory=dict, repr=False,
                                        compare=False)

    @property
    def n(self) -> int:
        return len(self.gas)

    @property
    def real(self) -> int:
        """Rows that correspond to real corpora (the rest is shard padding:
        computed and discarded, never surfaced)."""
        return self.n if self.n_real is None else self.n_real

    @property
    def real_gas(self) -> Tuple[GrammarArrays, ...]:
        return self.gas[: self.real]

    @property
    def shards(self) -> int:
        """Devices the pack spans (1 when unsharded)."""
        return 1 if self.mesh is None else int(self.mesh.size)

    @property
    def signature(self) -> Tuple[int, ...]:
        """Pad signature, the JAX package's: packs with equal signatures
        share plan shapes; the serving layer keys its latency estimates and
        pack counters on it.  The trailing element is the shard count."""
        rows = self.shard_packs[0] if self.shard_packs else self
        return (self.n, self.R_pad, self.E_pad, self.T_pad, self.F_pad,
                self.V_pad, int(rows.fedge_file.shape[1]), self.Tf_pad,
                self.shards)

    def shard(self, mesh, n_real: Optional[int] = None) -> "GrammarBatch":
        """Split the pack row-wise over ``mesh`` (a
        :class:`~repro_torch.distributed.CorpusMesh` whose size divides N;
        ``distributed.shard_batch.shard_batch`` pads a corpus list to the
        multiple).  Returns a new pack whose rows live in ``shard_packs``:
        shard i holds rows ``[i * N / D, (i + 1) * N / D)`` on
        ``mesh.devices[i]``, with this pack's padded dims and ELL plan
        width.  Lazy plans are built per shard on demand."""
        if self.mesh is not None:
            raise ValueError("the pack is already sharded")
        d = int(mesh.size)
        if self.n % d:
            raise ValueError(
                f"batch of {self.n} corpora does not divide across {d} "
                f"devices; pad first (distributed.shard_batch.shard_batch)")
        if n_real is not None and not 0 < n_real <= self.n:
            raise ValueError(f"n_real={n_real} out of range for N={self.n}")
        m = self.n // d
        K = self.ell_plan_width()
        tensors = [f.name for f in dataclasses.fields(self)
                   if isinstance(getattr(self, f.name), torch.Tensor)]
        rows = ("num_rules", "vocab_sizes", "num_files")
        subs = []
        for i, dev in enumerate(mesh.devices):
            s, e = i * m, (i + 1) * m
            kw = {name: getattr(self, name)[s:e].to(dev) for name in tensors}
            kw.update({name: getattr(self, name)[s:e] for name in rows})
            subs.append(dataclasses.replace(
                self, gas=self.gas[s:e], device=dev,
                epochs=None if self.epochs is None else self.epochs[s:e],
                _plan_cache={("ell_width",): K}, **kw))
        return dataclasses.replace(
            self, device=mesh.devices[0], mesh=mesh, n_real=n_real,
            shard_packs=tuple(subs), _plan_cache={},
            **{name: None for name in tensors})

    def check_epochs(self, current: Sequence[int]) -> None:
        """Raise :class:`StaleGrammarError` if any source corpus has moved
        past the epoch this pack (and every lazy plan memoized on it) was
        built from.

        ``current`` is the live epoch per row, in pack order.  Packs
        without epoch stamps (``epochs is None`` — built from bare
        immutable arrays) pass trivially.  The serving layer re-packs
        instead of raising; this is the backstop for any caller that skips
        that refresh.
        """
        if self.epochs is None:
            return
        cur = tuple(int(e) for e in current)
        if len(cur) > len(self.epochs):
            raise StaleGrammarError(
                f"epoch check over {len(cur)} corpora against a pack "
                f"stamped with {len(self.epochs)}")
        for i, (have, now) in enumerate(zip(self.epochs, cur)):
            if have != now:
                raise StaleGrammarError(
                    f"pack row {i} was built at corpus epoch {have} but "
                    f"the corpus is now at epoch {now} — re-pack before "
                    f"serving (the corpus absorbed appended files)")

    def _place(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(arr, device=self.device)

    def map_shards(self, fn: Callable[["GrammarBatch"], Any]):
        """``fn`` over the shards' sub-packs, each on its own device and
        host thread, results gathered in row order with the padding rows
        dropped: tensors concatenated on this pack's device, lists
        concatenated (module DESIGN note)."""
        parts = self.mesh.map(fn, self.shard_packs)
        if isinstance(parts[0], torch.Tensor):
            return torch.cat([p.to(self.device) for p in parts])[: self.real]
        out: List = []
        for p in parts:
            out.extend(p)
        return out[: self.real]

    @property
    def total_edges(self) -> int:
        """True (unpadded) edge count across the batch (memoized)."""
        if ("edges",) not in self._plan_cache:
            self._plan_cache[("edges",)] = sum(ga.num_edges
                                               for ga in self.gas)
        return self._plan_cache[("edges",)]

    def ell_plan_width(self) -> int:
        """K of the dense ELL plan (max in-degree across the batch, bucketed
        to a power of two) — host-only and memoized."""
        if ("ell_width",) not in self._plan_cache:
            kmax = max((int(ga.in_deg.max(initial=0)) for ga in self.gas),
                       default=0)
            self._plan_cache[("ell_width",)] = _pow2_bucket(kmax)
        return self._plan_cache[("ell_width",)]

    def ell_plan(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                int]:
        """Dense [N, R_pad, K] in-edge plan + per-rule levels (memoized).

        Returns ``(src int32, freq float32, level int32, num_levels)``:
        src/freq stack the per-corpus :meth:`GrammarArrays.in_edges_ell_dense`
        plans to a shared K, ``level[i, r]`` is corpus i's rule level (-1 on
        padded rule slots — never active in the leveled replay), and
        num_levels the shared (max) level count.  Built lazily.
        """
        key = ("ell",)
        if key not in self._plan_cache:
            with _plan_stage("ell"):
                K = self.ell_plan_width()
                src = np.zeros((self.n, self.R_pad, K), np.int32)
                freq = np.zeros((self.n, self.R_pad, K), np.float32)
                level = np.full((self.n, self.R_pad), -1, np.int32)
                for i, ga in enumerate(self.gas):
                    s, f = ga.in_edges_ell_dense(k=K)
                    src[i, : ga.num_rules] = s
                    freq[i, : ga.num_rules] = f
                    level[i, : ga.num_rules] = ga.level
                self._plan_cache[key] = (
                    self._place(src), self._place(freq), self._place(level),
                    max(ga.num_levels for ga in self.gas))
        return self._plan_cache[key]

    # ------------------------------------------------------------ build --
    @classmethod
    def build(cls, gas: Sequence[GrammarArrays], bucket: bool = True,
              device=None,
              epochs: Optional[Sequence[int]] = None) -> "GrammarBatch":
        """Pack ``gas`` on ``device`` (the card by default; ``"cpu"`` runs
        the plain torch versions of the kernels).  ``epochs`` stamps each
        row with its source corpus's epoch (:meth:`check_epochs`)."""
        if not gas:
            raise ValueError("GrammarBatch needs at least one corpus")
        dev = resolve_device(device)
        gas = tuple(gas)
        if epochs is not None:
            epochs = tuple(int(e) for e in epochs)
            if len(epochs) != len(gas):
                raise ValueError(f"epochs stamps {len(epochs)} corpora but "
                                 f"the pack has {len(gas)}")
        rnd = _round_up_pow2 if bucket else (lambda x, minimum=1:
                                             max(int(x), minimum))
        R_pad = rnd(max(ga.num_rules for ga in gas))
        E_pad = rnd(max(ga.num_edges for ga in gas))
        T_pad = rnd(max(len(ga.tw_rule) for ga in gas))
        F_pad = rnd(max(ga.num_files for ga in gas), 1)
        V_pad = rnd(max(ga.vocab_size for ga in gas))
        Ef_pad = rnd(max(len(ga.fedge_file) for ga in gas), 1)
        Tf_pad = rnd(max(len(ga.fword_file) for ga in gas), 1)

        in_deg = _pad_stack([ga.in_deg for ga in gas], R_pad, dtype=np.int32)
        root_seen = _pad_stack(
            [np.bincount(ga.edge_child[ga.edge_parent == 0],
                         minlength=ga.num_rules) for ga in gas], R_pad,
            dtype=np.int32)
        valid = np.zeros((len(gas), E_pad), bool)
        for i, ga in enumerate(gas):
            valid[i, : ga.num_edges] = True

        # leveled schedule: align per-level segments across corpora
        n_levels = max(ga.num_levels for ga in gas)
        per_corpus = [ga.level_edge_slices() for ga in gas]
        widths = []
        for lv in range(n_levels):
            w = 0
            for (slices, _) in per_corpus:
                if lv < len(slices):
                    s, e = slices[lv]
                    w = max(w, e - s)
            widths.append(w)
        EL = sum(widths)
        lv_parent = np.zeros((len(gas), EL), np.int64)
        lv_child = np.zeros((len(gas), EL), np.int64)
        lv_freq = np.zeros((len(gas), EL), np.float32)
        lv_slices: List[Tuple[int, int]] = []
        off = 0
        for lv, w in enumerate(widths):
            lv_slices.append((off, off + w))
            for i, (ga, (slices, order)) in enumerate(zip(gas, per_corpus)):
                if lv >= len(slices):
                    continue
                s, e = slices[lv]
                sel = order[s:e]
                lv_parent[i, off: off + (e - s)] = ga.edge_parent[sel]
                lv_child[i, off: off + (e - s)] = ga.edge_child[sel]
                lv_freq[i, off: off + (e - s)] = ga.edge_freq[sel]
            off += w

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.as_tensor(a, device=dev)

        def stack(field: str, width: int, dtype=np.int64) -> torch.Tensor:
            return put(_pad_stack([getattr(ga, field) for ga in gas], width,
                                  dtype=dtype))

        return cls(
            gas=gas, device=dev,
            R_pad=R_pad, E_pad=E_pad, T_pad=T_pad, F_pad=F_pad,
            V_pad=V_pad, Tf_pad=Tf_pad,
            num_rules=np.array([ga.num_rules for ga in gas]),
            vocab_sizes=np.array([ga.vocab_size for ga in gas]),
            num_files=np.array([ga.num_files for ga in gas]),
            edge_parent=stack("edge_parent", E_pad),
            edge_child=stack("edge_child", E_pad),
            edge_freq=stack("edge_freq", E_pad, np.float32),
            edge_valid=put(valid),
            in_deg=put(in_deg),
            root_seen=put(root_seen),
            tw_rule=stack("tw_rule", T_pad),
            tw_word=stack("tw_word", T_pad),
            tw_cnt=stack("tw_cnt", T_pad, np.float32),
            fedge_file=stack("fedge_file", Ef_pad),
            fedge_child=stack("fedge_child", Ef_pad),
            fedge_freq=stack("fedge_freq", Ef_pad, np.float32),
            fword_file=stack("fword_file", Tf_pad),
            fword_word=stack("fword_word", Tf_pad),
            fword_cnt=stack("fword_cnt", Tf_pad, np.float32),
            lv_parent=put(lv_parent),
            lv_child=put(lv_child),
            lv_freq=put(lv_freq),
            lv_slices=tuple(lv_slices),
            epochs=epochs,
        )


# ----------------------------------------------------------------------- #
# Scatter helpers (segment_sum over a written-out batch dimension)         #
# ----------------------------------------------------------------------- #
def _flat_index(idx: torch.Tensor, width: int) -> torch.Tensor:
    """Per-row indices into [0, width) -> indices into the flattened
    [N * width] range (row i's segment at offset i * width)."""
    n = idx.shape[0]
    offs = torch.arange(n, dtype=torch.int64, device=idx.device) * width
    return (idx + offs.view(n, *([1] * (idx.ndim - 1)))).reshape(-1)


def _segment_sum(vals: torch.Tensor, idx: torch.Tensor,
                 width: int) -> torch.Tensor:
    """out[i, s, ...] = sum of vals[i, j, ...] over j with idx[i, j] == s
    (the JAX package's vmapped ``jax.ops.segment_sum``)."""
    n = idx.shape[0]
    tail = tuple(vals.shape[idx.ndim:])
    out = torch.zeros((n * width,) + tail, dtype=vals.dtype,
                      device=vals.device)
    out.index_add_(0, _flat_index(idx, width),
                   vals.reshape((-1,) + tail))
    return out.view((n, width) + tail)


def _gather_rows(W: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """W[i, idx[i, j], :] for a [N, R, F] payload -> [N, J, F]."""
    return torch.gather(W, 1, idx[:, :, None].expand(-1, -1, W.shape[2]))


def _per_file_init(fedge_child, fedge_file, fedge_freq, R: int,
                   F: int) -> torch.Tensor:
    """W0[i, r, f] = occurrences of rule r directly in file f's root
    segment (the per-file traversals' start state)."""
    n = fedge_child.shape[0]
    W0 = torch.zeros((n * R * F,), dtype=torch.float32,
                     device=fedge_child.device)
    W0.index_add_(0, _flat_index(fedge_child * F + fedge_file, R * F),
                  fedge_freq.to(torch.float32).reshape(-1))
    return W0.view(n, R, F)


def _root_weights(n: int, R: int, device) -> torch.Tensor:
    w = torch.zeros((n, R), dtype=torch.float32, device=device)
    w[:, 0] = 1.0
    return w


# ----------------------------------------------------------------------- #
# Batched traversals                                                       #
# ----------------------------------------------------------------------- #
def _frontier_weights(ep, ec, ef, valid, in_deg) -> Tuple[torch.Tensor,
                                                          int]:
    """Masked frontier rounds over the COO edges until no corpus has an
    active rule; corpora that finish early run no-op rounds.  Returns
    ``(weights, rounds)``."""
    N, R = in_deg.shape
    weight = _root_weights(N, R, in_deg.device)
    cur_in = torch.zeros_like(in_deg)
    mask = in_deg == 0
    ever = mask.clone()
    rounds = 0
    while bool(mask.any()):
        active_e = torch.gather(mask, 1, ep) & valid
        contrib = torch.where(active_e, ef * torch.gather(weight, 1, ep),
                              0.0)
        weight = weight + _segment_sum(contrib, ec, R)
        cur_in = cur_in + _segment_sum(active_e.to(torch.int32), ec, R)
        mask = (cur_in == in_deg) & ~ever
        ever = ever | mask
        rounds += 1
    return weight, rounds


def _leveled_weights(ep, ec, ef, slices, R: int) -> torch.Tensor:
    """Shared static level schedule; each real edge touched exactly once
    (padded slots have freq 0)."""
    w = _root_weights(ep.shape[0], R, ep.device)
    for (s, e) in slices:
        if s == e:
            continue
        contrib = ef[:, s:e] * torch.gather(w, 1, ep[:, s:e])
        w = w + _segment_sum(contrib, ec[:, s:e], R)
    return w


# Methods that run on the dense ELL plan, and the segment_sum bases an
# ineligible request degrades to.  ``resolve_traversal_method`` is the one
# place the gates live.
ELL_METHODS = ("frontier_ell", "leveled_ell", "frontier_fused")
SEGMENT_SUM_BASES = {"frontier_ell": "frontier", "frontier_fused": "frontier",
                     "leveled_ell": "leveled"}
#: The analytics whose traversal is per-file (vector payload).
PER_FILE_KINDS = ("term_vector", "inverted_index", "ranked_inverted_index")


def resolve_traversal_method(method: str, *, n: int, rows: int, k: int,
                             edges: int, shards: int = 1,
                             per_file: bool = False, f: int = 1) -> str:
    """Resolve a requested traversal method against the pack's shape gates.

    Pure over dimensions (n/rows/k are the pack's N, R_pad and ELL plan
    width; ``f`` is F_pad for per-file traversals), with the JAX package's
    rules:

    * ``auto`` — occupancy dispatch (kernels.ops.ell_batched_use_ref, per
      shard), then the fused path when ``ell_fused_use_kernel`` admits the
      rule count;
    * explicit ELL methods degrade to their segment_sum base when the dense
      plan itself is ineligible (width / absolute-entry safety valves, and
      the vector-payload budget for per-file traversals);
    * ``frontier_fused`` degrades to ``frontier_ell`` when the fused gate
      refuses or the traversal is per-file (the fused kernel is scalar).
    """
    if method == "auto":
        if kops.ell_batched_use_ref(edges, n, rows, k, shards=shards):
            return "frontier"
        if per_file:
            if not kops.ell_vector_plan_ok(n, rows, k, f):
                return "frontier"
            return "frontier_ell"
        if kops.ell_fused_use_kernel(rows):
            return "frontier_fused"
        return "frontier_ell"
    if method in ELL_METHODS:
        if (k > kops.ELL_BATCH_MAX_WIDTH
                or n * rows * k > kops.ELL_PLAN_MAX_ENTRIES):
            return SEGMENT_SUM_BASES[method]
        if per_file:
            if not kops.ell_vector_plan_ok(n, rows, k, f):
                return SEGMENT_SUM_BASES[method]
            if method == "frontier_fused":
                return "frontier_ell"
        elif method == "frontier_fused":
            if not kops.ell_fused_use_kernel(rows):
                return "frontier_ell"
    return method


def is_segment_sum_fallback(requested: str, resolved: str) -> bool:
    """True when an explicitly-requested ELL-family method landed on a
    segment_sum base (the downgrade ServerStats.method_fallbacks counts)."""
    return requested in ELL_METHODS and resolved in ("frontier", "leveled")


def resolve_batch_method(gb: GrammarBatch, method: str,
                         per_file: bool = False) -> str:
    """`resolve_traversal_method` with the dims read off a built pack."""
    if method != "auto" and method not in ELL_METHODS:
        return method
    return resolve_traversal_method(
        method, n=gb.n, rows=gb.R_pad, k=gb.ell_plan_width(),
        edges=gb.total_edges, shards=gb.shards, per_file=per_file,
        f=gb.F_pad)


def _frontier_ell_weights(ell_src, ell_freq, in_deg
                          ) -> Tuple[torch.Tensor, int]:
    """Masked frontier rounds over the dense ELL plan: every round is one
    gather kernel emitting both delta and the seen-counter.  Returns
    ``(weights, rounds)``."""
    N, R = in_deg.shape
    weight = _root_weights(N, R, in_deg.device)
    cur_in = torch.zeros_like(in_deg)
    mask = in_deg == 0
    ever = mask.clone()
    rounds = 0
    while bool(mask.any()):
        delta, seen = kops.ell_propagate_batched(
            weight, mask.to(torch.float32), ell_src, ell_freq)
        weight = weight + delta
        cur_in = cur_in + seen.to(torch.int32)
        mask = (cur_in == in_deg) & ~ever
        ever = ever | mask
        rounds += 1
    return weight, rounds


def _leveled_ell_weights(ell_src, ell_freq, level,
                         num_levels: int) -> torch.Tensor:
    """Static level schedule over the dense ELL plan: level lv's round
    activates exactly the parents at that level (padded slots: level -1)."""
    N, R = level.shape
    w = _root_weights(N, R, level.device)
    for lv in range(num_levels):
        active = (level == lv).to(torch.float32)
        delta, _ = kops.ell_propagate_batched(w, active, ell_src, ell_freq)
        w = w + delta
    return w


def _frontier_fused_weights(ell_src, ell_freq, in_deg,
                            num_levels: int) -> torch.Tensor:
    """The whole frontier loop in one kernel launch; ``num_levels`` (the
    pack's max DAG depth) is the exact round bound."""
    N, R = in_deg.shape
    w0 = _root_weights(N, R, in_deg.device)
    return kops.ell_frontier_fused(w0, in_deg.to(torch.float32), ell_src,
                                   ell_freq, num_levels)


def batched_top_down_weights(gb: GrammarBatch,
                             method: str = "frontier") -> torch.Tensor:
    """weights[i, r] == occurrences of corpus i's rule r. Shape [N, R_pad].

    Methods: ``frontier`` / ``leveled`` (COO + index_add_),
    ``frontier_ell`` / ``leveled_ell`` (dense ELL plan, one gather kernel
    per round), ``frontier_fused`` (the ELL frontier loop in one kernel
    launch) and ``auto`` (``resolve_traversal_method``).  Each traversal
    of an unsharded pack is metered by ``obs.traverse``.
    """
    method = resolve_batch_method(gb, method)
    if gb.mesh is not None:
        return gb.map_shards(lambda sub: batched_top_down_weights(sub,
                                                                  method))
    with _traverse(method, per_file=False) as attrs:
        w, attrs["host_rounds"] = _top_down_rounds(gb, method)
    return w


def _top_down_rounds(gb: GrammarBatch, method: str
                     ) -> Tuple[torch.Tensor, int]:
    """One resolved top-down method over an unsharded pack: ``(weights,
    rounds that ended in a host sync)``."""
    if method in ("frontier", "top_down", "bottom_up"):
        return _frontier_weights(gb.edge_parent, gb.edge_child, gb.edge_freq,
                                 gb.edge_valid, gb.in_deg)
    if method == "leveled":
        return _leveled_weights(gb.lv_parent, gb.lv_child, gb.lv_freq,
                                gb.lv_slices, gb.R_pad), 0
    if method == "frontier_ell":
        src, freq, _, _ = gb.ell_plan()
        return _frontier_ell_weights(src, freq, gb.in_deg)
    if method == "leveled_ell":
        src, freq, level, num_levels = gb.ell_plan()
        return _leveled_ell_weights(src, freq, level, num_levels), 0
    if method == "frontier_fused":
        src, freq, _, num_levels = gb.ell_plan()
        return _frontier_fused_weights(src, freq, gb.in_deg, num_levels), 0
    raise ValueError(f"unknown batched traversal method {method!r}")


def _per_file_frontier_weights(ep, ec, ef, valid, in_deg, root_seen,
                               fedge_child, fedge_file, fedge_freq,
                               F: int) -> Tuple[torch.Tensor, int]:
    """Per-file masked frontier rounds over the COO edges; root edges are
    consumed by the per-file init and pre-counted in ``root_seen``.
    Returns ``(weights, rounds)``."""
    R = in_deg.shape[1]
    W = _per_file_init(fedge_child, fedge_file, fedge_freq, R, F)
    cur_in = root_seen.clone()
    mask = (root_seen == in_deg) & (in_deg > 0)
    ever = mask | (in_deg == 0)
    rounds = 0
    while bool(mask.any()):
        active_e = torch.gather(mask, 1, ep) & valid & (ep != 0)
        gathered = _gather_rows(W, ep) * ef[:, :, None]
        gathered = torch.where(active_e[:, :, None], gathered, 0.0)
        W = W + _segment_sum(gathered, ec, R)
        cur_in = cur_in + _segment_sum(active_e.to(torch.int32), ec, R)
        mask = (cur_in == in_deg) & ~ever
        ever = ever | mask
        rounds += 1
    return W, rounds


def _per_file_leveled_weights(ep, ec, ef, fedge_child, fedge_file,
                              fedge_freq, slices, R: int,
                              F: int) -> torch.Tensor:
    """Leveled per-file traversal: root edges are consumed by the per-file
    init, so every non-root edge is touched once.  Padded slots have
    ``parent == 0`` and are excluded by the same gate."""
    W = _per_file_init(fedge_child, fedge_file, fedge_freq, R, F)
    for (s, e) in slices:
        if s == e:
            continue
        keep = (ep[:, s:e] != 0).to(torch.float32)
        gathered = _gather_rows(W, ep[:, s:e])                 # [N, w, F]
        contrib = gathered * (ef[:, s:e] * keep)[:, :, None]
        W = W + _segment_sum(contrib, ec[:, s:e], R)
    return W


def _per_file_frontier_ell_weights(ell_src, ell_freq, in_deg, root_seen,
                                   fedge_child, fedge_file, fedge_freq,
                                   F: int) -> Tuple[torch.Tensor, int]:
    """Per-file frontier rounds over the dense ELL plan with the vector
    round (kernels.ops.ell_propagate_vector).  Root-edge exclusion is
    structural: the root is in ``ever`` from the start, so its mask entry is
    never 1 and plan entries with src == 0 contribute nothing.  Returns
    ``(weights, rounds)``."""
    R = in_deg.shape[1]
    W = _per_file_init(fedge_child, fedge_file, fedge_freq, R, F)
    cur_in = root_seen.clone()
    mask = (root_seen == in_deg) & (in_deg > 0)
    ever = mask | (in_deg == 0)
    rounds = 0
    while bool(mask.any()):
        delta, seen = kops.ell_propagate_vector(
            W, mask.to(torch.float32), ell_src, ell_freq)
        W = W + delta
        cur_in = cur_in + seen.to(torch.int32)
        mask = (cur_in == in_deg) & ~ever
        ever = ever | mask
        rounds += 1
    return W, rounds


def _per_file_leveled_ell_weights(ell_src, ell_freq, level, fedge_child,
                                  fedge_file, fedge_freq, num_levels: int,
                                  F: int) -> torch.Tensor:
    """Leveled per-file traversal over the dense ELL plan; the root (rule
    0, level 0) is masked out — its edges are consumed by the init."""
    R = level.shape[1]
    W = _per_file_init(fedge_child, fedge_file, fedge_freq, R, F)
    nonroot = (torch.arange(R, device=level.device) > 0)[None, :]
    for lv in range(num_levels):
        active = ((level == lv) & nonroot).to(torch.float32)
        delta, _ = kops.ell_propagate_vector(W, active, ell_src, ell_freq)
        W = W + delta
    return W


def batched_per_file_weights(gb: GrammarBatch,
                             method: str = "frontier") -> torch.Tensor:
    """Wf[i, r, f] == occurrences of rule r inside file f of corpus i.

    The ELL methods run the vector-payload rounds over the same dense plan
    as the scalar traversals; ``frontier_fused`` runs its per-round ELL base
    here (the fused kernel is scalar-payload).  Each traversal of an
    unsharded pack is metered by ``obs.traverse``."""
    method = resolve_batch_method(gb, method, per_file=True)
    if gb.mesh is not None:
        return gb.map_shards(lambda sub: batched_per_file_weights(sub,
                                                                  method))
    with _traverse(method, per_file=True) as attrs:
        W, attrs["host_rounds"] = _per_file_rounds(gb, method)
    return W


def _per_file_rounds(gb: GrammarBatch, method: str
                     ) -> Tuple[torch.Tensor, int]:
    """One resolved per-file method over an unsharded pack: ``(weights,
    rounds that ended in a host sync)``."""
    if method in ("frontier", "top_down", "bottom_up"):
        return _per_file_frontier_weights(
            gb.edge_parent, gb.edge_child, gb.edge_freq, gb.edge_valid,
            gb.in_deg, gb.root_seen, gb.fedge_child, gb.fedge_file,
            gb.fedge_freq, gb.F_pad)
    if method == "leveled":
        return _per_file_leveled_weights(
            gb.lv_parent, gb.lv_child, gb.lv_freq, gb.fedge_child,
            gb.fedge_file, gb.fedge_freq, gb.lv_slices, gb.R_pad,
            gb.F_pad), 0
    if method == "frontier_ell":
        src, freq, _, _ = gb.ell_plan()
        return _per_file_frontier_ell_weights(
            src, freq, gb.in_deg, gb.root_seen, gb.fedge_child,
            gb.fedge_file, gb.fedge_freq, gb.F_pad)
    if method == "leveled_ell":
        src, freq, level, num_levels = gb.ell_plan()
        return _per_file_leveled_ell_weights(
            src, freq, level, gb.fedge_child, gb.fedge_file, gb.fedge_freq,
            num_levels, gb.F_pad), 0
    raise ValueError(f"unknown batched traversal method {method!r}")


# ----------------------------------------------------------------------- #
# Batched analytics (the six CompressDirect apps)                          #
# ----------------------------------------------------------------------- #
BACKENDS = ("torch", "kernel")


def batched_word_count(gb: GrammarBatch, method: str = "frontier",
                       backend: str = "torch") -> torch.Tensor:
    """counts[i, v] for every corpus. Shape [N, V_pad].

    ``backend="torch"`` reduces with ``index_add_``; ``backend="kernel"``
    with the weighted-histogram kernel (kernels/bincount.py) — the JAX
    package's ``backend="pallas"``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if gb.mesh is not None:
        m = resolve_batch_method(gb, method)
        return gb.map_shards(lambda sub: batched_word_count(sub, m, backend))
    w = batched_top_down_weights(gb, method=method)
    vals = gb.tw_cnt * torch.gather(w, 1, gb.tw_rule)
    if backend == "kernel":
        return kops.weighted_bincount_batched(gb.tw_word, vals, gb.V_pad)
    return _segment_sum(vals, gb.tw_word, gb.V_pad)


def batched_sort_words(gb: GrammarBatch, method: str = "frontier",
                       backend: str = "torch"
                       ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per corpus (word_ids int32, counts) sorted by frequency desc, ties by
    word id (stable); the final argsort runs on true sizes."""
    if gb.mesh is not None:
        m = resolve_batch_method(gb, method)
        return gb.map_shards(lambda sub: batched_sort_words(sub, m, backend))
    wc = batched_word_count(gb, method=method, backend=backend)
    out = []
    for i, ga in enumerate(gb.gas):
        counts = wc[i, : ga.vocab_size]
        order = torch.argsort(-counts, stable=True)
        out.append((order.to(torch.int32), counts[order]))
    return out


def _rule_counts(Wf, tw_rule, tw_word, tw_cnt, V: int) -> torch.Tensor:
    """tv[i, v, f]: word v's occurrences in file f of corpus i through the
    rules, word-major ``[N, V, F]`` as the segment sum writes it (the
    words each file's root holds directly are not yet added)."""
    contrib = _gather_rows(Wf, tw_rule) * tw_cnt[:, :, None]    # [N, T, F]
    return _segment_sum(contrib, tw_word, V)                     # [N, V, F]


def _term_vector_from_weights(Wf, tw_rule, tw_word, tw_cnt, fword_file,
                              fword_word, fword_cnt, V: int) -> torch.Tensor:
    F = Wf.shape[2]
    tv = _rule_counts(Wf, tw_rule, tw_word, tw_cnt, V)           # [N, V, F]
    tv = tv.transpose(1, 2).contiguous()                         # [N, F, V]
    tv.view(-1).index_add_(0, _flat_index(fword_file * V + fword_word,
                                          F * V),
                           fword_cnt.reshape(-1))
    return tv


def batched_term_vector(gb: GrammarBatch,
                        method: str = "frontier") -> torch.Tensor:
    """tv[i, f, v] — dense per-file counts, all corpora at once."""
    if gb.mesh is not None:
        m = resolve_batch_method(gb, method, per_file=True)
        return gb.map_shards(lambda sub: batched_term_vector(sub, m))
    Wf = batched_per_file_weights(gb, method=method)
    return _term_vector_from_weights(
        Wf, gb.tw_rule, gb.tw_word, gb.tw_cnt,
        gb.fword_file, gb.fword_word, gb.fword_cnt, gb.V_pad)


def batched_inverted_index(gb: GrammarBatch,
                           method: str = "frontier") -> torch.Tensor:
    return batched_term_vector(gb, method=method) > 0


def word_major_term_vector(gb: GrammarBatch,
                           Wf: torch.Tensor) -> torch.Tensor:
    """tv[i, v, f] — word v's occurrences in file f of corpus i, from the
    per-file weights ``Wf [N, R_pad, F]``: word-major ``[N, V_pad, F]`` as
    the segment sum writes it, with each file's root words added at ``word
    * F + file`` (integer-valued float32, so the order of the adds cannot
    change a count).  With no files it is the empty ``[N, V_pad, 0]`` (the
    pack's padding entries would scatter out of an empty table)."""
    F = Wf.shape[2]
    if F == 0:
        return torch.zeros((gb.n, gb.V_pad, 0), dtype=torch.float32,
                           device=Wf.device)
    tv = _rule_counts(Wf, gb.tw_rule, gb.tw_word, gb.tw_cnt, gb.V_pad)
    tv.view(-1).index_add_(0, _flat_index(gb.fword_word * F + gb.fword_file,
                                          gb.V_pad * F),
                           gb.fword_cnt.reshape(-1))
    return tv


def batched_ranked_inverted_index(gb: GrammarBatch, method: str = "frontier"
                                  ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per corpus (ranking [V, F] int32, counts [V, F]) — true per-corpus
    shapes, files ranked by count desc, ties by file id (stable).

    The term vector stays word-major (:func:`word_major_term_vector`,
    ``[N, V_pad, F_pad]``), and ``kernels.ops.rank_files`` ranks every
    corpus's words from that layout in one call (one kernel launch on the
    card)."""
    if gb.mesh is not None:
        m = resolve_batch_method(gb, method, per_file=True)
        return gb.map_shards(lambda sub: batched_ranked_inverted_index(sub,
                                                                       m))
    tv = word_major_term_vector(gb, batched_per_file_weights(gb,
                                                             method=method))
    return kops.rank_files(tv, gb.num_files, gb.vocab_sizes)


def unbatch(gb: GrammarBatch, packed: torch.Tensor,
            kind: str = "word_count") -> List[np.ndarray]:
    """Slice a packed result (one row per real corpus and any padding
    rows after them) back to per-corpus true shapes, on its device, and
    copy only those slices to the host (``host_copy.to_host``)."""
    if kind == "word_count":
        parts = [packed[i, : ga.vocab_size]
                 for i, ga in enumerate(gb.real_gas)]
    elif kind in ("term_vector", "inverted_index"):
        parts = [packed[i, : ga.num_files, : ga.vocab_size]
                 for i, ga in enumerate(gb.real_gas)]
    else:
        raise ValueError(f"cannot unbatch kind {kind!r}")
    return to_host(parts)


# ----------------------------------------------------------------------- #
# Batched sequence count (paper §IV-D across corpora)                      #
# ----------------------------------------------------------------------- #
def _resolve_buffers_batched(is_lit, lit, src, idx, dep) -> torch.Tensor:
    """Fill the [N, R, h] head (or tail) buffers in masked rounds: a rule
    resolves once every rule it copies from has resolved."""
    N, R, h = is_lit.shape
    leaf = (dep < 0).all(dim=2)
    buf = torch.where(is_lit, lit, -1)
    dep_flat = _flat_index(dep.clamp(0, R - 1), R)
    src_flat = _flat_index(src * h + idx, R * h)
    ready = leaf
    prev = torch.zeros_like(ready)
    while bool((ready != prev).any()):
        dep_ok = torch.where(dep < 0, True,
                             ready.reshape(-1)[dep_flat].view(dep.shape)
                             ).all(dim=2)
        newly = dep_ok & ~ready
        gathered = torch.where(is_lit, lit,
                               buf.reshape(-1)[src_flat].view(buf.shape))
        buf = torch.where(newly[:, :, None], gathered, buf)
        prev = ready
        ready = ready | newly
    return buf


def _lexsort_rows(keys: torch.Tensor) -> torch.Tensor:
    """Per batch row, the permutation sorting ``keys [N, M, l]``
    lexicographically (column 0 primary): a chain of stable sorts from the
    last column to the first (``jnp.lexsort`` in the JAX package)."""
    N, M, l = keys.shape
    order = torch.arange(M, device=keys.device).expand(N, M).contiguous()
    for c in range(l - 1, -1, -1):
        col = torch.gather(keys[:, :, c], 1, order)
        perm = torch.sort(col, dim=1, stable=True).indices
        order = torch.gather(order, 1, perm)
    return order


def _window_tokens(head, tail, weights, st_kind, st_lit, st_src, st_idx,
                   st_symj, win_start, win_rule, win_valid, l: int):
    """The tokens of every l-window of the padded streams and its weight:
    ``(wtok [N, Nw, l], wweight [N, Nw])``, the weight being the window
    rule's occurrence count, or 0 where the window is invalid (it holds a
    break, lies inside one symbol, or is padding)."""
    N, R, h = head.shape
    sel = _flat_index(st_src * h + st_idx, R * h)
    hg = head.reshape(-1)[sel].view(st_src.shape)
    tg = tail.reshape(-1)[sel].view(st_src.shape)
    tok = torch.where(st_kind == _K_LIT, st_lit,
                      torch.where(st_kind == _K_HEAD, hg,
                                  torch.where(st_kind == _K_TAIL, tg,
                                              st_lit)))
    Nw = win_start.shape[1]
    pos = (win_start[:, :, None]
           + torch.arange(l, device=win_start.device)).reshape(N, -1)
    wtok = torch.gather(tok, 1, pos).view(N, Nw, l)
    wsym = torch.gather(st_symj, 1, pos).view(N, Nw, l)
    valid = ((wtok >= 0).all(dim=2) & (wsym[:, :, 0] != wsym[:, :, -1])
             & win_valid)
    wweight = torch.where(valid, torch.gather(weights, 1, win_rule), 0.0)
    return wtok, wweight


def _count_windows_batched(head, tail, weights, st_kind, st_lit, st_src,
                           st_idx, st_symj, win_start, win_rule, win_valid,
                           l: int):
    return _segment_windows(*_window_tokens(
        head, tail, weights, st_kind, st_lit, st_src, st_idx, st_symj,
        win_start, win_rule, win_valid, l))


def _segment_windows(wtok, wweight):
    """Sort each row's windows ``wtok [N, Nw, l]`` lexicographically and
    sum the weights of equal ones: ``(stok, newseg, seg, counts)``, the
    sorted windows, the first window of each segment, each window's
    segment and each segment's count (``counts[:, s]``)."""
    N, Nw, l = wtok.shape
    order = _lexsort_rows(wtok)
    stok = torch.gather(wtok, 1, order[:, :, None].expand(-1, -1, l))
    sw = torch.gather(wweight, 1, order)
    newseg = torch.cat([
        torch.ones((N, 1), dtype=torch.bool, device=stok.device),
        (stok[:, 1:] != stok[:, :-1]).any(dim=2)], dim=1)
    seg = torch.cumsum(newseg, dim=1) - 1
    counts = _segment_sum(sw, seg, Nw)
    return stok, newseg, seg, counts


def distinct_grams(stok, newseg, seg, counts
                   ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Per row of ``_count_windows_batched``'s output, the distinct l-grams
    (int32 [U, l], lexicographic) and their counts (float32 [U]).

    A gram is the first window of a segment whose count is above 0
    (padded and invalid windows carry zero weight).  The selection, each
    row's count of grams and the compaction run on the device.  The host
    waits twice: for those counts, which size the answers, and in
    ``host_copy.to_host``, which copies only the grams and their counts."""
    n, nw, l = stok.shape
    seg_count = torch.gather(counts, 1, seg)
    keep = newseg & (seg_count > 0)
    sizes = keep.sum(1).tolist()
    total = sum(sizes)
    # each kept window scatters its flat position to its rank among the
    # kept ones, every other window to one spare slot past the end
    flat = keep.reshape(-1)
    rank = torch.where(flat, torch.cumsum(flat, 0) - 1, total)
    pos = torch.empty(total + 1, dtype=torch.int64, device=stok.device)
    pos.scatter_(0, rank, torch.arange(n * nw, device=stok.device))
    pos = pos[:total]
    grams, cnts = to_host((stok.reshape(-1, l)[pos].to(torch.int32),
                           seg_count.reshape(-1)[pos]))
    ends = np.cumsum(sizes)
    return [(grams[e - k: e], cnts[e - k: e]) for k, e in zip(sizes, ends)]


def _padded_sequence_plans(gb: GrammarBatch, l: int):
    """Host-side planning + padding + resolved head/tail buffers, memoized
    per (batch, l)."""
    if l in gb._plan_cache:
        return gb._plan_cache[l]
    with _plan_stage("sequence"):
        gb._plan_cache[l] = _build_sequence_plans(gb, l)
    return gb._plan_cache[l]


def _build_sequence_plans(gb: GrammarBatch, l: int):
    N = gb.n
    h = l - 1
    htps = [_sequence.plan_head_tail(ga, l) for ga in gb.gas]
    sps = [_sequence.plan_stream(ga, l) for ga in gb.gas]

    R_pad = gb.R_pad
    Kd = _round_up_pow2(
        max(max(p.head_dep.shape[1], p.tail_dep.shape[1]) for p in htps), 1)

    def _stack_plan(get_arr, fill, dtype, width2):
        out = np.full((N, R_pad, width2), fill, dtype)
        for i, p in enumerate(htps):
            a = get_arr(p)
            out[i, : a.shape[0], : a.shape[1]] = a
        return gb._place(out)

    def _resolve(side: str) -> torch.Tensor:
        return _resolve_buffers_batched(
            _stack_plan(lambda p: getattr(p, f"{side}_is_lit"), False, bool, h),
            _stack_plan(lambda p: getattr(p, f"{side}_lit"), -1, np.int32, h),
            _stack_plan(lambda p: getattr(p, f"{side}_src"), 0, np.int64, h),
            _stack_plan(lambda p: getattr(p, f"{side}_idx"), 0, np.int64, h),
            _stack_plan(lambda p: getattr(p, f"{side}_dep"), -1, np.int64,
                        Kd))

    head = _resolve("head")
    tail = _resolve("tail")

    S_pad = _round_up_pow2(max(max(len(p.st_kind) for p in sps), l), 1)
    W_pad = _round_up_pow2(max(max(len(p.win_start) for p in sps), 1), 1)
    win_valid = np.zeros((N, W_pad), bool)
    for i, p in enumerate(sps):
        win_valid[i, : len(p.win_start)] = True
    stream = (
        gb._place(_pad_stack([p.st_kind for p in sps], S_pad,
                             fill=_sequence._K_BREAK, dtype=np.int8)),
        gb._place(_pad_stack([p.st_lit for p in sps], S_pad,
                             fill=_sequence._BREAK, dtype=np.int32)),
        gb._place(_pad_stack([p.st_src for p in sps], S_pad)),
        gb._place(_pad_stack([p.st_idx for p in sps], S_pad)),
        gb._place(_pad_stack([p.st_symj for p in sps], S_pad,
                             dtype=np.int32)),
        gb._place(_pad_stack([p.win_start for p in sps], W_pad)),
        gb._place(_pad_stack([p.win_rule for p in sps], W_pad)),
        gb._place(win_valid))
    return (head, tail, stream)


def batched_sequence_count(gb: GrammarBatch, l: int = 3,
                           method: str = "frontier"
                           ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Per corpus (grams [U, l] int32, counts [U] float32), grams sorted
    lexicographically — head/tail resolution, stream gathers, window
    sorting, segment reduction and the distinct-gram extraction run
    batched on the pack's device; only the answers reach the host
    (``distinct_grams``)."""
    if l < 2:
        raise ValueError("sequence_count needs l >= 2")
    if gb.mesh is not None:
        m = resolve_batch_method(gb, method)
        return gb.map_shards(lambda sub: batched_sequence_count(sub, l, m))
    weights = batched_top_down_weights(gb, method=method)
    head, tail, stream = _padded_sequence_plans(gb, l)
    return distinct_grams(*_count_windows_batched(head, tail, weights,
                                                  *stream, l))


# ----------------------------------------------------------------------- #
# Convenience: run any of the six analytics batched, per-corpus results    #
# ----------------------------------------------------------------------- #
ANALYTICS_KINDS = ("word_count", "sort", "inverted_index", "term_vector",
                   "sequence_count", "ranked_inverted_index")
#: The traversal methods a request may name (the serving layer's set).
METHODS = ("frontier", "leveled", "frontier_ell", "leveled_ell",
           "frontier_fused", "auto")


def run_batched(gb: GrammarBatch, kind: str, method: str = "frontier",
                backend: str = "torch", l: int = 3) -> List:
    """Dispatch one analytics kind over the whole batch; returns a list of
    per-corpus numpy results shaped exactly like the JAX package's (real
    corpora only: a sharded pack's padding rows are dropped)."""
    if gb.mesh is not None and kind in ANALYTICS_KINDS:
        m = resolve_batch_method(gb, method, per_file=kind in PER_FILE_KINDS)
        return gb.map_shards(lambda sub: run_batched(sub, kind, m, backend,
                                                     l))
    if kind == "word_count":
        return unbatch(gb, batched_word_count(gb, method=method,
                                              backend=backend), "word_count")
    if kind == "sort":
        return to_host(batched_sort_words(gb, method=method,
                                          backend=backend))
    if kind == "term_vector":
        return unbatch(gb, batched_term_vector(gb, method=method),
                       "term_vector")
    if kind == "inverted_index":
        return unbatch(gb, batched_inverted_index(gb, method=method),
                       "inverted_index")
    if kind == "ranked_inverted_index":
        return to_host(batched_ranked_inverted_index(gb, method=method))
    if kind == "sequence_count":
        return batched_sequence_count(gb, l=l, method=method)
    raise ValueError(f"unknown analytics kind {kind!r}; "
                     f"expected one of {ANALYTICS_KINDS}")
