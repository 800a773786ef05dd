"""Roofline inputs from what PyTorch records, the counterpart of the JAX
package's ``utils/hlo_analysis.py`` (which parses compiled HLO text).

PyTorch compiles no HLO, so the port counts the eager program instead:
:func:`count_ops` runs code under a ``TorchDispatchMode`` that sees every
ATen operation after autograd and the composite decompositions (an
``einsum`` arrives as ``bmm``), and keeps an :class:`OpRecord`.  The JAX
module's three functions read that record and give the same schema:

* :func:`parse_collectives`: ``{kind: {count, bytes}}`` over the five
  HLO kinds.  ``_c10d_functional.all_gather_into_tensor`` is an
  all-gather, ``all_reduce`` an all-reduce, ``reduce_scatter_tensor`` a
  reduce-scatter, ``all_to_all_single`` (and DTensor's
  ``shard_dim_alltoall``) an all-to-all, ``c10d.send``/``recv_`` a
  collective-permute.  Bytes are per rank and on the result side, as the
  JAX parser takes them.
* :func:`total_collective_bytes`: their sum.
* :func:`op_histogram`: ``dot`` is mm/bmm/addmm/baddbmm, ``reshape``
  view/reshape/_unsafe_view, ``transpose`` transpose/permute/t;
  ``custom-call`` is the number of launches of the port's own CUDA
  kernels (``repro_torch.kernels.launch_counts``) made inside the count;
  ``fusion`` and ``while`` are always 0 (eager PyTorch fuses nothing and
  has no loop op: a Python loop shows as the ops of each trip).

The record also holds the FLOPs (``torch.utils.flop_counter``'s formulas,
the ops it knows: matmuls, convolutions, attention) and the bytes
accessed (each op's tensor operands plus its results, XLA's unfused
"bytes accessed"; views, allocations and the collectives' wrappers
move nothing and are not counted, the collectives' bytes are their
own).

PER RANK, NOT PER MESH.  ``FlopCounterMode`` counts a DTensor op at its
global shape, the whole mesh's work.  This mode declines every op whose
arguments are DTensors (it returns ``NotImplemented``), so DTensor first
picks its strategy and redistributes, and the mode then sees the local
op on each rank's local shards, and the collectives DTensor issues, at
local shapes (DTensor's own inference of an output's global shape, on
fake tensors, is not counted).  FLOPs and bytes are thus one rank's,
as XLA's ``flops_per_device`` is: a matmul sharded over 16 ranks counts
1/16 of its global FLOPs, a replicated one counts them all.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import Counter
from typing import Dict, Iterator, List, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# op packet name -> (HLO kind, where its result is: "out" or "arg0")
_KINDS = {
    "_c10d_functional.all_gather_into_tensor": ("all-gather", "out"),
    "_c10d_functional.all_reduce": ("all-reduce", "out"),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", "out"),
    "_c10d_functional.all_to_all_single": ("all-to-all", "out"),
    "_dtensor.shard_dim_alltoall": ("all-to-all", "out"),
    "c10d.send": ("collective-permute", "arg0"),
    "c10d.recv_": ("collective-permute", "arg0"),
}

# ops that allocate, alias or wrap and move no bytes of their own
_NO_TRAFFIC = frozenset((
    "aten.empty", "aten.empty_strided", "aten.empty_like", "aten.new_empty",
    "aten.new_empty_strided", "aten._unsafe_view",
    "_c10d_functional._wrap_tensor_autograd", "_c10d_functional.wait_tensor"))

_HISTOGRAM = {
    "dot": ("aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm"),
    "reshape": ("aten.view", "aten.reshape", "aten._unsafe_view"),
    "transpose": ("aten.transpose", "aten.permute", "aten.t"),
}


@dataclasses.dataclass
class OpRecord:
    """What one counted run did on this rank: ATen op counts by packet
    name, each collective's ``(kind, result bytes)``, FLOPs, bytes
    accessed, and the port's kernel launches."""
    ops: Counter = dataclasses.field(default_factory=Counter)
    collectives: List[Tuple[str, int]] = dataclasses.field(
        default_factory=list)
    flops: float = 0.0
    bytes: float = 0.0
    kernel_launches: int = 0


def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


class _Counting(TorchDispatchMode):
    def __init__(self, record: OpRecord):
        super().__init__()
        self.record = record

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor pick its strategy; its local ops come back here
            return NotImplemented
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            # DTensor inferring an output's global shape (once a signature)
            return out
        packet = func._overloadpacket
        name = str(packet)
        rec = self.record
        rec.ops[name] += 1
        if name in _KINDS:
            kind, side = _KINDS[name]
            rec.collectives.append(
                (kind, _nbytes(out if side == "out" else args[0])))
            return out
        if packet in flop_registry:
            rec.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view and name not in _NO_TRAFFIC:
            rec.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


@contextlib.contextmanager
def count_ops() -> Iterator[OpRecord]:
    """Count what the code inside does on this rank; the record fills in
    as it runs and is complete on exit."""
    from repro_torch.kernels import launch_counts
    record = OpRecord()
    before = sum(launch_counts().values())
    try:
        with _Counting(record):
            yield record
    finally:
        record.kernel_launches = sum(launch_counts().values()) - before


def parse_collectives(record: OpRecord) -> Dict[str, Dict[str, float]]:
    """kind -> {count, bytes} summed over the run (per rank)."""
    out: Dict[str, Dict[str, float]] = {
        k: {"count": 0, "bytes": 0.0} for k in _COLLECTIVES}
    for kind, b in record.collectives:
        out[kind]["count"] += 1
        out[kind]["bytes"] += b
    return out


def total_collective_bytes(record: OpRecord) -> float:
    return sum(v["bytes"] for v in parse_collectives(record).values())


def op_histogram(record: OpRecord, ops=("dot", "reshape", "transpose",
                                        "fusion", "while", "custom-call")
                 ) -> Dict[str, int]:
    """Counts of the interesting op kinds (module note)."""
    out = {}
    for op in ops:
        if op == "custom-call":
            out[op] = record.kernel_launches
        else:
            out[op] = sum(record.ops[n] for n in _HISTOGRAM.get(op, ()))
    return out
