"""GPipe pipeline parallelism over a list of devices, the port of the JAX
package's ``distributed/pipeline.py``.

Each device of the list holds one stage's parameters; microbatches stream
through with the classic (M + S - 1)-tick schedule: at tick ``t`` stage
``i`` runs microbatch ``t - i``, so stage ``i + 1`` takes what stage ``i``
gave at the tick before.  An activation hops from stage ``i`` to stage
``i + 1`` with ``.to(devices[i + 1], non_blocking=True)`` (the JAX
package's ``ppermute``).  A device may appear more than once, as a
``CorpusMesh`` repeats a device: the stand-in for more cards than a
machine has.

The stages run one after another on the host within a tick; overlapping
them (a CUDA stream a stage) is later work: this module's contract is the
schedule and its result, the same as applying the stages in order to
every microbatch.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from repro_torch.models.layers import tree_map


def gpipe(stage_fn: Callable, devices: Sequence, n_stages: int) -> Callable:
    """Build a pipelined forward.

    ``stage_fn(params_slice, x) -> y`` is one stage's compute; all stages
    must share input/output activation shape (classic GPipe).  Stage ``i``
    runs on ``devices[i]``.

    Returns ``run(stacked_params, microbatches)`` where ``stacked_params``
    leaves have leading dim ``n_stages`` and ``microbatches`` is
    ``[M, mb, ...]``; the output is ``[M, mb, ...]`` after the last stage,
    on the last stage's device.
    """
    devices = [torch.device(d) for d in devices]
    if len(devices) < n_stages:
        raise ValueError(f"{n_stages} stages need {n_stages} devices, got "
                         f"{len(devices)}")
    devices = devices[:n_stages]

    def run(stacked_params, microbatches: torch.Tensor) -> torch.Tensor:
        M = microbatches.shape[0]
        S = n_stages
        stage_params = [tree_map(lambda a, i=i: a[i].to(devices[i]),
                                 stacked_params) for i in range(S)]
        first = microbatches.to(devices[0])
        # inbox[i]: the activation stage i runs at this tick
        inbox: List[Optional[torch.Tensor]] = [None] * S
        outs: List[Optional[torch.Tensor]] = [None] * M
        for t in range(M + S - 1):
            if t < M:
                inbox[0] = first[t]
            # the last stage first: each stage reads its inbox before the
            # stage ahead of it writes the next tick's
            for i in reversed(range(S)):
                m = t - i
                if not 0 <= m < M:
                    continue
                y = stage_fn(stage_params[i], inbox[i])
                inbox[i] = None
                if i == S - 1:
                    outs[m] = y
                else:
                    inbox[i + 1] = y.to(devices[i + 1], non_blocking=True)
        return torch.stack(outs)

    return run


def make_pp_mesh(n_stages: int, devices: Optional[Sequence] = None
                 ) -> List[torch.device]:
    """The first ``n_stages`` CUDA devices, or of ``devices`` when the caller
    lists them (stand-ins such as ``("cuda:0",) * 4`` or ``("cpu",) * 4``).
    Raises when there are fewer."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if len(devices) < n_stages:
        raise RuntimeError(f"a {n_stages}-stage pipeline needs {n_stages} "
                           f"devices; {len(devices)} available (list "
                           f"stand-ins explicitly to reuse one)")
    return devices[:n_stages]
