"""Answers from the device to host numpy arrays: the engine's one copy path.

:func:`to_host` takes a tensor, or lists and tuples of them, and returns
the same structure of numpy arrays.  A tensor already on the host is
returned as its ``.numpy()`` view (no copy).  A tensor on a CUDA device is
copied into page-locked memory from torch's caching host allocator:

* each destination is ``empty_like`` the source (a dense source keeps its
  strides, so a transposed answer is still one memcpy; a strided slice
  lands contiguous), every copy of the call is enqueued ``non_blocking``,
  then each source device's current stream is synchronised once, and only
  then are the arrays handed out;
* every array is the caller's own.  Its pinned block returns to torch's
  pool when the array (and the tensor under it) is freed, and a later
  call of the same size reuses it, so steady traffic page-locks nothing
  new;
* if page-locked memory cannot be had, that tensor is copied into
  pageable memory instead, and the request goes on.

Copying pageable memory costs CUDA a staging buffer and the host a page
fault on every fresh page; a page-locked copy runs at the bus's rate.

The bytes of every device copy, by the path it took (``"pinned"`` or
``"pageable"``), go to the sink of :func:`count_host_copies`, if one is
active in the calling context (the serving layer's counter;
``CorpusMesh.map`` carries the context to its shard threads).
"""

from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from typing import Callable, Iterator, Optional

import torch

#: (path, nbytes) -> None, per thread/task via contextvars
_SINK: ContextVar[Optional[Callable[[str, int], None]]] = \
    ContextVar("repro_torch_host_copy_sink", default=None)


@contextmanager
def count_host_copies(sink: Callable[[str, int], None]) -> Iterator[None]:
    """Report every device copy :func:`to_host` makes inside the block to
    ``sink(path, nbytes)``."""
    token = _SINK.set(sink)
    try:
        yield
    finally:
        _SINK.reset(token)


def to_host(tree):
    """``tree`` (a tensor, or lists and tuples of them) as numpy arrays,
    every device copy enqueued before one synchronise a device."""
    sink = _SINK.get()
    devices = set()

    def stage(x):
        if isinstance(x, (list, tuple)):
            return type(x)(stage(y) for y in x)
        if x.device.type != "cuda":
            return x
        try:
            dst = torch.empty_like(x, device="cpu", pin_memory=True)
        except RuntimeError:
            dst, path = x.cpu(), "pageable"
        else:
            dst.copy_(x, non_blocking=True)
            devices.add(x.device)
            path = "pinned"
        if sink is not None:
            sink(path, dst.nbytes)
        return dst

    staged = stage(tree)
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()

    def numpy(x):
        if isinstance(x, (list, tuple)):
            return type(x)(numpy(y) for y in x)
        return x.numpy()

    return numpy(staged)
