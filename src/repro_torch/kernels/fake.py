"""The kernels' shape-only path, which the dry run traces
(``repro_torch.launch.dryrun``).

On a ``meta`` tensor a kernel entry builds and launches nothing: it
returns outputs of the kernel's shapes and dtypes, allocated as its
launcher allocates them (so a memory trace sees the same bytes, K1's
backward scratch included), and reports the work one launch does, its
operations and the bytes it must move, to the recorders entered with
``recording``.  A CUDA tensor still launches the kernel or raises, and a
CPU tensor still takes the plain version.  No launch count moves.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch

_recorders: list[Callable] = []


def is_fake(t: torch.Tensor) -> bool:
    return t.device.type == "meta"


@contextlib.contextmanager
def recording(fn: Callable):
    """Call ``fn(name, flops, nbytes, dtype)`` for each shape-only launch
    in the enclosed calls: ``dtype`` is the type its operations run in."""
    _recorders.append(fn)
    try:
        yield
    finally:
        _recorders.remove(fn)


def report(name: str, *, flops: int, nbytes: int, dtype: torch.dtype) -> None:
    for fn in _recorders:
        fn(name, int(flops), int(nbytes), dtype)


def nbytes(*tensors: torch.Tensor) -> int:
    """Bytes of the tensors, each read or written once."""
    return sum(t.numel() * t.element_size() for t in tensors)
