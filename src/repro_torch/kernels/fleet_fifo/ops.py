"""Fleet FIFO solver (K4): the plain version on CPU tensors, the CUDA kernel
on CUDA tensors.

Replaces the reference's jitted ``lax.scan``
(``repro/serving/event_core.py`` ``_load_jax.fleet_scan``, driven by
``fleet_fifo_finish`` and ``_run_fleet_group``), the one piece of device
code an event-core cluster day runs.  It solves S independent k-server
FIFO streams, bitwise what ``engine._sweep`` gives for each.

On an H100 the kernel is bound by each stream's dependent chain (argmin
over k, a select, an add per job), not by bytes: ``csrc/fleet_fifo.cu``
runs one thread a stream with the k free times in registers, loads the
jobs ahead of the recurrence, and takes every stream of a call in one
launch so the chains overlap.

Which version runs is decided by where the caller put the tensors, never
by what is installed: a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from collections.abc import Sequence

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fleet_fifo.ref import fleet_fifo_ref

# Kernel launches since the last reset (set it to 0 to start a count).
launches = 0

_WARP = 32
_BUCKETS = (1, 2, 4, 8, 16, 32)  # register buckets of csrc/fleet_fifo.cu
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("fleet_fifo")
        fn = lib.repro_fleet_fifo
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.repro_fleet_fifo_error_string.argtypes = [ctypes.c_int]
        lib.repro_fleet_fifo_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.repro_fleet_fifo_error_string)
    return _fn


def warp_lanes(ks: Sequence[int]) -> np.ndarray:
    """The kernel's thread layout: int32 [2, n_lanes], row 0 the stream of
    each thread (-1 for none), row 1 its k.  Streams are ordered by the
    kernel's register bucket and each bucket is padded to whole warps, so
    every warp takes one branch of the bucket switch."""
    ks = np.asarray(ks, dtype=np.int64)
    bucket = np.searchsorted(_BUCKETS, ks)   # len(_BUCKETS): generic
    cols = []
    for b in np.unique(bucket):
        idx = np.flatnonzero(bucket == b)
        pad = -len(idx) % _WARP
        stream = np.concatenate([idx, np.full(pad, -1)])
        cols.append(np.stack([stream, np.concatenate(
            [ks[idx], np.full(pad, 1)])]))
    return np.ascontiguousarray(np.concatenate(cols, axis=1), dtype=np.int32)


def fleet_fifo(ready: torch.Tensor, dur: torch.Tensor, offsets: torch.Tensor,
               ks: Sequence[int], free0: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """S k-server FIFO streams in one launch.

    ``ready``/``dur`` f64 [total], stream s at ``offsets[s]:offsets[s+1]``
    (``offsets`` int64 [S + 1], non-decreasing, from 0 to total); ``ks``
    the S server counts (host ints, each >= 1); ``free0`` f64 [S, kmax]
    with kmax >= max(ks), stream s's initial free times in its first
    ``ks[s]`` columns.  Returns ``ends`` f64 [total] and the final free
    times f64 [S, kmax] (first ``ks[s]`` columns of row s, unsorted)."""
    S = len(ks)
    if offsets.dtype != torch.int64 or offsets.shape != (S + 1,):
        raise ValueError(f"offsets must be int64 [{S + 1}], got "
                         f"{offsets.dtype} {tuple(offsets.shape)}")
    for name, t in (("ready", ready), ("dur", dur), ("free0", free0)):
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
    if ready.dim() != 1 or dur.shape != ready.shape:
        raise ValueError(f"ready and dur must be one [total] shape, got "
                         f"{tuple(ready.shape)} and {tuple(dur.shape)}")
    kmax = max(ks, default=1)
    if free0.dim() != 2 or free0.shape[0] != S or free0.shape[1] < kmax:
        raise ValueError(f"free0 must be [{S}, >= {kmax}], got "
                         f"{tuple(free0.shape)}")
    if min(ks, default=1) < 1:
        raise ValueError("every stream needs k >= 1")
    dev = ready.device
    if any(t.device != dev for t in (dur, offsets, free0)):
        raise ValueError("ready, dur, offsets and free0 must be on one device")
    if dev.type == "cpu":
        return fleet_fifo_ref(ready, dur, offsets, ks, free0)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not all(t.is_contiguous() for t in (ready, dur, offsets, free0)):
        raise ValueError("kernel takes contiguous tensors")
    if S == 0:
        return torch.empty_like(ready), torch.empty_like(free0)
    return launch(ready, dur, offsets,
                  torch.from_numpy(warp_lanes(ks)).to(dev), free0)


def launch(ready, dur, offsets, lanes, free0):
    """The kernel alone, on checked contiguous CUDA tensors and the thread
    layout ``lanes`` (``warp_lanes(ks)`` on the same device)."""
    global launches
    fn, err_str = _kernel()
    ends = torch.empty_like(ready)
    state = torch.empty_like(free0)
    stream = torch.cuda.current_stream(ready.device).cuda_stream
    err = fn(ready.data_ptr(), dur.data_ptr(), offsets.data_ptr(),
             lanes.data_ptr(), free0.data_ptr(), ends.data_ptr(),
             state.data_ptr(), lanes.shape[1], free0.shape[1],
             ready.device.index if ready.device.index is not None
             else torch.cuda.current_device(), stream)
    if err != 0:
        raise RuntimeError(
            f"fleet_fifo kernel launch failed: {err_str(err).decode()} "
            f"(cuda error {err})")
    launches += 1
    return ends, state
