"""Fleet FIFO solver (K4): the plain version on CPU tensors, the CUDA kernel
on CUDA tensors.

Replaces the reference's jitted ``lax.scan``
(``repro/serving/event_core.py`` ``_load_jax.fleet_scan``, driven by
``fleet_fifo_finish`` and ``_run_fleet_group``), the one piece of device
code an event-core cluster day runs.  It solves S independent k-server
FIFO streams, bitwise what ``engine._sweep`` gives for each, and returns
each stream's final free times sorted, as ``_sweep`` does.

On an H100 the kernel is bound by each stream's dependent chain, not by
bytes.  The first kernel read each lane's jobs straight from device memory
and kept k = 17..32 in a 32-slot bucket that ptxas put in local memory
(1,478 ns a step there).  ``csrc/fleet_fifo.cu`` now runs one thread a
stream with the k free times sorted in registers (an exact instance for
every k up to 32: a step is a compare and two selects a slot, the compares
independent of each other).  A second warp of each block stages the jobs
of the block's 32 streams through shared memory with ``cp.async`` a chunk
ahead of the recurrence and writes the ends back coalesced, so what binds
the kernel is the step's instruction issue.  Every stream of a call goes
in one launch; ``warp_lanes`` gives each block streams of one instance,
longest first.

``fleet_fifo_streams`` is the event core's entry: it packs the host arrays
into one buffer (pinned on a card), copies it in once, launches, and copies
ends and states back once.

Which version runs is decided by where the caller put the tensors, never
by what is installed: a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from collections.abc import Sequence
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fleet_fifo.ref import fleet_fifo_ref

# Kernel launches since the last reset (set it to 0 to start a count).
launches = 0

_WARP = 32
_MAX_REG = 32  # largest k with a register instance in csrc/fleet_fifo.cu
CHUNK = 128    # jobs of a stream a shared-memory stage holds (kChunk there)
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


def warp_lanes(ks: Sequence[int], ns: Sequence[int]) -> np.ndarray:
    """The kernel's thread layout: int32 [2, n_lanes], row 0 the stream of
    each thread (-1 for none), row 1 its k.  Streams are grouped by the
    kernel's instance (k itself up to 32, one generic instance above),
    longest first inside a group (``ns``: the streams' lengths, so a warp's
    lanes end close together), and each group is padded to whole warps
    whose empty lanes carry the group's k, so every warp takes one branch
    of the instance switch."""
    ks = np.asarray(ks, dtype=np.int64)
    ns = np.asarray(ns, dtype=np.int64)
    S = len(ks)
    if S == 0:
        return np.empty((2, 0), dtype=np.int32)
    inst = np.minimum(ks, _MAX_REG + 1)
    order = np.lexsort((-ns, inst))
    inst_o = inst[order]
    first = np.flatnonzero(np.r_[True, inst_o[1:] != inst_o[:-1]])
    count = np.diff(np.r_[first, S])
    width = -(-count // _WARP) * _WARP
    group = np.repeat(np.arange(len(first)), count)
    pos = np.r_[0, np.cumsum(width)[:-1]][group] + np.arange(S) - first[group]
    lanes = np.empty((2, int(width.sum())), dtype=np.int32)
    lanes[0] = -1
    lanes[1] = np.repeat(ks[order][first], width)
    lanes[0, pos] = order
    lanes[1, pos] = ks[order]
    return lanes


@dataclass(frozen=True)
class Layout:
    """Byte layout of one packed call, the same in the host buffer and in
    its copy on the card: ``ready``, ``dur`` f64 [total], ``free0`` f64
    [S, kmax], ``offsets`` int64 [S + 1], ``lanes`` int32 [2, n_lanes];
    every field starts at a multiple of 8 bytes."""
    total: int
    streams: int
    kmax: int
    n_lanes: int

    def fields(self):
        S, T = self.streams, self.total
        return (("ready", torch.float64, (T,)), ("dur", torch.float64, (T,)),
                ("free0", torch.float64, (S, self.kmax)),
                ("offsets", torch.int64, (S + 1,)),
                ("lanes", torch.int32, (2, self.n_lanes)))

    @property
    def nbytes(self) -> int:
        return sum(_field_bytes(dt, shape) for _, dt, shape in self.fields())

    def views(self, buf: torch.Tensor) -> dict[str, torch.Tensor]:
        """Typed views of the fields in ``buf`` (uint8 [nbytes])."""
        out, at = {}, 0
        for name, dt, shape in self.fields():
            n = int(np.prod(shape)) * dt.itemsize
            out[name] = buf[at:at + n].view(dt).view(shape)
            at += _field_bytes(dt, shape)
        return out


def _field_bytes(dt, shape) -> int:
    return -(-int(np.prod(shape)) * dt.itemsize // 8) * 8


def pack(ready: Sequence[np.ndarray], dur: Sequence[np.ndarray],
         ks: Sequence[int], free0: Sequence[np.ndarray | None],
         pin: bool = False) -> tuple[Layout, torch.Tensor]:
    """The S streams (f64 arrays ``ready[s]``, ``dur[s]``, server count
    ``ks[s]``, initial free times ``free0[s]`` of length ``ks[s]`` or None
    for zeros) in one uint8 host buffer (pinned if ``pin``) of
    ``Layout``: the ragged layout, its offsets, the thread layout."""
    ks = np.asarray(ks, dtype=np.int64)
    ns = np.fromiter((len(r) for r in ready), dtype=np.int64, count=len(ks))
    lanes = warp_lanes(ks, ns)
    layout = Layout(total=int(ns.sum()), streams=len(ks),
                    kmax=int(ks.max(initial=1)), n_lanes=lanes.shape[1])
    buf = torch.empty(layout.nbytes, dtype=torch.uint8, pin_memory=pin)
    v = {k: t.numpy() for k, t in layout.views(buf).items()}
    if layout.total:
        np.concatenate(ready, out=v["ready"])
        np.concatenate(dur, out=v["dur"])
    v["offsets"][0] = 0
    np.cumsum(ns, out=v["offsets"][1:])
    f0 = v["free0"]
    f0[:] = np.inf
    if layout.streams:
        f0[np.arange(layout.kmax)[None, :] < ks[:, None]] = np.concatenate(
            [np.zeros(k) if f is None else f for f, k in zip(free0, ks)])
    v["lanes"][:] = lanes
    return layout, buf


def fleet_fifo_streams(ready: Sequence[np.ndarray], dur: Sequence[np.ndarray],
                       ks: Sequence[int], free0: Sequence[np.ndarray | None],
                       device: torch.device
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """S streams given as host arrays (as ``pack`` takes them) in one call:
    on a CUDA ``device`` one pinned buffer copied in once, one launch, ends
    and states copied back once; on the CPU the plain version on the same
    buffer.  Returns ``ends`` f64 [total] (stream s at
    ``offsets[s]:offsets[s + 1]``), the final free times f64 [S, kmax]
    (row s sorted ascending in its first ``ks[s]`` columns, +inf past
    them) and ``offsets``, all numpy."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    layout, buf = pack(ready, dur, ks, free0, pin=on_card)
    offsets = layout.views(buf)["offsets"].numpy().copy()
    if layout.streams == 0:
        return np.zeros(0), np.zeros((0, layout.kmax)), offsets
    if not on_card:
        v = layout.views(buf)
        ends, state = fleet_fifo_ref(v["ready"], v["dur"], v["offsets"],
                                     [int(k) for k in ks], v["free0"])
        return ends.numpy(), state.numpy(), offsets
    v = layout.views(buf.to(device, non_blocking=True))
    out = torch.empty(layout.total + layout.streams * layout.kmax,
                      dtype=torch.float64, device=device)
    ends = out[:layout.total]
    state = out[layout.total:].view(layout.streams, layout.kmax)
    launch(v["ready"], v["dur"], v["offsets"], v["lanes"], v["free0"],
           ends=ends, state=state)
    host = out.cpu().numpy()
    return (host[:layout.total],
            host[layout.total:].reshape(layout.streams, layout.kmax), offsets)


def fleet_fifo(ready: torch.Tensor, dur: torch.Tensor, offsets: torch.Tensor,
               ks: Sequence[int], free0: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """S k-server FIFO streams in one launch.

    ``ready``/``dur`` f64 [total], stream s at ``offsets[s]:offsets[s+1]``
    (``offsets`` int64 [S + 1], non-decreasing, from 0 to total); ``ks``
    the S server counts (host ints, each >= 1); ``free0`` f64 [S, kmax]
    with kmax >= max(ks), stream s's initial free times in its first
    ``ks[s]`` columns.  Returns ``ends`` f64 [total] and the final free
    times f64 [S, kmax] (first ``ks[s]`` columns of row s sorted
    ascending, +inf past them)."""
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
    ns = np.diff(offsets.cpu().numpy())
    return launch(ready, dur, offsets,
                  torch.from_numpy(warp_lanes(ks, ns)).to(dev), free0)


def launch(  # repro: ignore[kernel-no-plain] CUDA tensors only; its callers fleet_fifo and fleet_fifo_streams take the plain version
        ready, dur, offsets, lanes, free0, *, ends=None, state=None):
    """The kernel alone, on checked contiguous CUDA tensors and the thread
    layout ``lanes`` (``warp_lanes(ks, ns)`` on the same device); ``ends``
    and ``state`` may be given, contiguous, for it to write into.  It has
    no plain path of its own: ``fleet_fifo`` and ``fleet_fifo_streams``,
    which call it, take ``fleet_fifo_ref`` on CPU tensors."""
    global launches
    fn, err_str = _kernel()
    ends = torch.empty_like(ready) if ends is None else ends
    state = torch.empty_like(free0) if state is None else state
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
