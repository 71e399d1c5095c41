"""Plain PyTorch version of the fleet FIFO solver (K4).

Counterpart of the reference's jitted ``lax.scan`` step
(``repro.serving.event_core._load_jax.fleet_scan``); the CPU path of
``ops.fleet_fifo`` and what the CUDA kernel is held against.  It takes the
kernel's ragged layout and returns the kernel's outputs.
"""
from __future__ import annotations

from collections.abc import Sequence

import torch


def fleet_fifo_ref(ready: torch.Tensor, dur: torch.Tensor,
                   offsets: torch.Tensor, ks: Sequence[int],
                   free0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """S independent k-server FIFO streams, float64.

    ``ready``/``dur`` [total] hold stream s's jobs at
    ``offsets[s]:offsets[s + 1]`` (``offsets`` int64 [S + 1]); ``ks`` are
    the S server counts; ``free0`` [S, kmax] holds stream s's initial free
    times in its first ``ks[s]`` columns.  Returns ``ends`` [total] and the
    final free times [S, kmax] (the first ``ks[s]`` columns of row s sorted
    ascending, as ``engine._sweep`` returns them and the kernel writes
    them; the columns past them are +inf).

    A loop over time steps advancing every stream that still has a job at
    step t, as the JAX step does: a row-wise argmin, a gather, ``where``,
    an add and a one-hot masked write-back, then each row sorted once.  It
    runs on any device (the card check times it there); ``ops.fleet_fifo``
    takes it for CPU tensors only."""
    S, K = free0.shape
    cols = torch.arange(K, device=free0.device)
    real = cols[None, :] < torch.as_tensor(
        list(ks), dtype=torch.int64, device=free0.device)[:, None]
    W = torch.where(real, free0, torch.inf)
    ends = torch.empty_like(ready)
    lens = offsets[1:] - offsets[:-1]
    # streams longest first, so the live set at step t is a prefix
    order = torch.argsort(lens, descending=True, stable=True)
    starts = offsets[:-1][order]
    lens_sorted = lens[order]
    Ws = W[order]
    lens_list = lens_sorted.tolist()
    live = S
    for t in range(lens_list[0] if S else 0):
        while lens_list[live - 1] <= t:
            live -= 1
        Wa = Ws[:live]
        idx = starts[:live] + t
        am = Wa.argmin(dim=1)
        f = Wa.gather(1, am[:, None])[:, 0]
        r = ready[idx]
        e = torch.where(r > f, r, f) + dur[idx]
        hit = am[:, None] == cols[None, :]
        Ws[:live] = torch.where(hit, e[:, None], Wa)
        ends[idx] = e
    W[order] = Ws
    return ends, W.sort(dim=1).values
