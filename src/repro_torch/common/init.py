"""Parameter initializers on an explicit ``torch.Generator`` and device.

Counterpart of ``repro.common.init``: the same scale conventions, drawn
from torch's generator instead of ``jax.random`` (the numbers differ, the
distributions do not).  The generator must live on ``device``.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch


# A leaf of another dtype than float32 is drawn into its finished tensor a
# chunk of this many elements at a time: a whole stacked leaf's float32
# draw, freed beside its cast copy, would leave holes of many GB in the
# card's memory.  A multiple of 16, and the last chunk takes the rest of
# the leaf, so the CPU's generator gives the numbers of one draw (its normal
# fills blocks of 16 and redraws a short tail).
DRAW_CHUNK = 1 << 26


def _draw(shape, device, dtype, fill) -> torch.Tensor:
    """Draws are made in float32 and cast, as the reference does: ``fill``
    draws into a float32 tensor in place."""
    if torch.device(device).type == "meta":  # the dry run: shapes, no draw
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    if dtype == torch.float32:
        return fill(torch.empty(tuple(shape), dtype=dtype, device=device))
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    flat, lo = out.view(-1), 0
    while lo < flat.numel():
        hi = lo + DRAW_CHUNK
        if flat.numel() - lo < 2 * DRAW_CHUNK:
            hi = flat.numel()
        flat[lo:hi].copy_(fill(torch.empty(hi - lo, dtype=torch.float32,
                                           device=device)))
        lo = hi
    return out


def normal_init(shape: Sequence[int], *, generator: torch.Generator,
                device: torch.device, stddev: float = 0.02,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return _draw(shape, device, dtype,
                 lambda x: x.normal_(0.0, stddev, generator=generator))


def uniform_init(shape: Sequence[int], scale: float, *,
                 generator: torch.Generator, device: torch.device,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return _draw(shape, device, dtype,
                 lambda x: x.uniform_(-scale, scale, generator=generator))


def he_init(shape: Sequence[int], *, generator: torch.Generator,
            device: torch.device, dtype: torch.dtype = torch.float32
            ) -> torch.Tensor:
    """Kaiming-normal for ReLU MLPs (fan_in = shape[0])."""
    return normal_init(shape, generator=generator, device=device,
                       stddev=math.sqrt(2.0 / shape[0]), dtype=dtype)


def xavier_init(shape: Sequence[int], *, generator: torch.Generator,
                device: torch.device, dtype: torch.dtype = torch.float32
                ) -> torch.Tensor:
    scale = math.sqrt(6.0 / (shape[0] + shape[-1]))
    return uniform_init(shape, scale, generator=generator, device=device,
                        dtype=dtype)


def embedding_init(shape: Sequence[int], *, generator: torch.Generator,
                   device: torch.device, dtype: torch.dtype = torch.float32
                   ) -> torch.Tensor:
    """DLRM convention: U(-1/sqrt(vocab), 1/sqrt(vocab))."""
    return uniform_init(shape, 1.0 / math.sqrt(shape[0]), generator=generator,
                        device=device, dtype=dtype)
