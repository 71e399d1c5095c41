"""Parameter initializers on an explicit ``torch.Generator`` and device.

Counterpart of ``repro.common.init``: the same scale conventions, drawn
from torch's generator instead of ``jax.random`` (the numbers differ, the
distributions do not).  The generator must live on ``device``.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch


def _f32(shape, device):
    """Draws are made in float32 and cast, as the reference does."""
    return torch.empty(tuple(shape), dtype=torch.float32, device=device)


def normal_init(shape: Sequence[int], *, generator: torch.Generator,
                device: torch.device, stddev: float = 0.02,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    if torch.device(device).type == "meta":  # the dry run: shapes, no draw
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    x = _f32(shape, device).normal_(0.0, stddev, generator=generator)
    return x.to(dtype)


def uniform_init(shape: Sequence[int], scale: float, *,
                 generator: torch.Generator, device: torch.device,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    if torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    x = _f32(shape, device).uniform_(-scale, scale, generator=generator)
    return x.to(dtype)


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
