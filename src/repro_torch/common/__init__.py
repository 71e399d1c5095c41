"""Shared primitives: typed configs, device resolution, init helpers."""
from repro_torch.common.init import (
    embedding_init,
    he_init,
    normal_init,
    uniform_init,
    xavier_init,
)
from repro_torch.common.types import ArchKind, ShapeSpec, dtype_of, resolve_device

__all__ = [
    "ArchKind",
    "ShapeSpec",
    "dtype_of",
    "resolve_device",
    "embedding_init",
    "he_init",
    "normal_init",
    "uniform_init",
    "xavier_init",
]
