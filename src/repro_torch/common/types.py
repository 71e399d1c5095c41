"""Common typed configuration objects shared across the port.

Counterpart of ``repro.common.types``: the family-agnostic shape specs and
the dtype table, with ``dtype_of`` resolving to torch dtypes.  Also holds
``resolve_device``, the one place the port decides where work runs.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Mapping

import torch


class ArchKind(enum.Enum):
    """Model family — drives which step functions and shardings exist."""

    LM_DENSE = "lm_dense"
    LM_MOE = "lm_moe"
    GNN = "gnn"
    RECSYS = "recsys"


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell assigned to an architecture (see
    ``repro.common.types.ShapeSpec`` for the meaning of ``step``)."""

    name: str
    step: str
    dims: Mapping[str, Any]

    def __getitem__(self, key: str) -> Any:
        return self.dims[key]

    def get(self, key: str, default: Any = None) -> Any:
        return self.dims.get(key, default)


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a tensor that is not allocated (the port's
    ``jax.ShapeDtypeStruct``)."""

    shape: tuple[int, ...]
    dtype: torch.dtype


_DTYPES = {
    "bf16": torch.bfloat16,
    "f32": torch.float32,
    "f16": torch.float16,
    "i32": torch.int32,
    "i64": torch.int64,
    "u32": torch.uint32,
    "bool": torch.bool,
}


def dtype_of(name: str) -> torch.dtype:
    """Resolve a dtype name ('bf16'/'f32'/'i32'/...) to a torch dtype."""
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype name: {name!r}")
    return _DTYPES[name]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on.

    ``"cuda"`` (the default everywhere in the port) requires a card and
    raises without one: the port never moves work to the CPU unasked.
    ``"meta"`` is the dry run's (``repro_torch.launch.dryrun``): tensors of
    the card's shapes that hold no data and compute nothing.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev
