"""Hot embedding bag (K1): the plain version on CPU tensors, the CUDA
kernel on CUDA tensors.

Replaces ``repro/kernels/embedding_bag/embedding_bag.py``
``hot_embedding_bag_pallas`` (wrapper ``repro/kernels/embedding_bag/ops.py``
``hot_embedding_bag``), which pins the hot table in TPU VMEM.

On an H100 the kernel is bound by bytes, once enough rows are in flight:
every valid id gathers one ``D``-row from HBM (or from the 50 MB L2 for hot
rows) for ``D`` adds.  The CUDA design (``csrc/embedding_bag.cu``) gives
each bag a team of four lane groups, each as wide as a row (a warp a bag
at 128-byte rows), compacts the bag's valid ids so padding costs no load,
has each group issue 4 independent 16-byte row loads before its adds (16
rows a bag in flight) while the next ids load, sums each bag in a fixed
order in fp32, and sizes the grid to one wave of resident warps.

Two entries share the kernel: ``hot_embedding_bag`` (ids [B, P] into the
table) and ``embedding_bag_features`` (ids [B, F, P] per feature, shifted
by ``row_offsets[f]`` inside the kernel in 64 bits).

Which version runs is decided by where the caller put the tensors, never
by what is installed: a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag.embedding_bag import embedding_bag_cuda
from repro_torch.kernels.embedding_bag.ref import (
    embedding_bag_features_ref,
    hot_embedding_bag_ref,
)

# Kernel launches since the last reset (set it to 0 to start a count).
launches = 0

_MAX_ROWS = 2**31  # ids are int32


def _check_table(table: torch.Tensor, ids: torch.Tensor) -> None:
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if table.device != ids.device:
        raise ValueError(f"table on {table.device} but ids on {ids.device}")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {table.device}")
    if table.device.type == "cuda":
        if table.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"kernel takes float32 or bfloat16 tables, got "
                            f"{table.dtype}")
        if not (table.is_contiguous() and ids.is_contiguous()):
            raise ValueError("kernel takes contiguous table and ids")


def _launch(table, ids, row_offsets=None) -> torch.Tensor:
    global launches
    if ids.numel() == 0 or table.shape[1] == 0:
        return torch.zeros((*ids.shape[:-1], table.shape[1]),
                           dtype=table.dtype, device=table.device)
    out = embedding_bag_cuda(table, ids, row_offsets)
    launches += 1
    return out


def hot_embedding_bag(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Fused hot-table SLS: table [H, D], ids [B, P] int32 (-1 padded) ->
    pooled [B, D] in the table's dtype, accumulated in float32.

    Unlike the reference wrapper there is no ``tile_b``: any B is exact."""
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"expected table [H, D] and ids [B, P], got "
                         f"{tuple(table.shape)} and {tuple(ids.shape)}")
    _check_table(table, ids)
    if table.device.type == "cpu":
        return hot_embedding_bag_ref(table, ids)
    if table.shape[0] >= _MAX_ROWS:
        raise ValueError(f"table has {table.shape[0]} rows; int32 ids "
                         f"address fewer than 2**31")
    return _launch(table, ids)


def embedding_bag_features(table: torch.Tensor, ids: torch.Tensor,
                           row_offsets: torch.Tensor) -> torch.Tensor:
    """Per-feature SLS: table [H, D], ids [B, F, P] int32 (-1 padded),
    row_offsets [F] int64 on the same device -> pooled [B, F, D] in the
    table's dtype, accumulated in float32.

    Feature f's ids address rows ``ids + row_offsets[f]`` (added in 64
    bits); a negative offset leaves feature f unrouted: it pools to exactly
    zero.  One launch for all B * F bags."""
    if table.dim() != 2 or ids.dim() != 3:
        raise ValueError(f"expected table [H, D] and ids [B, F, P], got "
                         f"{tuple(table.shape)} and {tuple(ids.shape)}")
    _check_table(table, ids)
    if (row_offsets.dim() != 1 or row_offsets.shape[0] != ids.shape[1]
            or row_offsets.dtype != torch.int64):
        raise ValueError(f"row_offsets must be int64 [{ids.shape[1]}], got "
                         f"{row_offsets.dtype} {tuple(row_offsets.shape)}")
    if row_offsets.device != ids.device:
        raise ValueError(f"row_offsets on {row_offsets.device} but ids on "
                         f"{ids.device}")
    if table.device.type == "cpu":
        return embedding_bag_features_ref(table, ids, row_offsets)
    if not row_offsets.is_contiguous():
        raise ValueError("kernel takes contiguous row_offsets")
    return _launch(table, ids, row_offsets)
