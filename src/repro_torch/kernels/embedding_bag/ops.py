"""Hot embedding bag (K1): the plain version on CPU tensors, the CUDA
kernel on CUDA tensors.

Replaces ``repro/kernels/embedding_bag/embedding_bag.py``
``hot_embedding_bag_pallas`` (wrapper ``repro/kernels/embedding_bag/ops.py``
``hot_embedding_bag``), which pins the hot table in TPU VMEM.

On an H100 the kernel is bound by bytes: every valid id gathers one
``D``-row from HBM (or from the 50 MB L2 for hot rows) for ``D`` adds.  The
CUDA design (``csrc/embedding_bag.cu``) reads each gathered row once with
16-byte vector loads, keeps several rows of one bag in flight per warp,
skips masked ids without a load, and writes each pooled row once.

Which version runs is decided by where the caller put the tensors, never
by what is installed: a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag.embedding_bag import hot_embedding_bag_cuda
from repro_torch.kernels.embedding_bag.ref import hot_embedding_bag_ref

# Kernel launches since the last reset (set it to 0 to start a count).
launches = 0

_MAX_ROWS = 2**31  # ids are int32


def hot_embedding_bag(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Fused hot-table SLS: table [H, D], ids [B, P] int32 (-1 padded) ->
    pooled [B, D] in the table's dtype, accumulated in float32.

    Unlike the reference wrapper there is no ``tile_b``: any B is exact."""
    global launches
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"expected table [H, D] and ids [B, P], got "
                         f"{tuple(table.shape)} and {tuple(ids.shape)}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if table.device != ids.device:
        raise ValueError(f"table on {table.device} but ids on {ids.device}")
    if table.device.type == "cpu":
        return hot_embedding_bag_ref(table, ids)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel takes float32 or bfloat16 tables, got "
                        f"{table.dtype}")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError("kernel takes contiguous table and ids")
    if table.shape[0] >= _MAX_ROWS:
        raise ValueError(f"table has {table.shape[0]} rows; int32 ids "
                         f"address fewer than 2**31")
    B, D = ids.shape[0], table.shape[1]
    if B == 0 or D == 0:
        return torch.zeros((B, D), dtype=table.dtype, device=table.device)
    out = hot_embedding_bag_cuda(table, ids)
    launches += 1
    return out
