"""Plain PyTorch version of the fused hot-embedding SparseLengthsSum.

Counterpart of ``repro.kernels.embedding_bag.ref``; also the CPU path of
``ops.hot_embedding_bag`` and the oracle the CUDA kernel is held against.
"""
from __future__ import annotations

import torch


def hot_embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor,
                          weights: torch.Tensor | None = None) -> torch.Tensor:
    """table [H, D]; ids [B, P] int (-1 padded); optional per-sample weights
    [B, P] -> pooled [B, D] in the table's dtype (summed in float32)."""
    mask = ids >= 0
    rows = table[ids.clamp_min(0).long()].float()       # [B, P, D]
    w = mask.float()
    if weights is not None:
        w = w * weights.float()
    return (rows * w[..., None]).sum(dim=1).to(table.dtype)
