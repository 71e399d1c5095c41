"""Plain PyTorch version of the fused hot-embedding SparseLengthsSum.

Counterpart of ``repro.kernels.embedding_bag.ref``; also the CPU path of
``ops.hot_embedding_bag`` and ``ops.embedding_bag_features`` and the oracle
the CUDA kernel is held against.
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


def shift_feature_ids(ids: torch.Tensor, row_offsets: torch.Tensor
                      ) -> torch.Tensor:
    """Per-feature ids [B, F, P] -> combined-table ids [B, F, P] int64:
    ``ids + row_offsets[f]`` where both are >= 0, else -1 (a negative offset
    masks its whole feature)."""
    off = row_offsets.to(device=ids.device, dtype=torch.int64)[None, :, None]
    return torch.where((ids >= 0) & (off >= 0), ids.long() + off, -1)


def embedding_bag_features_ref(table: torch.Tensor, ids: torch.Tensor,
                               row_offsets: torch.Tensor) -> torch.Tensor:
    """table [H, D]; ids [B, F, P] int (-1 padded); row_offsets [F] int64
    -> pooled [B, F, D]: the shift, then ``hot_embedding_bag_ref``."""
    B, F, P = ids.shape
    shifted = shift_feature_ids(ids, row_offsets).reshape(B * F, P)
    return hot_embedding_bag_ref(table, shifted).reshape(B, F, table.shape[1])
