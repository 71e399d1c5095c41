"""Plain PyTorch version of the fused hot-embedding SparseLengthsSum and of
its table gradient.

Counterpart of ``repro.kernels.embedding_bag.ref``; also the CPU path of
``ops.hot_embedding_bag`` and ``ops.embedding_bag_features`` (and of their
gradients) and the oracle the CUDA kernels are held against.  Sums are
taken in float32, or float64 for a float64 table (``gradcheck``).
"""
from __future__ import annotations

import torch


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def hot_embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor,
                          weights: torch.Tensor | None = None) -> torch.Tensor:
    """table [H, D]; ids [B, P] int (-1 padded); optional per-sample weights
    [B, P] -> pooled [B, D] in the table's dtype (summed in float32)."""
    acc = _acc_dtype(table.dtype)
    mask = ids >= 0
    rows = table[ids.clamp_min(0).long()].to(acc)       # [B, P, D]
    w = mask.to(acc)
    if weights is not None:
        w = w * weights.to(acc)
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


def embedding_bag_window_ref(table: torch.Tensor, ids: torch.Tensor,
                             row_offsets: torch.Tensor, row_window,
                             out_dtype: torch.dtype | None = None
                             ) -> torch.Tensor:
    """The row-window form of ``embedding_bag_features_ref``: ``table``
    [hi - lo, D] holds rows [lo, hi) of the combined table; id p of feature
    f is live iff p >= 0, ``row_offsets[f]`` >= 0 and lo <= p +
    row_offsets[f] < hi, and reads local row p + row_offsets[f] - lo.  ->
    pooled [B, F, D] in ``out_dtype`` (the table's by default), summed in
    float32."""
    lo, hi = row_window
    B, F, P = ids.shape
    out_dtype = table.dtype if out_dtype is None else out_dtype
    if table.shape[0] == 0:  # a shard of no rows: nothing is live
        return torch.zeros((B, F, table.shape[1]), dtype=out_dtype,
                           device=table.device)
    g = shift_feature_ids(ids, row_offsets)
    local = torch.where((g >= lo) & (g < hi), g - lo, -1).reshape(B * F, P)
    acc = _acc_dtype(table.dtype)
    mask = local >= 0
    rows = table[local.clamp_min(0)].to(acc)
    pooled = (rows * mask[..., None].to(acc)).sum(dim=1)
    return pooled.to(out_dtype).reshape(B, F, table.shape[1])


def hot_embedding_bag_grad_ref(grad: torch.Tensor, ids: torch.Tensor,
                               n_rows: int) -> torch.Tensor:
    """The table gradient of ``hot_embedding_bag_ref`` (no weights): grad
    [B, D] (of the pooled output), ids [B, P] int (-1 padded) -> [n_rows, D]
    in grad's dtype.  An ``index_add_`` in float32 of each valid (bag,
    slot)'s gradient row into the row it read: an id twice in a bag counts
    twice, padding gives nothing."""
    B, P = ids.shape
    valid = ids >= 0
    rows = ids[valid].long()
    bags = torch.arange(B, device=ids.device)[:, None].expand(B, P)[valid]
    acc = _acc_dtype(grad.dtype)
    out = torch.zeros((n_rows, grad.shape[1]), dtype=acc, device=grad.device)
    out.index_add_(0, rows, grad.to(acc)[bags])
    return out.to(grad.dtype)


def embedding_bag_features_grad_ref(grad: torch.Tensor, ids: torch.Tensor,
                                    row_offsets: torch.Tensor, n_rows: int,
                                    row_window=None) -> torch.Tensor:
    """The table gradient of ``embedding_bag_features_ref``: grad [B, F, D],
    ids [B, F, P], row_offsets [F] int64 -> [n_rows, D] in grad's dtype
    (the shift, then ``hot_embedding_bag_grad_ref``; an unrouted feature
    gives nothing).  With ``row_window=(lo, hi)`` (n_rows = hi - lo) the
    gradient of rows [lo, hi) of the combined table only, that of
    ``embedding_bag_window_ref``: a pair adds into local row id +
    row_offsets[f] - lo where that row lies in the window, and nowhere
    else."""
    B, F, P = ids.shape
    shifted = shift_feature_ids(ids, row_offsets)
    if row_window is not None:
        lo, hi = row_window
        if hi - lo != n_rows:
            raise ValueError(f"row_window ({lo}, {hi}) does not hold "
                             f"{n_rows} rows")
        shifted = torch.where((shifted >= lo) & (shifted < hi),
                              shifted - lo, -1)
    return hot_embedding_bag_grad_ref(grad.reshape(B * F, grad.shape[-1]),
                                      shifted.reshape(B * F, P), n_rows)


def grad_sorted_pairs_ref(ids: torch.Tensor, n_rows: int,
                          row_offsets: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The pairs K1's backward sums, in the order it sums them: ids [...,
    P] int (the last leading dim the feature when ``row_offsets`` [F] is
    given) -> (rows, flat indices), int32, of every slot that reads a row,
    sorted by row and then by flat index (bag * P + slot).  A slot reads
    row ``id + row_offsets[f]`` unless the id is padding (< 0), its feature
    is unrouted (offset < 0) or the row is at or past ``n_rows``."""
    rows = ids.long()
    if row_offsets is not None:
        rows = shift_feature_ids(ids, row_offsets)
    rows = rows.reshape(-1)
    flat = torch.arange(rows.numel(), device=rows.device)
    keep = (rows >= 0) & (rows < n_rows)
    rows, flat = rows[keep], flat[keep]
    order = torch.sort(rows, stable=True).indices
    return rows[order].to(torch.int32), flat[order].to(torch.int32)
