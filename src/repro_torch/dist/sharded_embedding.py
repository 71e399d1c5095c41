"""Model-axis-sharded embedding lookup: the distributed SparseNet.

Counterpart of ``repro.dist.sharded_embedding``.  The combined embedding
table is row-sharded over the "model" mesh axis
(``repro_torch.dist.sharding.param_spec_tree``): the rank at model index
i holds rows [i * R, (i + 1) * R) of the table's ``W * R``.  The reference
pins that layout and lets GSPMD lower the gather to the paper's Psum
dataflow; here the dataflow is written out: every rank gathers the rows it
owns (a masked local gather, zero elsewhere), and one ``all_reduce`` over
the "model" group sums the partial results.  No rank ever holds the whole
table, and nothing [.., table]-sized crosses a link.

Each function is its single-device counterpart where no "model" axis is
bound (``repro_torch.models.embedding`` routes on the binding).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives, logical


def row_window(table_shard: torch.Tensor) -> tuple[int, int]:
    """The global rows [lo, hi) this rank's shard of a table holds."""
    rows = table_shard.shape[0]
    lo = logical.shard_index(logical.current_mesh(),
                             logical.model_axis_name()) * rows
    return lo, lo + rows


def _model_group():
    return logical.group(logical.model_axis_name())


def sharded_row_gather(table_shard: torch.Tensor, rows: torch.Tensor
                       ) -> torch.Tensor:
    """Rows of a row-sharded table: ``rows`` (global row ids, any int
    shape, each in [0, W * R)) -> ``rows.shape + (dim,)`` in the table's
    dtype, the same on every rank of the "model" group.  Each rank reads
    the rows it owns and zeros elsewhere; the ``all_reduce`` adds exactly
    one non-zero term a row, so the result is the rows themselves.
    Without a binding, a plain gather from the whole table."""
    if logical.model_axis_name() is None:
        return F.embedding(rows.long(), table_shard)
    lo, hi = row_window(table_shard)
    rows = rows.long()
    mine = (rows >= lo) & (rows < hi)
    out = F.embedding((rows - lo).clamp(0, hi - lo - 1), table_shard)
    out = out * mine[..., None].to(out.dtype)
    return collectives.all_reduce(out.contiguous(), _model_group())


def embedding_bag_sharded(params, ids: torch.Tensor, cfg) -> torch.Tensor:
    """Multi-hot gather + pool against the row-sharded combined table.

    ``params["table"]``: this rank's rows [lo, hi) of the combined table;
    ids: [B, F, P] int32, -1 padded, this rank's batch block ("batch" over
    the data axes; the ids are the same on every rank of the "model"
    group) -> pooled [B, F, dim] in the table's dtype, that batch block.

    Non-QR features pool through K1's row-window entry, which reads only
    this rank's rows, into a float32 partial; one float32 ``all_reduce``
    over "model" sums the partials, and the sum is cast to the table's
    dtype once, so a bf16 table rounds once, as the single-device K1 does
    (a bf16 partial summed in bf16 would round twice).  QR features gather
    their quotient and remainder rows with ``sharded_row_gather`` (one more
    ``all_reduce``) and pool as ``embedding_bag_local`` does; ``mean``
    divides last.  No gradient through the shard yet: a table that
    requires grad raises."""
    from repro_torch.kernels.embedding_bag import embedding_bag_features
    from repro_torch.models.embedding import _gather_qr_feature, routed_offsets

    table = params["table"]
    if table.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "embedding_bag_sharded: no gradient through a row-sharded table "
            "yet; it comes with the sharded train cells")
    if ids.shape[1] != cfg.num_features:
        raise ValueError(f"expected {cfg.num_features} features, got "
                         f"{ids.shape[1]}")
    window = row_window(table)
    ids = ids.contiguous()
    partial = embedding_bag_features(table, ids,
                                     routed_offsets(cfg, ids.device),
                                     row_window=window,
                                     out_dtype=torch.float32)
    pooled = collectives.all_reduce(partial, _model_group()).to(table.dtype)
    if cfg.qr_features or cfg.combine == "mean":
        valid = ids >= 0
    for f in cfg.qr_features:
        rows = _gather_qr_feature(table, ids[:, f, :], f, cfg)  # [B, P, dim]
        pooled[:, f] = (rows * valid[:, f, :, None].to(rows.dtype)).sum(dim=1)
    if cfg.combine == "mean":
        counts = valid.sum(dim=2, keepdim=True).to(table.dtype).clamp_min(1.0)
        pooled = pooled / counts
    return pooled
