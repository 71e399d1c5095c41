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

Both carry gradients into the shard.  The ``all_reduce`` passes its
gradient through (``repro_torch.dist.collectives``), since every rank of
the "model" group consumes the sum alike; so each rank's backward is the
gradient of its own rows only: K1's backward through the same row window
for the pooled features, and the masked gather's for single rows (the QR
features, DIN's and MIND's item rows, an LM's vocab-sharded token
embedding).

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


def sharded_row_gather(table_shard: torch.Tensor, rows: torch.Tensor,
                       scatter_dim: int | None = None) -> torch.Tensor:
    """Rows of a row-sharded table: ``rows`` (global row ids, any int
    shape, each in [0, W * R)) -> ``rows.shape + (dim,)`` in the table's
    dtype, the same on every rank of the "model" group.  Each rank reads
    the rows it owns and zeros elsewhere; the ``all_reduce`` adds exactly
    one non-zero term a row, so the result is the rows themselves.  With
    ``scatter_dim`` a ``reduce_scatter`` along that dimension of ``rows``
    takes the all-reduce's place: this rank gets its block of the rows
    (an LM's sequence block under sequence parallelism), and each rank's
    table gradient is still that of its own rows for every row, since
    the backward all-gathers the blocks' cotangents.  Without a binding,
    a plain gather from the whole table."""
    if logical.model_axis_name() is None:
        return F.embedding(rows.long(), table_shard)
    lo, hi = row_window(table_shard)
    rows = rows.long()
    mine = (rows >= lo) & (rows < hi)
    out = F.embedding((rows - lo).clamp(0, hi - lo - 1), table_shard)
    out = out * mine[..., None].to(out.dtype)
    if scatter_dim is not None:
        return collectives.reduce_scatter(out, _model_group(), scatter_dim)
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
    divides last.  A table that requires grad gets the gradient of its
    rows [lo, hi): K1's window backward on the partial's cotangent, cast to
    the table's dtype first (exact: it holds values of that dtype, the
    cast after the sum having rounded to it)."""
    from repro_torch.kernels.embedding_bag import embedding_bag_features
    from repro_torch.models.embedding import _gather_qr_feature, routed_offsets

    table = params["table"]
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
    if cfg.qr_features and pooled.requires_grad:
        pooled = pooled.clone()  # autograd forbids writing the sum in place
    if cfg.qr_features or cfg.combine == "mean":
        valid = ids >= 0
    for f in cfg.qr_features:
        rows = _gather_qr_feature(table, ids[:, f, :], f, cfg)  # [B, P, dim]
        pooled[:, f] = (rows * valid[:, f, :, None].to(rows.dtype)).sum(dim=1)
    if cfg.combine == "mean":
        counts = valid.sum(dim=2, keepdim=True).to(table.dtype).clamp_min(1.0)
        pooled = pooled / counts
    return pooled
