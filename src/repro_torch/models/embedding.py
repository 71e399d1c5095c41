"""Embedding substrate: EmbeddingBag / SparseLengthsSum in PyTorch.

Counterpart of ``repro.models.embedding``.  The layout is the same: every
feature table is concatenated row-wise into ONE combined
``[total_rows, dim]`` tensor and feature ``f``'s ids are shifted by
``row_offsets[f]``, so the whole SparseNet is a single gather.

Pooling goes through the hot embedding-bag kernel K1
(``repro_torch.kernels.embedding_bag``, which carries autograd: its
backward is K1's gradient kernel): its per-feature entry takes the
``[B, F, P]`` ids as they are (``-1`` padded) with an int64 offset per
feature, built once per (config, device), and pools all ``B*F`` bags in one
launch.  Quotient-remainder features (a Hadamard product of two gathered
rows per id) are pooled with plain torch ops.

Hot/cold split (paper §IV-B): ``split_hot_cold`` re-lays the combined table
into a hot replica and a cold remainder, and ``embedding_bag_hot_cold``
pools both partial sums through K1.

Only single-device lookup is here; the reference's mesh-routed
``embedding_bag`` (row-sharded Psum) is ported with the distributed layer.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.embedding_bag import embedding_bag_features, hot_embedding_bag


@dataclasses.dataclass(frozen=True)
class EmbeddingConfig:
    """Combined multi-table embedding-bag configuration.

    vocab_sizes: rows per sparse feature table.
    dim: shared embedding dimension.
    pooling: max multi-hot pooling factor per feature (ids padded with -1).
    combine: "sum" (SparseLengthsSum) or "mean".
    qr_features: features using the quotient-remainder trick (huge vocabs);
        their storage is ``ceil(V/qr_buckets) + qr_buckets`` rows instead of V.
    """

    vocab_sizes: tuple[int, ...]
    dim: int
    pooling: tuple[int, ...]
    combine: str = "sum"
    qr_features: tuple[int, ...] = ()
    qr_buckets: int = 65536
    dtype: torch.dtype = torch.float32
    # combined table rows are padded to a multiple of this (the reference
    # shards rows evenly over any production mesh with it)
    row_pad: int = 512

    def __post_init__(self):
        if len(self.vocab_sizes) != len(self.pooling):
            raise ValueError("vocab_sizes and pooling must have equal length")
        if self.combine not in ("sum", "mean"):
            raise ValueError(f"unknown combine mode {self.combine!r}")

    @property
    def num_features(self) -> int:
        return len(self.vocab_sizes)

    def storage_rows(self, f: int) -> int:
        """Physical rows stored for feature f (QR-compressed if enabled)."""
        v = self.vocab_sizes[f]
        if f in self.qr_features:
            q = -(-v // self.qr_buckets)  # ceil
            return q + self.qr_buckets
        return v

    @property
    def row_offsets(self) -> np.ndarray:
        """Start row of each feature in the combined table; len = F+1."""
        sizes = [self.storage_rows(f) for f in range(self.num_features)]
        return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)

    @property
    def total_rows(self) -> int:
        raw = int(self.row_offsets[-1])
        return -(-raw // self.row_pad) * self.row_pad

    @property
    def max_pooling(self) -> int:
        return max(self.pooling)

    def bytes(self, dtype_bytes: int = 4) -> int:
        return self.total_rows * self.dim * dtype_bytes


def init_embedding(cfg: EmbeddingConfig, *, generator: torch.Generator,
                   device: torch.device) -> dict[str, torch.Tensor]:
    """One combined [total_rows, dim] table, DLRM uniform init per table:
    rows of feature f ~ U(-1/sqrt(V_f), 1/sqrt(V_f)), padding rows U(-1, 1)
    (the reference's scales).  Made in place on ``device`` from
    ``generator``, which must live there; drawn in the table's dtype, so a
    bf16 table never holds a float32 copy."""
    table = torch.empty((cfg.total_rows, cfg.dim), dtype=cfg.dtype,
                        device=device)
    table.uniform_(-1.0, 1.0, generator=generator)
    off = cfg.row_offsets
    for f in range(cfg.num_features):
        table[int(off[f]):int(off[f + 1])].mul_(
            1.0 / math.sqrt(cfg.vocab_sizes[f]))
    return {"table": table}


def _offsets(offsets: np.ndarray, device: torch.device) -> torch.Tensor:
    """Per-feature row offsets as an int32 [1, F, 1] tensor on ``device``."""
    return torch.as_tensor(np.asarray(offsets), dtype=torch.int32,
                           device=device)[None, :, None]


_ROUTED_OFFSETS: dict[tuple[EmbeddingConfig, torch.device], torch.Tensor] = {}


def routed_offsets(cfg: EmbeddingConfig, device: torch.device) -> torch.Tensor:
    """K1's per-feature row offsets, int64 [F] on ``device``: feature f's
    start row in the combined table, or -1 for a QR feature (K1 pools it to
    zero; it is pooled afterwards).  Built once per (config, device), so a
    launch copies nothing from the host; built outside inference mode, so
    a model trained after it served can save it for its backward."""
    key = (cfg, device)
    off = _ROUTED_OFFSETS.get(key)
    if off is None:
        host = cfg.row_offsets[:-1].copy()
        host[list(cfg.qr_features)] = -1
        with torch.inference_mode(False):
            off = torch.as_tensor(host, dtype=torch.int64, device=device)
        _ROUTED_OFFSETS[key] = off
    return off


def embedding_bag_local(params, ids: torch.Tensor, cfg: EmbeddingConfig
                        ) -> torch.Tensor:
    """Single-shard EmbeddingBag. ids: [B, F, Pmax] int32, -1-padded.

    Returns pooled embeddings [B, F, dim] in the table's dtype.  Non-QR
    features pool through K1 in one launch that reads the per-feature ids
    and adds each feature's row offset itself; QR features are left out of
    that launch (offset -1) and pooled with plain torch ops.  A table that
    requires grad gets its gradient through K1's backward (and through the
    QR features' gathers); under ``torch.inference_mode`` nothing records
    a graph."""
    table = params["table"]
    F = ids.shape[1]
    if F != cfg.num_features:
        raise ValueError(f"expected {cfg.num_features} features, got {F}")
    pooled = embedding_bag_features(table, ids.contiguous(),
                                    routed_offsets(cfg, ids.device))
    if cfg.qr_features and pooled.requires_grad:
        pooled = pooled.clone()  # autograd forbids writing K1's output
    if cfg.qr_features or cfg.combine == "mean":
        valid = ids >= 0
    for f in cfg.qr_features:
        rows = _gather_qr_feature(table, ids[:, f, :], f, cfg)  # [B, P, dim]
        pooled[:, f] = (rows * valid[:, f, :, None].to(rows.dtype)).sum(dim=1)
    if cfg.combine == "mean":
        counts = valid.sum(dim=2, keepdim=True).to(table.dtype).clamp_min(1.0)
        pooled = pooled / counts
    return pooled


def feature_rows(table: torch.Tensor, ids: torch.Tensor, f: int,
                 cfg: EmbeddingConfig) -> torch.Tensor:
    """Rows of feature ``f`` for int ids of any shape -> ``ids.shape +
    (dim,)``.  Negative ids read the feature's row 0; the caller masks
    them.  A QR feature gives ``quot * rem`` (``_gather_qr_feature``).

    The one-device counterpart of the reference's ``sharded_row_gather``
    at feature ``f``'s rows, as DIN's and MIND's item and profile lookups
    use it, but by the rule of the reference's ``_gather_with_qr``: the
    reference's DIN and MIND add ``row_offsets[0]`` to the raw item id even
    for a QR item table, which reads past that feature's storage.

    The rows are gathered by ``F.embedding`` (the reference's
    ``jnp.take``): its backward sums a row's repeats in segments, where
    indexing's (``index_put_``) walks a power-law id's thousands of repeats
    one at a time on a card."""
    if f in cfg.qr_features:
        return _gather_qr_feature(table, ids, f, cfg)
    return F.embedding(int(cfg.row_offsets[f]) + ids.clamp_min(0).long(),
                       table)


def _gather_qr_feature(table: torch.Tensor, fid: torch.Tensor, f: int,
                       cfg: EmbeddingConfig) -> torch.Tensor:
    """Rows of QR feature ``f`` for ids of any shape (padding reads row 0
    of the feature; the caller masks it).

    A QR feature of vocab V stores ``q = ceil(V/Q)`` quotient rows followed
    by ``Q`` remainder rows; emb(id) = quot[id // Q] * rem[id % Q]
    (Hadamard, the reference's ``_gather_with_qr``)."""
    safe = fid.clamp_min(0).long()
    base = int(cfg.row_offsets[f])
    q_rows = -(-cfg.vocab_sizes[f] // cfg.qr_buckets)
    quot = F.embedding(base + safe // cfg.qr_buckets, table)
    rem = F.embedding(base + q_rows + safe % cfg.qr_buckets, table)
    return quot * rem


def embedding_bag_ragged(table: torch.Tensor, ids: torch.Tensor,
                         segment_ids: torch.Tensor, num_segments: int,
                         combine: str = "sum") -> torch.Tensor:
    """Ragged EmbeddingBag: flat ids + segment ids -> [num_segments, dim].

    The reference's ``jnp.take`` + ``segment_sum`` as a gather +
    ``index_add_``; segment ids must lie in ``[0, num_segments)``."""
    rows = table[ids.long()]
    seg = segment_ids.long()
    out = torch.zeros((num_segments, table.shape[1]), dtype=rows.dtype,
                      device=rows.device).index_add_(0, seg, rows)
    if combine == "mean":
        ones = torch.ones((ids.shape[0], 1), dtype=rows.dtype,
                          device=rows.device)
        counts = torch.zeros((num_segments, 1), dtype=rows.dtype,
                             device=rows.device).index_add_(0, seg, ones)
        out = out / counts.clamp_min(1.0)
    return out


# ---------------------------------------------------------------------------
# Hot/cold locality-aware partition (paper §IV-B, Figure 10)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HotColdLayout:
    """Physical layout after locality-aware partition.

    hot_rows[f]: number of hottest rows of feature f replicated in the hot
    table; the remainder stays in the cold table.  Row offsets are
    recomputed for both tables.
    """

    cfg: EmbeddingConfig
    hot_rows: tuple[int, ...]

    @property
    def hot_offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.hot_rows)]).astype(np.int64)

    @property
    def cold_rows(self) -> tuple[int, ...]:
        return tuple(
            self.cfg.storage_rows(f) - self.hot_rows[f]
            for f in range(self.cfg.num_features)
        )

    @property
    def cold_offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.cold_rows)]).astype(np.int64)

    @property
    def total_hot(self) -> int:
        return int(self.hot_offsets[-1])

    @property
    def total_cold(self) -> int:
        return int(self.cold_offsets[-1])


def make_hot_cold_layout(
    cfg: EmbeddingConfig, capacity_rows: int,
    access_freq: Sequence[np.ndarray] | None = None,
) -> HotColdLayout:
    """Size the hot set under a row-capacity budget: tables share it in
    proportion to their access mass (``access_freq`` counts if given, else
    the pooling factors)."""
    F = cfg.num_features
    if access_freq is not None:
        mass = np.array([float(np.sum(a)) for a in access_freq], np.float64)
    else:
        mass = np.array(cfg.pooling, np.float64)
    mass = mass / mass.sum()
    hot = [
        int(min(cfg.storage_rows(f), np.floor(mass[f] * capacity_rows)))
        for f in range(F)
    ]
    return HotColdLayout(cfg=cfg, hot_rows=tuple(hot))


def split_hot_cold(params, layout: HotColdLayout) -> dict[str, torch.Tensor]:
    """Re-lay the combined table into {hot, cold} per the layout."""
    cfg = layout.cfg
    table = params["table"]
    hots, colds = [], []
    off = cfg.row_offsets
    for f in range(cfg.num_features):
        t = table[int(off[f]):int(off[f + 1])]
        hots.append(t[:layout.hot_rows[f]])
        colds.append(t[layout.hot_rows[f]:])
    hot = torch.cat(hots, dim=0) if layout.total_hot else \
        table.new_zeros((0, cfg.dim))
    return {"hot": hot, "cold": torch.cat(colds, dim=0)}


def embedding_bag_hot_cold(split_params, ids: torch.Tensor,
                           layout: HotColdLayout
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pooled lookup returning separate (hot_psum, cold_psum), each
    [B, F, D]; the caller adds them.  Each partial sum is one K1 launch
    over its own table, the other table's ids masked to -1."""
    cfg = layout.cfg
    B, F, P = ids.shape
    dev = ids.device
    hot_rows = _offsets(layout.hot_rows, dev)
    valid = ids >= 0
    is_hot = valid & (ids < hot_rows)
    is_cold = valid & ~is_hot

    cold_table = split_params["cold"]
    if layout.total_hot:
        hot_idx = torch.where(
            is_hot, ids + _offsets(layout.hot_offsets[:-1], dev), -1)
        hot_psum = hot_embedding_bag(
            split_params["hot"], hot_idx.reshape(B * F, P).contiguous()
        ).reshape(B, F, cfg.dim)
    else:
        hot_psum = torch.zeros((B, F, cfg.dim), dtype=cold_table.dtype,
                               device=dev)
    cold_idx = torch.where(
        is_cold, ids - hot_rows + _offsets(layout.cold_offsets[:-1], dev), -1)
    cold_psum = hot_embedding_bag(
        cold_table, cold_idx.reshape(B * F, P).contiguous()
    ).reshape(B, F, cfg.dim)
    return hot_psum, cold_psum
