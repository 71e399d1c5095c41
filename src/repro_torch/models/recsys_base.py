"""Shared recsys model protocol.

Counterpart of ``repro.models.recsys_base``.  Batch layout (a dict of
tensors; unused keys absent):
    dense       [B, n_dense] f32    continuous features
    sparse_ids  [B, F, P]   i32     multi-hot ids, -1-padded
    history_ids [B, T]      i32     behaviour sequence (DIN/DIEN/MIND)
    target_id   [B]         i32     candidate item (DIN/DIEN/MIND)
    label       [B]         f32     click label (training)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.embedding import EmbeddingConfig


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    """Family-agnostic recsys configuration; models read what they need."""

    name: str
    embedding: EmbeddingConfig
    n_dense: int = 0
    bottom_mlp: tuple[int, ...] = ()       # hidden+out sizes after n_dense input
    top_mlp: tuple[int, ...] = ()          # hidden+out sizes, output appended
    interaction: str = "dot"               # dot | concat | target-attn | multi-interest
    # DIN/DIEN/MIND:
    seq_len: int = 0
    attn_mlp: tuple[int, ...] = ()         # DIN attention-unit hidden sizes
    use_gru: bool = False                  # DIEN
    n_interests: int = 0                   # MIND
    capsule_iters: int = 3                 # MIND routing iterations
    # MT-WnD:
    n_tasks: int = 1
    dtype: torch.dtype = torch.float32

    @property
    def embed_dim(self) -> int:
        return self.embedding.dim


def binary_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically-stable sigmoid cross-entropy, mean over batch/tasks."""
    logits = logits.float()
    labels = labels.float()
    if logits.dim() > labels.dim():
        labels = labels[..., None]  # broadcast labels over task dim
    loss = logits.clamp_min(0.0) - logits * labels + torch.log1p(
        torch.exp(-logits.abs()))
    return loss.mean()


def input_specs(cfg: RecsysConfig, batch_size: int, *,
                with_labels: bool = False, n_candidates: int = 0
                ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """Input name -> (shape, dtype) of one batch (no allocation)."""
    emb = cfg.embedding
    specs: dict[str, tuple[tuple[int, ...], torch.dtype]] = {}
    if cfg.n_dense:
        specs["dense"] = ((batch_size, cfg.n_dense), cfg.dtype)
    if cfg.interaction in ("dot", "concat"):
        specs["sparse_ids"] = (
            (batch_size, emb.num_features, emb.max_pooling), torch.int32)
    if cfg.seq_len:
        specs["history_ids"] = ((batch_size, cfg.seq_len), torch.int32)
        if not n_candidates:
            specs["target_id"] = ((batch_size,), torch.int32)
        if emb.num_features > 1:
            specs["profile_ids"] = (
                (batch_size, emb.num_features - 1), torch.int32)
    if n_candidates:
        specs["candidate_ids"] = ((n_candidates,), torch.int32)
    if with_labels:
        shape = (batch_size,) if cfg.n_tasks == 1 else (batch_size, cfg.n_tasks)
        specs["label"] = (shape, cfg.dtype)
    return specs


def batch_to_tensors(batch: dict[str, np.ndarray], device: torch.device
                     ) -> dict[str, torch.Tensor]:
    """A numpy batch (``ClickLogGenerator.batch``) as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
