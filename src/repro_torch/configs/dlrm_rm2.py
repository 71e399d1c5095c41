"""dlrm-rm2 [recsys]: n_dense=13 n_sparse=26 embed_dim=64
bot_mlp=13-512-256-64 top_mlp=512-512-256-1 interaction=dot
[arXiv:1906.00091; paper].

Counterpart of ``repro.configs.dlrm_rm2``.  Multi-hot pooling 64 per
table; 26 tables x 5M rows x 64 in bf16 (130,000,384 padded rows, 16.6 GB).
"""
import torch

from repro_torch.common.types import ArchKind
from repro_torch.configs.shapes import RECSYS_SHAPES
from repro_torch.models.embedding import EmbeddingConfig
from repro_torch.models.recsys_base import RecsysConfig

ARCH_ID = "dlrm-rm2"
KIND = ArchKind.RECSYS
SHAPES = RECSYS_SHAPES
SLA_MS = 50.0

FULL = RecsysConfig(
    name=ARCH_ID,
    embedding=EmbeddingConfig(
        vocab_sizes=(5_000_000,) * 26, dim=64, pooling=(64,) * 26,
        dtype=torch.bfloat16,
    ),
    n_dense=13,
    bottom_mlp=(512, 256, 64),
    top_mlp=(512, 512, 256),
    interaction="dot",
    dtype=torch.bfloat16,
)

SMOKE = RecsysConfig(
    name=ARCH_ID + "-smoke",
    embedding=EmbeddingConfig(vocab_sizes=(1000,) * 4, dim=16, pooling=(8,) * 4),
    n_dense=13,
    bottom_mlp=(32, 16),
    top_mlp=(64, 32),
    interaction="dot",
)
