"""wide-deep [recsys]: n_sparse=40 embed_dim=32 mlp=1024-512-256
interaction=concat [arXiv:1606.07792; paper].

Counterpart of ``repro.configs.wide_deep``.  Classic Wide&Deep uses
one-hot categorical features (pooling=1); tables at production scale (2M
rows each: 40 x 2,000,000 x 32 f32 is 10.24 GB, plus a 0.32 GB dim-1 wide
table)."""
from repro_torch.common.types import ArchKind
from repro_torch.configs.shapes import RECSYS_SHAPES
from repro_torch.models.embedding import EmbeddingConfig
from repro_torch.models.recsys_base import RecsysConfig

ARCH_ID = "wide-deep"
KIND = ArchKind.RECSYS
SHAPES = RECSYS_SHAPES
SLA_MS = 50.0

FULL = RecsysConfig(
    name=ARCH_ID,
    embedding=EmbeddingConfig(
        vocab_sizes=(2_000_000,) * 40, dim=32, pooling=(1,) * 40
    ),
    n_dense=13,
    top_mlp=(1024, 512, 256),
    interaction="concat",
)

SMOKE = RecsysConfig(
    name=ARCH_ID + "-smoke",
    embedding=EmbeddingConfig(vocab_sizes=(1000,) * 6, dim=8, pooling=(1,) * 6),
    n_dense=13,
    top_mlp=(64, 32),
    interaction="concat",
)
