"""din [recsys]: embed_dim=18 seq_len=100 attn_mlp=80-40 mlp=200-80
interaction=target-attn [arXiv:1706.06978; paper].

Counterpart of ``repro.configs.din_arch``.  Three tables per the DIN paper
(goods/user/context); the goods table at Alibaba scale (600M ids) uses the
quotient-remainder trick in the FULL config, so its storage is
ceil(600M/65536) + 65536 = 74,692 rows (the whole combined table 1,175,040
x 18 f32, 84.6 MB).
"""
from repro_torch.common.types import ArchKind
from repro_torch.configs.shapes import RECSYS_SHAPES
from repro_torch.models.embedding import EmbeddingConfig
from repro_torch.models.recsys_base import RecsysConfig

ARCH_ID = "din"
KIND = ArchKind.RECSYS
SHAPES = RECSYS_SHAPES
SLA_MS = 50.0

FULL = RecsysConfig(
    name=ARCH_ID,
    embedding=EmbeddingConfig(
        vocab_sizes=(600_000_000, 1_000_000, 100_000),
        dim=18,
        pooling=(1, 1, 1),
        qr_features=(0,),
        qr_buckets=65536,
    ),
    seq_len=100,
    attn_mlp=(80, 40),
    top_mlp=(200, 80),
    interaction="target-attn",
)

SMOKE = RecsysConfig(
    name=ARCH_ID + "-smoke",
    embedding=EmbeddingConfig(
        vocab_sizes=(10_000, 1_000, 100), dim=18, pooling=(1, 1, 1)
    ),
    seq_len=10,
    attn_mlp=(80, 40),
    top_mlp=(200, 80),
    interaction="target-attn",
)
