"""mind [recsys]: embed_dim=64 n_interests=4 capsule_iters=3
interaction=multi-interest [arXiv:1904.08030; unverified].

Counterpart of ``repro.configs.mind_arch``.  Retrieval model: item table at
10M ids; user history length 64.  The retrieval_cand shape scores one
user's 4 interests against 1e6 candidates with a single [K, D] x [D, N]
matmul."""
from repro_torch.common.types import ArchKind
from repro_torch.configs.shapes import RECSYS_SHAPES
from repro_torch.models.embedding import EmbeddingConfig
from repro_torch.models.recsys_base import RecsysConfig

ARCH_ID = "mind"
KIND = ArchKind.RECSYS
SHAPES = RECSYS_SHAPES
SLA_MS = 50.0

FULL = RecsysConfig(
    name=ARCH_ID,
    embedding=EmbeddingConfig(
        vocab_sizes=(10_000_000, 1_000_000), dim=64, pooling=(1, 1)
    ),
    seq_len=64,
    n_interests=4,
    capsule_iters=3,
    interaction="multi-interest",
)

SMOKE = RecsysConfig(
    name=ARCH_ID + "-smoke",
    embedding=EmbeddingConfig(vocab_sizes=(10_000, 1_000), dim=16, pooling=(1, 1)),
    seq_len=12,
    n_interests=4,
    capsule_iters=3,
    interaction="multi-interest",
)
