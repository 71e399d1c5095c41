"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (GQA kv=16) d_ff=1024
vocab=50304, MoE 64e top-8 — 64 experts top-8 [arXiv:2409.02060].

Counterpart of ``repro.configs.olmoe_1b_7b``, field for field.
"""
import torch

from repro_torch.common.types import ArchKind
from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.layers import MoEConfig
from repro_torch.models.transformer import LMConfig

ARCH_ID = "olmoe-1b-7b"
KIND = ArchKind.LM_MOE
SHAPES = LM_SHAPES

FULL = LMConfig(
    name=ARCH_ID,
    kv_quant="int8",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    head_dim=128,
    rope_theta=10_000.0,
    moe=MoEConfig(d_model=2048, d_ff=1024, n_experts=64, top_k=8),
)

SMOKE = LMConfig(
    name=ARCH_ID + "-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=32,
    vocab=512,
    head_dim=16,
    moe=MoEConfig(d_model=64, d_ff=32, n_experts=8, top_k=2),
    dtype=torch.float32,
)
