"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60e top-4 — 4 shared + 60 routed top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]. The 4 shared experts are fused into one
SwiGLU of width 4x1408 = 5632 (hf shared_expert_intermediate_size).

Counterpart of ``repro.configs.qwen2_moe_a2_7b``, field for field.
"""
import torch

from repro_torch.common.types import ArchKind
from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.layers import MoEConfig
from repro_torch.models.transformer import LMConfig

ARCH_ID = "qwen2-moe-a2.7b"
KIND = ArchKind.LM_MOE
SHAPES = LM_SHAPES

FULL = LMConfig(
    name=ARCH_ID,
    kv_quant="int8",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=151936,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(
        d_model=2048,
        d_ff=1408,
        n_experts=60,
        top_k=4,
        n_shared=4,
        shared_d_ff=5632,
    ),
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
    qkv_bias=True,
    moe=MoEConfig(d_model=64, d_ff=32, n_experts=6, top_k=2, n_shared=1,
                  shared_d_ff=64),
    dtype=torch.float32,
)
