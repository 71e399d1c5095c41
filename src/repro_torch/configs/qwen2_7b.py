"""qwen2-7b [dense]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — GQA, QKV bias [arXiv:2407.10671; hf].

Counterpart of ``repro.configs.qwen2_7b``, field for field.
"""
import torch

from repro_torch.common.types import ArchKind
from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.transformer import LMConfig

ARCH_ID = "qwen2-7b"
KIND = ArchKind.LM_DENSE
SHAPES = LM_SHAPES

FULL = LMConfig(
    name=ARCH_ID,
    kv_quant="int8",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

SMOKE = LMConfig(
    name=ARCH_ID + "-smoke",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab=512,
    head_dim=32,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    dtype=torch.float32,
)
