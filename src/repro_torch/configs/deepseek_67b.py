"""deepseek-67b [dense]: 95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400 — llama-arch [arXiv:2401.02954; hf].

Counterpart of ``repro.configs.deepseek_67b``, field for field.
"""
import torch

from repro_torch.common.types import ArchKind
from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.transformer import LMConfig

ARCH_ID = "deepseek-67b"
KIND = ArchKind.LM_DENSE
SHAPES = LM_SHAPES

FULL = LMConfig(
    name=ARCH_ID,
    kv_quant="int8",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=102400,
    head_dim=128,
    rope_theta=10_000.0,
)

SMOKE = LMConfig(
    name=ARCH_ID + "-smoke",
    n_layers=3,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab=512,
    head_dim=16,
    rope_theta=10_000.0,
    dtype=torch.float32,
)
