"""llama3.2-3b [dense]: 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256 — small llama3 [hf:meta-llama/Llama-3.2-3B; unverified].
Llama 3.2 ties input/output embeddings; rope theta 500k.

Counterpart of ``repro.configs.llama3_2_3b``: ``FULL`` serves in bf16 with
chunked prefill attention and an int8 KV cache; ``SMOKE`` is the reduced
f32 config of the CPU tests.
"""
import torch

from repro_torch.common.types import ArchKind
from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.transformer import LMConfig

ARCH_ID = "llama3.2-3b"
KIND = ArchKind.LM_DENSE
SHAPES = LM_SHAPES

FULL = LMConfig(
    name=ARCH_ID,
    attn_impl="chunked",
    kv_quant="int8",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    head_dim=128,
    rope_theta=500_000.0,
    tie_embeddings=True,
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
    rope_theta=500_000.0,
    tie_embeddings=True,
    dtype=torch.float32,
)
