"""Kernels written by hand for Hopper (sm_90a), one per TPU kernel of the
reference.

- embedding_bag (K1): fused SparseLengthsSum over a hot table, and its
  backward (the dense table gradient, under an ``autograd.Function``),
  CUDA C++.
- flash_attention (K2): blocked causal GQA flash attention, CUDA C++
  (bf16: a TMA producer warp and two ``wgmma`` consumer warpgroups over a
  ring of K/V tiles; CUDA-core f32 variant).
- flash_attention (K3): split-KV flash decode with its partial merge, CUDA
  C++ (``csrc/flash_decode.cu``: a ``cp.async`` ring of K/V tiles and
  ``mma.sync`` tensor cores; CUDA-core variants for f32 and other head
  sizes).  ``flash_decode_int8`` is K3 read straight from the int8 KV cache
  and its scales, the path the int8 flash decode takes.
- fleet_fifo (K4, not a Pallas kernel in the reference but its jitted
  ``lax.scan``): the event core's fleet FIFO solver, CUDA C++, one thread
  a stream; what an ``event_core`` cluster day runs on the card.

Each kernel ships ``csrc/*.cu`` (the kernel, plain C interface),
``<name>.py`` (the ctypes launcher), ``ops.py`` (the wrapper: plain version
for CPU tensors, the kernel for CUDA tensors, a launch count) and
``ref.py`` (the plain PyTorch version).  ``_build`` compiles the sources
with nvcc at first use.  The reference's DLRM ``dot_interaction`` has no
kernel in either package; the port computes it with torch ops.
"""
from repro_torch.kernels.embedding_bag.ops import hot_embedding_bag
from repro_torch.kernels.embedding_bag.ref import hot_embedding_bag_ref
from repro_torch.kernels.flash_attention.ops import (
    flash_attention,
    flash_decode,
    flash_decode_int8,
    flash_decode_partials,
)
from repro_torch.kernels.flash_attention.ref import attention_ref, lse_combine
from repro_torch.kernels.fleet_fifo import fleet_fifo, fleet_fifo_ref

__all__ = ["hot_embedding_bag", "hot_embedding_bag_ref", "flash_attention",
           "flash_decode", "flash_decode_int8", "flash_decode_partials",
           "attention_ref", "lse_combine", "fleet_fifo", "fleet_fifo_ref"]
