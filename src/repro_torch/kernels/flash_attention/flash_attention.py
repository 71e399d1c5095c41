"""ctypes launcher of the CUDA flash attention kernel (``csrc/flash_attention.cu``).

The counterpart of the reference's ``flash_attention_pallas``: it takes
checked tensors from ``ops.flash_attention`` and launches on PyTorch's
current stream.  The kernel picks its own tiles and masks its own ragged
edge, so Tq and Tk need not divide by anything.  bf16 at head size 64 or
128 runs the warp-specialised tensor-core variant (TMA, ``wgmma``); every
other case the CUDA-core variant (f32 FMAs).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MMA_HEAD_DIMS = (64, 128)
MAX_HEAD_DIM = 256
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("flash_attention")
        fn = lib.repro_flash_attention
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 11 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.repro_cuda_error_string)
    return _fn


def variant(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernel variant runs: "wgmma" (tensor cores) or "simt"."""
    return "wgmma" if dtype == torch.bfloat16 and head_dim in MMA_HEAD_DIMS \
        else "simt"


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, q_offset: int) -> torch.Tensor:
    """Checked q [B, Tq, H, hd], k/v [B, Tk, KVH, hd] on one CUDA device ->
    [B, Tq, H, hd] in q's dtype."""
    fn, err_str = _kernel()
    B, Tq, H, hd = q.shape
    Tk, KVH = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             B, Tq, Tk, H, KVH, hd, int(causal), q_offset,
             _DTYPE_CODE[q.dtype], int(variant(q.dtype, hd) == "wgmma"),
             q.device.index, stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: {err_str(err).decode()} "
            f"(cuda error {err})")
    return out
