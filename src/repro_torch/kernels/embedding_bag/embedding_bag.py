"""ctypes launcher of the CUDA embedding-bag kernel (``csrc/embedding_bag.cu``).

The counterpart of the reference's ``hot_embedding_bag_pallas``: it takes
the checked tensors from ``ops.hot_embedding_bag`` and launches the kernel
on PyTorch's current stream.  No batch padding: the kernel masks its own
ragged edge, so any number of bags comes out exact.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("embedding_bag")
        fn = lib.repro_embedding_bag
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.repro_cuda_error_string)
    return _fn


def hot_embedding_bag_cuda(table: torch.Tensor, ids: torch.Tensor
                           ) -> torch.Tensor:
    """table [H, D] f32/bf16, ids [B, P] int32, both contiguous on one CUDA
    device, B > 0 and D > 0 -> pooled [B, D] in the table's dtype."""
    fn, err_str = _kernel()
    B, P = ids.shape
    D = table.shape[1]
    out = torch.empty((B, D), dtype=table.dtype, device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = fn(table.data_ptr(), ids.data_ptr(), out.data_ptr(), B, P, D,
             _DTYPE_CODE[table.dtype], table.device.index, stream)
    if err != 0:
        raise RuntimeError(
            f"embedding_bag kernel launch failed: {err_str(err).decode()} "
            f"(cuda error {err})")
    return out
