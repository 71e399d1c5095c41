"""ctypes launcher of the CUDA embedding-bag kernel (``csrc/embedding_bag.cu``).

The counterpart of the reference's ``hot_embedding_bag_pallas``: it takes
the checked tensors from ``ops`` and launches the kernel on PyTorch's
current stream.  No batch padding: the kernel masks its own ragged edge,
so any number of bags comes out exact.
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
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.repro_cuda_error_string)
    return _fn


def embedding_bag_cuda(table: torch.Tensor, ids: torch.Tensor,
                       row_offsets: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """table [H, D] f32/bf16; ids [..., P] int32 whose leading dims are the
    bags (the last leading dim is the feature when ``row_offsets`` [F] int64
    is given); all contiguous on one CUDA device, with bags, P and D > 0
    -> pooled [..., D] in the table's dtype."""
    fn, err_str = _kernel()
    P = ids.shape[-1]
    out = torch.empty((*ids.shape[:-1], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = fn(table.data_ptr(), ids.data_ptr(),
             None if row_offsets is None else row_offsets.data_ptr(),
             out.data_ptr(), ids.numel() // P, P,
             1 if row_offsets is None else row_offsets.shape[0],
             table.shape[1], _DTYPE_CODE[table.dtype], table.device.index,
             stream)
    if err != 0:
        raise RuntimeError(
            f"embedding_bag kernel launch failed: {err_str(err).decode()} "
            f"(cuda error {err})")
    return out
