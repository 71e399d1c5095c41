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


_grad_fn = None


def _grad_kernel():
    global _grad_fn
    if _grad_fn is None:
        lib = _build.load("embedding_bag_grad")
        fn = lib.repro_embedding_bag_grad
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.repro_embedding_bag_grad_chunk.argtypes = []
        lib.repro_embedding_bag_grad_chunk.restype = ctypes.c_int64
        lib.repro_embedding_bag_grad_error_string.argtypes = [ctypes.c_int]
        lib.repro_embedding_bag_grad_error_string.restype = ctypes.c_char_p
        _grad_fn = (fn, lib.repro_embedding_bag_grad_chunk(),
                    lib.repro_embedding_bag_grad_error_string)
    return _grad_fn


def embedding_bag_grad_cuda(grad: torch.Tensor, keys: torch.Tensor,
                            n_rows: int, P: int) -> torch.Tensor:
    """The dense table gradient [n_rows, D] (grad's dtype) from the pooled
    gradient ``grad`` [n_bags, D] and ``keys`` [n_bags * P] int32: the row
    each (bag, slot) pair reads, ``n_rows`` for none.  Sorts the keys
    (stable, torch), zeroes the output (one ``zero_``), then launches the
    kernel's two passes; all on one CUDA device, contiguous."""
    fn, chunk, err_str = _grad_kernel()
    dev = grad.device
    D = grad.shape[1]
    sorted_keys, perm = torch.sort(keys, stable=True)
    out = torch.zeros((n_rows, D), dtype=grad.dtype, device=dev)
    n = keys.numel()
    part = torch.empty((2, -(-n // chunk), D), dtype=torch.float32,
                       device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(sorted_keys.data_ptr(), perm.data_ptr(), grad.data_ptr(),
             out.data_ptr(), part.data_ptr(), n, P, n_rows, D,
             _DTYPE_CODE[grad.dtype], dev.index, stream)
    if err != 0:
        raise RuntimeError(
            f"embedding_bag_grad kernel launch failed: "
            f"{err_str(err).decode()} (cuda error {err})")
    return out
