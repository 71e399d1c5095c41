"""ctypes launcher of the CUDA embedding-bag kernel (``csrc/embedding_bag.cu``).

The counterpart of the reference's ``hot_embedding_bag_pallas``: it takes
the checked tensors from ``ops`` and launches the kernel on PyTorch's
current stream.  No batch padding: the kernel masks its own ragged edge,
so any number of bags comes out exact.  K1's backward
(``csrc/embedding_bag_grad.cu``) is launched the same way, by
``GradLaunch``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
NO_WINDOW = (0, 2**63 - 1)  # the whole table
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("embedding_bag")
        fn = lib.repro_embedding_bag
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.repro_cuda_error_string)
    return _fn


def embedding_bag_cuda(table: torch.Tensor, ids: torch.Tensor,
                       row_offsets: torch.Tensor | None = None, *,
                       row_window: tuple[int, int] = NO_WINDOW,
                       out_dtype: torch.dtype | None = None
                       ) -> torch.Tensor:
    """table [H, D] f32/bf16; ids [..., P] int32 whose leading dims are the
    bags (the last leading dim is the feature when ``row_offsets`` [F] int64
    is given); all contiguous on one CUDA device, with bags, P and D > 0
    -> pooled [..., D] in ``out_dtype`` (the table's by default; float32
    stores the accumulator unrounded).  ``row_window`` (lo, hi): the table
    holds rows [lo, hi) of the combined table; other rows count as
    padding."""
    fn, err_str = _kernel()
    P = ids.shape[-1]
    out_dtype = table.dtype if out_dtype is None else out_dtype
    out = torch.empty((*ids.shape[:-1], table.shape[1]), dtype=out_dtype,
                      device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    lo, hi = row_window
    err = fn(table.data_ptr(), ids.data_ptr(),
             None if row_offsets is None else row_offsets.data_ptr(),
             out.data_ptr(), ids.numel() // P, P,
             1 if row_offsets is None else row_offsets.shape[0],
             table.shape[1], _DTYPE_CODE[table.dtype], _DTYPE_CODE[out_dtype],
             lo, hi, table.device.index, stream)
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
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [
            ctypes.c_int64] * 3 + [ctypes.c_void_p, ctypes.c_void_p] + [
            ctypes.c_int64] * 4 + [ctypes.c_void_p] + [ctypes.c_int64] * 2 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        layout = lib.repro_embedding_bag_grad_layout
        layout.argtypes = [ctypes.c_int64] * 4 + [
            ctypes.POINTER(ctypes.c_int64)]
        layout.restype = ctypes.c_int
        lib.repro_embedding_bag_grad_error_string.argtypes = [ctypes.c_int]
        lib.repro_embedding_bag_grad_error_string.restype = ctypes.c_char_p
        _grad_fn = (fn, layout, lib.repro_embedding_bag_grad_error_string)
    return _grad_fn


class GradLaunch:
    """One call of K1's backward (``csrc/embedding_bag_grad.cu``): the
    pooled gradient ``grad`` [n_bags, D] (16-byte aligned), ``ids`` [...,
    P] int32 whose leading dims are the bags (the last one the feature
    when ``row_offsets`` [F] int64 is given), all contiguous on one CUDA
    device, with fewer than 2**31 slots; the output [n_rows, D] and the
    scratch, allocated once with ``torch.empty``.  ``row_lo`` > 0 makes the
    output the row window [row_lo, row_lo + n_rows) of the combined table:
    pairs reading rows outside it are dropped in PAIRS, and the rows are
    local (a pair's row less ``row_lo``).

    ``run(stages)`` launches the kernels of the stages set in ``stages``
    (PAIRS: the valid pairs from the ids; SORT: the radix sort by row; SUM:
    the sums of the touched rows, marked in a bitmap; WRITE: zeros into
    the unmarked rows), each from what the earlier ones left in the
    scratch, on the current stream; ALL is the backward."""

    PAIRS, SORT, SUM, WRITE = 1, 2, 4, 8
    ALL = 15

    def __init__(self, grad: torch.Tensor, ids: torch.Tensor,
                 row_offsets: torch.Tensor | None, n_rows: int,
                 row_lo: int = 0):
        fn, layout_fn, self._err_str = _grad_kernel()
        self._fn = fn
        self.grad, self.ids, self.row_offsets = grad, ids, row_offsets
        self.n_rows, self.row_lo, self.D = n_rows, row_lo, grad.shape[1]
        self.P = ids.shape[-1]
        self.F = 1 if row_offsets is None else row_offsets.shape[0]
        layout = (ctypes.c_int64 * 4)()
        self._check(layout_fn(ids.numel(), n_rows, self.D,
                              _DTYPE_CODE[grad.dtype], layout))
        self._layout = list(layout)
        dev = grad.device
        self.out = torch.empty((n_rows, self.D), dtype=grad.dtype, device=dev)
        self.scratch = torch.empty(layout[0], dtype=torch.uint8, device=dev)

    def _check(self, err: int) -> None:
        if err != 0:
            raise RuntimeError(
                f"embedding_bag_grad kernel launch failed: "
                f"{self._err_str(err).decode()} (cuda error {err})")

    def run(self, stages: int = ALL) -> torch.Tensor:
        dev = self.grad.device
        self._check(self._fn(
            self.ids.data_ptr(),
            None if self.row_offsets is None else self.row_offsets.data_ptr(),
            self.ids.numel(), self.P, self.F, self.grad.data_ptr(),
            self.out.data_ptr(), self.n_rows, self.row_lo, self.D,
            _DTYPE_CODE[self.grad.dtype], self.scratch.data_ptr(), stages,
            dev.index, torch.cuda.current_stream(dev).cuda_stream))
        return self.out

    def count(self) -> int:
        """The valid pairs the last PAIRS stage found (synchronises)."""
        return int(self.scratch[self._layout[1]:self._layout[1] + 4].view(
            torch.int32)[0])

    def _pairs(self, offset: int) -> tuple[torch.Tensor, torch.Tensor]:
        m = self.count()
        pairs = self.scratch[offset:offset + 8 * m].view(torch.int32)
        return pairs[0::2], pairs[1::2]

    def pairs(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(rows, flat indices) int32 as PAIRS emitted them (flat-index
        order); SORT overwrites them."""
        return self._pairs(self._layout[2])

    def sorted_pairs(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(rows, flat indices) int32 as SORT left them: by row, then by
        flat index."""
        return self._pairs(self._layout[3])


def grad_scratch_bytes(n: int, n_rows: int, D: int, esize: int) -> int:
    """The scratch of one call of K1's backward over ``n`` slots, ``n_rows``
    rows of ``D`` elements of ``esize`` bytes: ``make_plan``'s layout in
    ``csrc/embedding_bag_grad.cu`` (what ``repro_embedding_bag_grad_layout``
    returns), computed on the host for the dry run's shape-only path."""
    tile, digits, scan_tiles = 4096, 512, 64
    L = 32 if D > 1 else 1
    nv = D * esize // 16
    if (D * esize) % 16 == 0 and nv <= 8:  # k1g_sum_async's lanes
        L = 1
        while L < nv:
            L <<= 1
    chunk_len = (64 if n >= 1 << 25 else 16) * L
    tiles = -(-n // tile)
    n_chunks = -(-n // chunk_len)
    parts = (16, 4 * (tiles + 1), 8 * n, 8 * n, 4 * digits * tiles,
             4 * digits * -(-tiles // scan_tiles), 4 * -(-n_rows // 32),
             4 * 2 * n_chunks * D)
    return sum((b + 255) & ~255 for b in parts)


def embedding_bag_grad_cuda(grad: torch.Tensor, ids: torch.Tensor,
                            row_offsets: torch.Tensor | None,
                            n_rows: int, row_lo: int = 0) -> torch.Tensor:
    """The dense table gradient [n_rows, D] (grad's dtype) from the pooled
    gradient ``grad`` [n_bags, D] and the ids the bags read (see
    ``GradLaunch``), of rows [row_lo, row_lo + n_rows) of the combined
    table: every stage of the kernel, every row written by it."""
    return GradLaunch(grad, ids, row_offsets, n_rows, row_lo).run()
