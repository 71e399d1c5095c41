"""Hot embedding bag (K1): the plain version on CPU tensors, the CUDA
kernel on CUDA tensors.

Replaces ``repro/kernels/embedding_bag/embedding_bag.py``
``hot_embedding_bag_pallas`` (wrapper ``repro/kernels/embedding_bag/ops.py``
``hot_embedding_bag``), which pins the hot table in TPU VMEM.

On an H100 the kernel is bound by bytes, once enough rows are in flight:
every valid id gathers one ``D``-row from HBM (or from the 50 MB L2 for hot
rows) for ``D`` adds.  The CUDA design (``csrc/embedding_bag.cu``) gives
each bag a team of four lane groups, each as wide as a row (a warp a bag
at 128-byte rows), compacts the bag's valid ids so padding costs no load,
has each group issue 4 independent 16-byte row loads before its adds (16
rows a bag in flight) while the next ids load, sums each bag in a fixed
order in fp32, and sizes the grid to one wave of resident warps.

The per-feature entry's resident teams take the bags feature by feature
(all B bags of feature 0, then of feature 1, ...), not item by item, where
a bag's row and its ids each fill a 32-byte sector or more: with 3,696
teams resident (rm2's bf16 rows) and B items of thousands, one or two
tables are in flight at a time, so a table's hot rows have the SMs' L1
and the L2 to themselves instead of 1/F of them.  Under Zipf ids (alpha
1.05, 5 M rows a table) Che's approximation of an LRU cache puts the row
loads that reach HBM at ~46% in item order and ~22-27% table by table
(computed, not measured).  On the H100 the rm2
serve_bulk launch went from 8.6 to 7.97 ms and the 1,000,000-item call
from 32.7-33.1 to 30.5 ms, against 6.8 ms for the same launch with every
id in L1 (``tools/k1_bench.py --ab``).  Each bag is still summed by one
team in the same order, so the output is bitwise the item order's.
Narrower rows (D = 1 f32) keep the item order, whose outputs of one
32-byte sector are written together, and so do bags of fewer than 8 ids
(MT-WnD's one-id deep launch), whose ids a feature-major walk reads a
sector a bag.

Two entries share the kernel: ``hot_embedding_bag`` (ids [B, P] into the
table) and ``embedding_bag_features`` (ids [B, F, P] per feature, shifted
by ``row_offsets[f]`` inside the kernel in 64 bits).  The latter also takes
a row window, ``row_window=(lo, hi)``: the table is then one rank's shard,
rows [lo, hi) of the combined table, and every id outside it counts as
padding; with ``out_dtype=torch.float32`` the kernel stores its float32
sums unrounded, the partial that ``repro_torch.dist.sharded_embedding``
sums across ranks before it rounds once.

Both entries carry autograd when the table requires grad (outside
``torch.inference_mode``): the backward is K1's gradient kernel
(``csrc/embedding_bag_grad.cu``; ``embedding_bag_features_grad`` and
``hot_embedding_bag_grad``), which returns the dense table gradient in the
table's dtype, as ``jax.grad`` of the reference's ``embedding_bag_local``
does.  It takes the int32 ids and the offsets as they are: its kernels
emit the valid pairs, sort them by row with a radix sort of their own and
write every row of the output once (no sort or fill by torch).  Through a
row window the backward is the gradient of the shard's rows only, [hi - lo,
D]: the gradient kernel's windowed instance drops every pair outside the
window in its first stage.  Without grad the forward is called as it is.

Which version runs is decided by where the caller put the tensors, never
by what is installed: a CUDA tensor launches the kernel or raises.  A
``meta`` tensor takes the shape-only path (``repro_torch.kernels.fake``):
the kernel's outputs, its backward's scratch, and the work of one launch
reported, with every slot counted live (a meta tensor holds no ids).
"""
from __future__ import annotations

import torch

from torch.autograd.function import once_differentiable

from repro_torch.common import trace
from repro_torch.kernels import fake
from repro_torch.kernels.embedding_bag.embedding_bag import (
    NO_WINDOW,
    embedding_bag_cuda,
    embedding_bag_grad_cuda,
    grad_scratch_bytes,
)
from repro_torch.kernels.embedding_bag.ref import (
    embedding_bag_features_grad_ref,
    embedding_bag_features_ref,
    embedding_bag_window_ref,
    hot_embedding_bag_grad_ref,
    hot_embedding_bag_ref,
)

# Kernel launches since the last reset (set it to 0 to start a count): the
# forward kernel's, the forward kernel's through a row window, and the
# gradient kernel's (one a backward call; those through a row window are
# also counted in grad_window_launches).  table_major_launches counts the
# forward launches of either of the first two counts whose schedule had at
# most two tables in flight at a time: the kernel walked the bags feature
# by feature (the 3-D entry at rows of 32 bytes or more and bags of 8 ids
# or more) and a feature's bags were at least the teams the launch kept
# resident.  A launch whose bags all fit one wave, or that kept the item
# order, is not counted.
launches = 0
window_launches = 0
table_major_launches = 0
grad_launches = 0
grad_window_launches = 0

_MAX_ROWS = 2**31  # ids are int32
# The forward kernel's bag index and loop bounds are 32-bit ints (a bag's
# ids, rows and output are addressed in 64 bits): fewer than 2**30 bags
_MAX_BAGS = 2**30


def _check_table(table: torch.Tensor, ids: torch.Tensor) -> None:
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if table.device != ids.device:
        raise ValueError(f"table on {table.device} but ids on {ids.device}")
    if table.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {table.device}")
    if table.device.type != "cpu":
        if table.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"kernel takes float32 or bfloat16 tables, got "
                            f"{table.dtype}")
        if not (table.is_contiguous() and ids.is_contiguous()):
            raise ValueError("kernel takes contiguous table and ids")


def _check_offsets(ids: torch.Tensor, row_offsets: torch.Tensor) -> None:
    if (row_offsets.dim() != 1 or row_offsets.shape[0] != ids.shape[1]
            or row_offsets.dtype != torch.int64):
        raise ValueError(f"row_offsets must be int64 [{ids.shape[1]}], got "
                         f"{row_offsets.dtype} {tuple(row_offsets.shape)}")
    if row_offsets.device != ids.device:
        raise ValueError(f"row_offsets on {row_offsets.device} but ids on "
                         f"{ids.device}")


def _fake_bag(table, ids, row_offsets, out_dtype) -> torch.Tensor:
    """The shape-only launch: B * F * P * D adds; the ids, one row a slot
    and the output moved once."""
    out = torch.empty((*ids.shape[:-1], table.shape[1]), dtype=out_dtype,
                      device=table.device)
    slots = ids.numel() * table.shape[1]
    fake.report("k1", flops=slots, dtype=torch.float32, nbytes=fake.nbytes(
        ids, out) + slots * table.element_size() + (
        0 if row_offsets is None else fake.nbytes(row_offsets)))
    return out


def _check_kernel_bags(ids: torch.Tensor) -> None:
    """The forward kernel takes fewer than 2**30 bags (the plain version
    has no such limit)."""
    bags = ids.shape[:-1].numel()
    if bags >= _MAX_BAGS:
        raise ValueError(f"ids hold {bags} bags; the kernel's 32-bit bag "
                         f"index takes fewer than 2**30")


def _launch(table, ids, row_offsets=None) -> torch.Tensor:
    global launches
    _check_kernel_bags(ids)
    if ids.numel() == 0 or table.shape[1] == 0:
        return torch.zeros((*ids.shape[:-1], table.shape[1]),
                           dtype=table.dtype, device=table.device)
    if fake.is_fake(table):
        return _fake_bag(table, ids, row_offsets, table.dtype)
    out = _bag_cuda(table, ids, row_offsets)
    launches += 1
    return out


def _bag_cuda(table, ids, row_offsets, **window) -> torch.Tensor:
    """The forward kernel's launch, counted in ``table_major_launches``
    where its schedule walked one table at a time."""
    global table_major_launches
    out, table_major = embedding_bag_cuda(table, ids, row_offsets, **window)
    table_major_launches += table_major
    return out


def _wants_grad(table: torch.Tensor) -> bool:
    return table.requires_grad and torch.is_grad_enabled()


def _hot_forward(table, ids) -> torch.Tensor:
    if table.device.type == "cpu":
        return hot_embedding_bag_ref(table, ids)
    if table.shape[0] >= _MAX_ROWS:
        raise ValueError(f"table has {table.shape[0]} rows; int32 ids "
                         f"address fewer than 2**31")
    return _launch(table, ids)


class _HotBag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.n_rows = table.shape[0]
        return _hot_forward(table, ids)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        ids, = ctx.saved_tensors
        return hot_embedding_bag_grad(grad, ids, ctx.n_rows), None


def hot_embedding_bag(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Fused hot-table SLS: table [H, D], ids [B, P] int32 (-1 padded) ->
    pooled [B, D] in the table's dtype, accumulated in float32.

    Unlike the reference wrapper there is no ``tile_b``: any B is exact."""
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"expected table [H, D] and ids [B, P], got "
                         f"{tuple(table.shape)} and {tuple(ids.shape)}")
    _check_table(table, ids)
    with trace.span("k1"):
        if _wants_grad(table):
            return _HotBag.apply(table, ids)
        return _hot_forward(table, ids)


def embedding_bag_features(table: torch.Tensor, ids: torch.Tensor,
                           row_offsets: torch.Tensor, *,
                           row_window: tuple[int, int] | None = None,
                           out_dtype: torch.dtype | None = None
                           ) -> torch.Tensor:
    """Per-feature SLS: table [H, D], ids [B, F, P] int32 (-1 padded),
    row_offsets [F] int64 on the same device -> pooled [B, F, D] in the
    table's dtype (or ``out_dtype``: float32 keeps the accumulator
    unrounded), accumulated in float32.

    Feature f's ids address rows ``ids + row_offsets[f]`` (added in 64
    bits); a negative offset leaves feature f unrouted: it pools to exactly
    zero.  With ``row_window=(lo, hi)`` the table is the shard [hi - lo, D]
    holding rows [lo, hi) of the combined table: an id is live iff it is
    >= 0 and lo <= id + row_offsets[f] < hi, and it reads local row id +
    row_offsets[f] - lo.  One launch for all B * F bags."""
    if table.dim() != 2 or ids.dim() != 3:
        raise ValueError(f"expected table [H, D] and ids [B, F, P], got "
                         f"{tuple(table.shape)} and {tuple(ids.shape)}")
    _check_table(table, ids)
    _check_offsets(ids, row_offsets)
    if table.device.type != "cpu" and not row_offsets.is_contiguous():
        raise ValueError("kernel takes contiguous row_offsets")
    window = _window_args(table, row_window, out_dtype)
    with trace.span("k1"):
        if _wants_grad(table):
            return _FeaturesBag.apply(table, ids, row_offsets, window)
        return _bag_forward(table, ids, row_offsets, window)


def _window_args(table, row_window, out_dtype):
    """``(row_window, out_dtype)`` checked, or None where neither is asked
    for (the unwindowed launch in the table's dtype)."""
    if row_window is None and out_dtype is None:
        return None
    if row_window is not None:
        lo, hi = (int(x) for x in row_window)
        if not 0 <= lo <= hi or hi - lo != table.shape[0]:
            raise ValueError(f"row_window ({lo}, {hi}) does not hold the "
                             f"table's {table.shape[0]} rows")
        row_window = (lo, hi)
    out_dtype = table.dtype if out_dtype is None else out_dtype
    if out_dtype not in (table.dtype, torch.float32):
        raise TypeError(f"out_dtype must be the table's {table.dtype} or "
                        f"float32, got {out_dtype}")
    return row_window, out_dtype


def _bag_forward(table, ids, row_offsets, window) -> torch.Tensor:
    global launches, window_launches
    if window is None:
        if table.device.type == "cpu":
            return embedding_bag_features_ref(table, ids, row_offsets)
        return _launch(table, ids, row_offsets)
    row_window, out_dtype = window
    bounds = NO_WINDOW if row_window is None else row_window
    if table.device.type == "cpu":
        return embedding_bag_window_ref(table, ids, row_offsets, bounds,
                                        out_dtype)
    B, F, _ = ids.shape
    _check_kernel_bags(ids)
    if ids.numel() == 0 or table.shape[1] == 0 or table.shape[0] == 0:
        return torch.zeros((B, F, table.shape[1]), dtype=out_dtype,
                           device=table.device)
    if fake.is_fake(table):
        return _fake_bag(table, ids, row_offsets, out_dtype)
    out = _bag_cuda(table, ids, row_offsets, row_window=bounds,
                    out_dtype=out_dtype)
    if row_window is None:
        launches += 1
    else:
        window_launches += 1
    return out


class _FeaturesBag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, row_offsets, window):
        ctx.save_for_backward(ids, row_offsets)
        ctx.n_rows, ctx.dtype = table.shape[0], table.dtype
        ctx.row_window = None if window is None else window[0]
        return _bag_forward(table, ids, row_offsets, window)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        ids, row_offsets = ctx.saved_tensors
        # a float32 partial's cotangent holds values of the table's dtype
        # when the caller rounded the summed partials to it (the sharded
        # embedding): the cast is exact, and the backward writes the
        # gradient in the table's dtype
        return (embedding_bag_features_grad(
            grad.to(ctx.dtype), ids, row_offsets, ctx.n_rows,
            row_window=ctx.row_window), None, None, None)


# ---------------------------------------------------------------------------
# the table gradient
# ---------------------------------------------------------------------------


def _check_grad(grad: torch.Tensor, ids: torch.Tensor, n_rows: int) -> None:
    if grad.device != ids.device:
        raise ValueError(f"grad on {grad.device} but ids on {ids.device}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if grad.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {grad.device}")
    if grad.device.type != "cpu":
        if grad.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"kernel takes float32 or bfloat16 gradients, "
                            f"got {grad.dtype}")
        if not 0 <= n_rows < _MAX_ROWS:
            raise ValueError(f"the gradient kernel's int32 rows address "
                             f"0 to 2**31 - 1 rows, got {n_rows}")
        _check_kernel_slots(ids)


def _check_kernel_slots(ids: torch.Tensor) -> None:
    """The gradient kernel's flat pair index is 32-bit: fewer than 2**31
    slots (the plain version has no such limit)."""
    if ids.numel() >= _MAX_ROWS:
        raise ValueError(f"ids hold {ids.numel()} slots; the gradient "
                         f"kernel's 32-bit pair index takes fewer than 2**31")


def _launch_grad(grad: torch.Tensor, ids: torch.Tensor,
                 row_offsets: torch.Tensor | None, n_rows: int,
                 row_lo: int = 0) -> torch.Tensor:
    """grad [n_bags, D]; ids [..., P] int32 whose leading dims are the bags
    (the last one the feature, with row_offsets [F] int64); rows [row_lo,
    row_lo + n_rows) of the combined table."""
    global grad_launches
    D = grad.shape[-1]
    if D == 0 or n_rows == 0:
        return torch.zeros((n_rows, D), dtype=grad.dtype, device=grad.device)
    grad = grad.contiguous()
    if fake.is_fake(grad):
        return _fake_grad(grad, ids, row_offsets, n_rows)
    if grad.data_ptr() % 16:  # the kernel's 16-byte row loads
        grad = grad.clone()
    out = embedding_bag_grad_cuda(grad, ids.contiguous(), row_offsets, n_rows,
                                  row_lo)
    grad_launches += 1
    return out


def _fake_grad(grad, ids, row_offsets, n_rows: int) -> torch.Tensor:
    """The shape-only backward: its output and scratch allocated as
    ``embedding_bag.GradLaunch`` allocates them; slots * D adds; the pooled
    gradient and the ids read, the table gradient written, once."""
    out = torch.empty((n_rows, grad.shape[1]), dtype=grad.dtype,
                      device=grad.device)
    scratch = torch.empty(grad_scratch_bytes(ids.numel(), n_rows,
                                             grad.shape[1],
                                             grad.element_size()),
                          dtype=torch.uint8, device=grad.device)
    del scratch
    fake.report("k1_grad", flops=ids.numel() * grad.shape[1],
                dtype=torch.float32, nbytes=fake.nbytes(grad, ids, out) + (
                    0 if row_offsets is None else fake.nbytes(row_offsets)))
    return out


def hot_embedding_bag_grad(grad: torch.Tensor, ids: torch.Tensor,
                           n_rows: int) -> torch.Tensor:
    """The table gradient of ``hot_embedding_bag``: grad [B, D] (of the
    pooled output), ids [B, P] int32 -> [n_rows, D] in grad's dtype, every
    row written (untouched rows zero).  The kernel sums in float32,
    compensated, in a fixed order: two calls on the card are bitwise
    equal; there ids of 2**31 slots or more are refused."""
    if grad.dim() != 2 or ids.dim() != 2 or grad.shape[0] != ids.shape[0]:
        raise ValueError(f"expected grad [B, D] and ids [B, P], got "
                         f"{tuple(grad.shape)} and {tuple(ids.shape)}")
    _check_grad(grad, ids, n_rows)
    if grad.device.type == "cpu":
        return hot_embedding_bag_grad_ref(grad, ids, n_rows)
    return _launch_grad(grad, ids, None, n_rows)


def embedding_bag_features_grad(grad: torch.Tensor, ids: torch.Tensor,
                                row_offsets: torch.Tensor, n_rows: int, *,
                                row_window: tuple[int, int] | None = None
                                ) -> torch.Tensor:
    """The table gradient of ``embedding_bag_features``: grad [B, F, D],
    ids [B, F, P] int32, row_offsets [F] int64 -> [n_rows, D] in grad's
    dtype.  Feature f's pairs add into rows ``ids + row_offsets[f]``; an
    unrouted feature (negative offset) and padding add nothing.  With
    ``row_window=(lo, hi)`` (n_rows = hi - lo) the gradient of rows [lo, hi)
    of the combined table: a pair adds into local row ids + row_offsets[f]
    - lo where that row lies in the window, nowhere else.  One call of the
    gradient kernel; on the card ids of 2**31 slots or more are refused."""
    if grad.dim() != 3 or ids.dim() != 3 or grad.shape[:2] != ids.shape[:2]:
        raise ValueError(f"expected grad [B, F, D] and ids [B, F, P], got "
                         f"{tuple(grad.shape)} and {tuple(ids.shape)}")
    lo = 0
    if row_window is not None:
        lo, hi = (int(x) for x in row_window)
        if not 0 <= lo <= hi or hi - lo != n_rows:
            raise ValueError(f"row_window ({lo}, {hi}) does not hold "
                             f"{n_rows} rows")
    _check_offsets(ids, row_offsets)
    _check_grad(grad, ids, n_rows)
    if grad.device.type == "cpu":
        return embedding_bag_features_grad_ref(grad, ids, row_offsets, n_rows,
                                               row_window)
    global grad_window_launches
    B, F, _ = ids.shape
    before = grad_launches
    out = _launch_grad(grad.reshape(B * F, grad.shape[2]), ids,
                       row_offsets.contiguous(), n_rows, lo)
    if row_window is not None:
        grad_window_launches += grad_launches - before
    return out
