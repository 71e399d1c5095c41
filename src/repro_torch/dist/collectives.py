"""The collectives of the distributed layer, in one place.

Every dataflow of ``repro_torch.dist`` moves data between ranks only
through these wrappers, so their ``calls`` and ``nbytes`` are the port's
record of collective traffic (the collectives a remat'ed block runs again
in the backward included).  ``nbytes`` counts a rank's bytes on the wire
as the reference's dry run does (``_WIRE_FACTOR``: an all-reduce twice its
result's bytes, a ring's reduce-scatter and all-gather; an all-gather its
result's), except a reduce-scatter, counted at its *operand's* bytes
(below); counted while the step runs rather than read off a compiled
graph; ``recording`` hands each call's kind, bytes and group to the dry
run.  They use whatever backend the caller initialised the process group
with; nothing here picks gloo or NCCL, and nothing copies a tensor to the
host: gloo in torch 2.11 takes CUDA tensors for ``all_reduce``,
``all_gather_into_tensor`` and ``all_to_all_single`` (checked on an
H100), so no collective is staged through host memory.

Gradients follow the layer's one convention: the output of a collective is
consumed *replicated*, every rank computing the same function of it (the
reference's ``psum`` inside a ``shard_map`` whose result leaves it
replicated).  So ``all_reduce``'s backward is the identity, where
``torch.distributed.nn.functional``'s sums the cotangent over ranks (the
derivative of the sum of every rank's loss, which a replicated loss would
count once a rank).  ``enter`` is the other half: a replicated tensor that
each rank uses for its own partial work, whose gradient is the sum of the
ranks' cotangents (Megatron's copy-to-region).  MAX reductions and
``all_gather`` carry no gradient: they raise under autograd (the routing
ids a MoE layer gathers need none).

The sequence-parallel region (an LM whose "residual_seq" is bound) is
the one place where a tensor is a rank's *block*, not a replica: each
"model" rank holds its own block of the residual stream's sequence, and
its gradient is that block's only.  Two operations along one dimension
carry it, each the other's backward: ``gather`` takes each rank's block
to the whole tensor, which the rank consumes in its own *partial* work
(a column-parallel GEMM), so its backward sums the ranks' cotangents and
keeps this rank's block of the sum (a reduce-scatter; Megatron's
gather-from-sequence-parallel region); ``reduce_scatter`` sums the
ranks' partials and keeps this rank's block (a row-parallel GEMM's
output), so its backward all-gathers the blocks' cotangents.  The
reduce-scatter is an ``all_to_all_single`` of the operand's blocks and a
sum of the received blocks in rank order: the bytes of a ring's
reduce-scatter, one code path on gloo (CUDA tensors included), NCCL and
the dry run's fake backend, and the same sum on every run.  Its wire
bytes are its operand's, ~(n - 1)/n of which a ring sends a rank, so a
reduce-scatter and an all-gather weigh what the all-reduce they replace
weighs (twice the tensor).  This departs from the reference's dry run,
which counts a reduce-scatter at its result's bytes (1/n of that):
counted so, the sequence-parallel step would seem to move half the
bytes of the all-reduce form, where the wire carries the same.

Training over data-parallel ranks adds two pieces, which stand in for
what the reference's GSPMD inserts implicitly.  ``block_mean`` makes a
loss the mean over the batch's blocks: each rank's own block mean divided
by the blocks, summed by ``all_reduce``; so every rank holds the global
loss, and its backward differentiates its own block's share only.
``reduce_grads`` then sums each gradient leaf over the data axes that its
spec does not shard, which gives every rank the gradient of the global
loss.  Without sequence parallelism nothing else is reduced: a leaf
replicated over "model" already holds the whole gradient on each rank,
since every partial consumer of a replicated tensor entered through
``enter``.  With it, every leaf replicated over "model" (the norms, a MoE
router) is consumed on this rank's sequence block only, so its gradient
is that block's share: the cell then passes "model" among the ``axes``,
and ``reduce_grads`` sums such leaves over it by the same rule (their
spec does not shard over "model"), while a leaf sharded over "model"
keeps its own.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

_KINDS = ("all_reduce", "all_gather", "reduce_scatter", "gather")
calls = dict.fromkeys(_KINDS, 0)
nbytes = dict.fromkeys(_KINDS, 0)

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
# a rank's bytes on the wire per byte of the counted tensor (ring
# algorithms): the result's, but a reduce-scatter's operand's
_WIRE_FACTOR = {"all_reduce": 2, "all_gather": 1, "reduce_scatter": 1,
                "gather": 1}
_recorders: list = []


def reset() -> None:
    """Set every count to 0."""
    for k in calls:
        calls[k] = nbytes[k] = 0


@contextlib.contextmanager
def recording(fn):
    """Call ``fn(kind, wire_bytes, group)`` for each collective of the
    enclosed calls."""
    _recorders.append(fn)
    try:
        yield
    finally:
        _recorders.remove(fn)


def _count(kind: str, t: torch.Tensor, group) -> None:
    calls[kind] += 1
    wire = _WIRE_FACTOR[kind] * t.numel() * t.element_size()
    nbytes[kind] += wire
    for fn in _recorders:
        fn(kind, wire, group)


def _wants_grad(x: torch.Tensor) -> bool:
    return x.requires_grad and torch.is_grad_enabled()


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        _count("all_reduce", g, ctx.group)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The elementwise ``op`` ("sum" or "max") of ``x`` over the ranks of
    ``group``.  Without autograd ``x`` is reduced in place and returned;
    under autograd (sum only) a new tensor whose gradient is the identity."""
    _count("all_reduce", x, group)
    if _wants_grad(x):
        if op != "sum":
            raise NotImplementedError(f"all_reduce {op!r} under autograd")
        return _AllReduce.apply(x, group)
    if not x.is_contiguous():
        raise ValueError("all_reduce reduces in place: pass a contiguous "
                         "tensor")
    dist.all_reduce(x, op=_OPS[op], group=group)
    return x


def enter(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (replicated over ``group``) as the input of each rank's own
    partial work: the identity forward, the sum over ``group`` of the
    ranks' gradients backward."""
    if _wants_grad(x):
        return _Enter.apply(x, group)
    return x


def block_mean(x: torch.Tensor, axes) -> torch.Tensor:
    """The mean over the ranks of the mesh ``axes`` (of the bound mesh) of
    each rank's ``x``, a mean over its equal block of the batch: the
    global mean, the same on every rank, whose gradient on each rank is
    that of its own term (``all_reduce``'s identity backward).  ``x``
    itself where ``axes`` hold one rank."""
    from repro_torch.dist import logical

    n = logical.shards(axes, logical.current_mesh()) if axes else 1
    if n == 1:
        return x
    return all_reduce((x / n).reshape(1), logical.group(axes))[0]


def reduce_grads(grads: list, specs: list, mesh, axes) -> list:
    """Sum, over the mesh ``axes`` (the data axes), each gradient leaf
    whose spec does not shard over them; ``specs`` holds a ``Spec`` a
    leaf.  A leaf sharded over some of ``axes`` is summed over the others.
    Returns the summed leaves (each reduced in place, or in a contiguous
    copy)."""
    from repro_torch.dist.logical import as_axes, shards

    out = []
    for g, spec in zip(grads, specs):
        held = {a for b in spec for a in as_axes(b)}
        rest = tuple(a for a in as_axes(axes) if a not in held)
        if rest and shards(rest, mesh) > 1:
            g = all_reduce(g.contiguous(), mesh.group(rest))
        out.append(g)
    return out


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` stacked in group-rank order: [W, *x.shape].  No
    gradient yet (it raises under autograd)."""
    if _wants_grad(x):
        raise NotImplementedError("all_gather under autograd")
    w = dist.get_world_size(group)
    flat = x.contiguous().reshape(1, -1)
    out = torch.empty((w, flat.shape[1]), dtype=x.dtype, device=x.device)
    _count("all_gather", out, group)
    dist.all_gather_into_tensor(out, flat, group=group)
    return out.reshape(-1, *x.shape)


def _blocks(x: torch.Tensor, w: int, dim: int) -> torch.Tensor:
    """``x`` cut into ``w`` equal blocks along ``dim``, stacked first and
    contiguous: [w, *x.shape with x.shape[dim] // w]."""
    n = x.shape[dim]
    if n % w:
        raise ValueError(f"dimension {dim} of {n} does not split over {w} "
                         f"ranks")
    shape = (*x.shape[:dim], w, n // w, *x.shape[dim + 1:])
    return x.reshape(shape).movedim(dim, 0).contiguous()


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    _count("reduce_scatter", x, group)
    w = dist.get_world_size(group)
    send = _blocks(x, w, dim)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    out = recv[0].clone()
    for i in range(1, w):   # rank order: the same sum on every run
        out += recv[i]
    return out


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    w = dist.get_world_size(group)
    flat = x.contiguous().reshape(1, -1)
    out = torch.empty((w, flat.shape[1]), dtype=x.dtype, device=x.device)
    _count("gather", out, group)
    dist.all_gather_into_tensor(out, flat, group=group)
    shape = (*x.shape[:dim], w * x.shape[dim], *x.shape[dim + 1:])
    return out.reshape(w, *x.shape).movedim(0, dim).reshape(shape)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.group, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.group, ctx.dim), None, None


def reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum over the ranks of ``group`` of their ``x`` (each a partial
    of the whole), of which this rank keeps its block along ``dim`` (the
    group-rank-th of equal blocks).  Its gradient is the all-gather of the
    blocks' cotangents (``gather``)."""
    if _wants_grad(x):
        return _ReduceScatter.apply(x, group, dim)
    return _reduce_scatter(x, group, dim)


def gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's block ``x`` joined along ``dim`` in group-rank order:
    the whole tensor, for this rank's *partial* work.  Its gradient is
    this rank's block of the sum of the ranks' cotangents
    (``reduce_scatter``)."""
    if _wants_grad(x):
        return _Gather.apply(x, group, dim)
    return _gather(x, group, dim)
