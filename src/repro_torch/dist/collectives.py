"""The collectives of the distributed layer, in one place.

Every dataflow of ``repro_torch.dist`` moves data between ranks only
through these wrappers, so their ``calls`` are the port's record of
collective traffic (the collectives a remat'ed block runs again in the
backward included).  They use whatever backend the caller initialised the
process group with; nothing here picks gloo or NCCL, and nothing copies a
tensor to the host: gloo in torch 2.11 takes CUDA tensors for both
(checked on an H100), so no collective is staged through host memory.

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

Training over data-parallel ranks adds two pieces, which stand in for
what the reference's GSPMD inserts implicitly.  ``block_mean`` makes a
loss the mean over the batch's blocks: each rank's own block mean divided
by the blocks, summed by ``all_reduce``; so every rank holds the global
loss, and its backward differentiates its own block's share only.
``reduce_grads`` then sums each gradient leaf over the data axes that its
spec does not shard, which gives every rank the gradient of the global
loss.  Nothing else is reduced: a leaf replicated over "model" already
holds the whole gradient on each rank, since every partial consumer of a
replicated tensor entered through ``enter``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

calls = {"all_reduce": 0, "all_gather": 0}

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def reset() -> None:
    """Set every count to 0."""
    for k in calls:
        calls[k] = 0


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
        calls["all_reduce"] += 1
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The elementwise ``op`` ("sum" or "max") of ``x`` over the ranks of
    ``group``.  Without autograd ``x`` is reduced in place and returned;
    under autograd (sum only) a new tensor whose gradient is the identity."""
    calls["all_reduce"] += 1
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
    calls["all_gather"] += 1
    w = dist.get_world_size(group)
    flat = x.contiguous().reshape(1, -1)
    out = torch.empty((w, flat.shape[1]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, flat, group=group)
    return out.reshape(-1, *x.shape)
