"""The collectives of the distributed layer, in one place.

Every dataflow of ``repro_torch.dist`` moves data between ranks only
through these two wrappers, so their ``calls`` are the port's record of
collective traffic.  They use whatever backend the caller initialised the
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
``all_gather`` carry no gradient yet: they raise under autograd.
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
