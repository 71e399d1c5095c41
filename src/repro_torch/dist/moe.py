"""Mixture-of-experts dispatch into capacity buffers (Switch-style), on
one device and expert-parallel.

Counterpart of ``repro.dist.moe``.  Each token's top-k assignments are
routed into fixed-size per-expert buffers (the grouped-GEMM layout
``[E, capacity, d]``), so expert compute is O(N·k) rather than the dense
oracle's O(E·N) (``repro_torch.models.layers.apply_moe_dense``).
``e_start``/``e_count`` keep the reference's expert window: partial
outputs over disjoint windows sum to the full one.

That invariant is the expert-parallel dataflow: with a "model" mesh axis
bound, ``moe_apply`` runs on a rank whose expert stacks are its window
[r * E_pad / W, (r + 1) * E_pad / W) (``param_spec_tree``'s rule, [L, E,
...] sharded on E); the rank routes every token of its batch block over
all experts, as the reference computes the ranks, computes its window's
partial, and one ``all_reduce`` over "model" sums the partials.  The
shared expert is added once: after the sum where it is whole on every
rank, inside it where it is tensor-parallel (``param_spec_tree`` shards
its ``w_gate``/``w_up`` columns and ``w_down`` rows over "model", as an
LM cell on a mesh holds them), its partial output then added to the
window's.  The reference's GSPMD lowers the same function to all-to-alls
of the capacity buffers; the window-and-sum form is the one its invariant
pins (``test_expert_partials_sum_to_full``).

Under autograd the window uses the router's top-k weights and the tokens
partially, so both pass through ``collectives.enter`` on their way into
it (their gradient summed over "model"); the router itself and its aux
loss run whole on every rank, which gives every rank the router's whole
gradient, counted once.  Under an LM's sequence parallelism the tokens
arrive as this rank's sequence blocks instead, and are gathered
(``moe_apply``'s ``seq_batch``).

Routing keeps the reference's global semantics where "batch" is bound to
data axes of more than one rank (each rank holding its block of the
tokens, blocks in global token order): the aux loss's per-expert sums
(``me``, ``ce``) are summed over the data ranks, the capacity is that of
all the tokens, and the dispatch positions come from every data rank's
top-k ids (one ``all_gather``, which needs no gradient), so exactly the
tokens that the one-device layer drops are dropped.  Each rank then
computes only its own tokens' slots of the [E, capacity, d] buffers.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives, logical
from repro_torch.models.layers import MoEConfig, apply_swiglu, moe_router


def expert_capacity(n_tokens: int, cfg: MoEConfig) -> int:
    """Per-expert buffer slots for ``n_tokens``: the uniform-routing share
    ``n·k/E`` scaled by the capacity factor, rounded up to a multiple of 8
    (the reference's TPU sublane alignment, kept so that the same tokens
    drop).  With capacity_factor >= 1, capacity · E >= n · k."""
    want = math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return -(-want // 8) * 8


def dispatch_indices(topk: torch.Tensor, n_experts: int, capacity: int,
                     e_start: int = 0, e_count: int | None = None):
    """Slot assignment for the capacity buffers of experts
    ``[e_start, e_start + e_count)``.

    topk: [n, k] expert ids in [0, n_experts) (position priority: earlier
    tokens win slots when an expert oversubscribes its capacity).

    Returns, as the reference's:
      buf_token: [e_count * capacity] int32, the token feeding each slot
                 (slot layout ``(e - e_start) * capacity + rank``; 0 where
                 empty)
      buf_valid: [e_count * capacity] bool, slot occupied
      slot_of:   [n, k] int32, the slot of each assignment, -1 if dropped
                 (over capacity or outside the expert window)
    """
    if e_count is None:
        e_count = n_experts
    n, k = topk.shape
    dev = topk.device
    flat = topk.reshape(-1).long()                            # [n*k]
    token_of = torch.arange(n * k, device=dev) // k
    # rank of each assignment within its expert, in flat (position) order,
    # over ALL experts so that a window sees the ranks of the full
    # dispatch: a stable sort by expert, less each expert's first place
    order = torch.argsort(flat, stable=True)
    # bincount's counts (it has no meta kernel, which the dry run traces)
    counts = torch.zeros(n_experts, dtype=flat.dtype, device=dev).index_add_(
        0, flat, torch.ones_like(flat))
    first = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(flat)
    rank[order] = torch.arange(n * k, device=dev) - first[flat[order]]

    keep = (rank < capacity) & (flat >= e_start) & (flat < e_start + e_count)
    slot = (flat - e_start) * capacity + rank
    slot_of = torch.where(keep, slot, -1).reshape(n, k).to(torch.int32)
    buf_token, buf_valid = _buffers(slot_of, e_count * capacity)
    return buf_token, buf_valid, slot_of


def _buffers(slot_of: torch.Tensor, n_slots: int):
    """The capacity buffers' (buf_token int32, buf_valid) of the
    assignments ``slot_of`` [n, k] (-1: dropped), as ``dispatch_indices``
    returns them."""
    n, k = slot_of.shape
    dev = slot_of.device
    slot = slot_of.reshape(-1).long()
    keep = slot >= 0
    token_of = torch.arange(n * k, device=dev) // k
    scatter_to = torch.where(keep, slot, n_slots)             # drops: spill row
    buf_token = torch.zeros(n_slots + 1, dtype=torch.long, device=dev
                            ).scatter_(0, scatter_to, token_of)[:n_slots]
    buf_valid = torch.zeros(n_slots + 1, dtype=torch.bool, device=dev
                            ).scatter_(0, scatter_to, keep)[:n_slots]
    return buf_token.to(torch.int32), buf_valid


def _data_axes() -> tuple:
    """The mesh axes the bound "batch" shards the tokens over, where they
    hold more than one rank; () otherwise."""
    axes = logical.bound_axes("batch")
    if axes and logical.shards(axes, logical.current_mesh()) > 1:
        return axes
    return ()


def _route(params, x: torch.Tensor, cfg: MoEConfig, axes: tuple):
    """``moe_router`` over the tokens of every rank of ``axes`` (the data
    axes, and "model" where the ranks hold sequence blocks): this rank's
    (topk_idx, topk_weight) and the aux loss of all the tokens, the same
    on every rank (its gradient that of this rank's tokens' share)."""
    if not axes:
        return moe_router(params, x, cfg)
    group = logical.group(axes)
    n_all = x.shape[0] * logical.shards(axes, logical.current_mesh())
    logits = x.to(cfg.router_dtype) @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    topk_w, topk_idx = torch.topk(probs, cfg.top_k, dim=-1)
    topk_w = topk_w / topk_w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    E = cfg.n_experts
    me = collectives.all_reduce(probs.sum(dim=0), group) / n_all
    flat = topk_idx.reshape(-1)
    counts = torch.zeros((E,), dtype=probs.dtype, device=x.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=probs.dtype, device=x.device))
    ce = collectives.all_reduce(counts, group) / (n_all * cfg.top_k)
    aux = E * (me * ce).sum()
    return topk_idx, topk_w.to(x.dtype), aux


def _slots(topk_idx: torch.Tensor, cfg: MoEConfig, capacity: int,
           e_start: int, e_count: int, data_axes: tuple) -> torch.Tensor:
    """``dispatch_indices``' slot_of for this rank's tokens; with data
    axes, ranked among every data rank's assignments in global order."""
    e_pad = cfg.n_experts_padded
    if not data_axes:
        return dispatch_indices(topk_idx, e_pad, capacity, e_start,
                                e_count)[2]
    n = topk_idx.shape[0]
    every = collectives.all_gather(topk_idx, logical.group(data_axes))
    i = logical.shard_index(logical.current_mesh(), data_axes)
    slot_of = dispatch_indices(every.reshape(-1, topk_idx.shape[1]), e_pad,
                               capacity, e_start, e_count)[2]
    return slot_of[i * n:(i + 1) * n]


def moe_apply_grouped(params, x: torch.Tensor, cfg: MoEConfig, *,
                      e_start: int = 0, e_count: int | None = None,
                      capacity: int | None = None, expert_base: int = 0):
    """Routed-expert output via the capacity-buffer dispatch.

    x: [N, d].  Computes only experts ``[e_start, e_start + e_count)``
    (the whole padded range by default) and does NOT add the shared expert
    (see :func:`moe_apply`).  ``expert_base``: the expert that row 0 of
    the expert stacks holds (a rank's window starts past 0).  Returns
    ([N, d], aux_loss); a dropped assignment contributes zero.  With
    "batch" bound to data axes the routing is global (module
    docstring)."""
    return _routed(params, x, x, cfg, e_start=e_start, e_count=e_count,
                   capacity=capacity, expert_base=expert_base)


def _routed(params, x: torch.Tensor, x_in: torch.Tensor, cfg: MoEConfig, *,
            e_start: int = 0, e_count: int | None = None,
            capacity: int | None = None, expert_base: int = 0, widen=None,
            route_axes: tuple = ()):
    """``moe_apply_grouped`` with the router fed ``x`` and the experts
    ``x_in``: x itself, or ``widen(x)``, x entered into the "model" group
    or its sequence blocks gathered over it, whose top-k ids and weights
    are then widened too.  The router runs over the ranks of the data axes
    and ``route_axes``."""
    e_pad = cfg.n_experts_padded
    if e_count is None:
        e_count = e_pad
    d = x.shape[1]
    n = x_in.shape[0]
    data_axes = _data_axes()
    if capacity is None:
        n_all = n * (logical.shards(data_axes, logical.current_mesh())
                     if data_axes else 1)
        capacity = expert_capacity(n_all, cfg)

    topk_idx, topk_w, aux = _route(params, x, cfg, data_axes + route_axes)
    if widen is not None:
        topk_idx, topk_w = widen(topk_idx), widen(topk_w)
    slot_of = _slots(topk_idx, cfg, capacity, e_start, e_count, data_axes)
    buf_token, buf_valid = _buffers(slot_of, e_count * capacity)
    x = x_in

    # gather tokens into the [e, capacity, d] buffers (zero for empty slots)
    xb = x[buf_token.long()] * buf_valid[:, None].to(x.dtype)
    xb = xb.reshape(e_count, capacity, d)
    ex = params["experts"]
    e0, held = e_start - expert_base, ex["w_gate"].shape[0]
    if e0 < 0 or e0 + e_count > held:
        raise ValueError(f"experts [{e_start}, {e_start + e_count}) are not "
                         f"in the stacks' [{expert_base}, "
                         f"{expert_base + held})")
    wg, wu, wd = (ex[name][e0:e0 + e_count]
                  for name in ("w_gate", "w_up", "w_down"))
    h = F.silu(torch.einsum("ecd,edf->ecf", xb, wg)) * torch.einsum(
        "ecd,edf->ecf", xb, wu)
    y = torch.einsum("ecf,efd->ecd", h, wd).reshape(e_count * capacity, d)

    # combine: out[t] = sum_j w[t, j] * y[slot_of[t, j]] over kept ones
    kept = slot_of >= 0
    rows = y[slot_of.clamp_min(0).long().reshape(-1)].reshape(n, cfg.top_k, d)
    w = topk_w * kept.to(topk_w.dtype)
    return torch.einsum("nk,nkd->nd", w, rows), aux


def moe_apply(params, x: torch.Tensor, cfg: MoEConfig, *,
              seq_batch: int | None = None):
    """The MoE layer: routed experts (grouped dispatch over the whole
    padded expert range, expert-parallel when a "model" axis is bound, the
    expert stacks then this rank's window) plus the always-on shared
    expert (whole, or this rank's tensor-parallel columns of it).  x: [N,
    d] -> ([N, d], aux_loss).

    ``seq_batch`` (a "model" axis bound): x is this rank's sequence block
    of each of ``seq_batch`` sequences, [seq_batch * T / W, d] row-major,
    the W "model" ranks holding the blocks in order (an LM's residual
    stream under sequence parallelism), and so is the output.  The router
    then runs on the block, its sums over the "model" ranks too, and its
    top-k ids and weights and the tokens are gathered along the sequence
    (``collectives.gather``), so that every rank's expert window sees its
    data block's tokens in the one-device order; the window's partial
    output, the tensor-parallel shared expert's added, is summed by a
    ``reduce_scatter`` into this rank's block.  The router's gradient is
    then its block's share, summed over "model" with the norms'
    (``collectives.reduce_grads``)."""
    axis = logical.model_axis_name()
    if axis is None:
        out, aux = moe_apply_grouped(params, x, cfg)
        if cfg.n_shared:
            out = out + apply_swiglu(params["shared"], x)
        return out, aux
    mesh = logical.current_mesh()
    group = logical.group(axis)
    w = logical.shards(axis, mesh)
    e_pad = cfg.n_experts_padded
    held = params["experts"]["w_gate"].shape[0]
    if e_pad % w or held != e_pad // w:
        raise ValueError(f"expert stacks of {held} experts are not a "
                         f"window of {e_pad} over {w} ranks")
    e_count = e_pad // w
    e_start = logical.shard_index(mesh, axis) * e_count
    d = x.shape[1]
    if seq_batch is None:
        def widen(t):
            return collectives.enter(t, group)
        route_axes = ()
    else:
        def widen(t):
            whole = collectives.gather(t.reshape(seq_batch, -1, t.shape[-1]),
                                       group, 1)
            return whole.reshape(-1, t.shape[-1])
        route_axes = logical.as_axes(axis)
    x_in = widen(x)
    out, aux = _routed(params, x, x_in, cfg, e_start=e_start,
                       e_count=e_count, expert_base=e_start, widen=widen,
                       route_axes=route_axes)
    shared_cols = params["shared"]["w_gate"].shape[-1] if cfg.n_shared else 0
    if shared_cols and shared_cols * w == cfg.shared_width and w > 1:
        # tensor-parallel shared expert: its partial joins the window's
        out = out + apply_swiglu(params["shared"], x_in)
        shared_cols = 0
    elif shared_cols and shared_cols != cfg.shared_width:
        raise ValueError(f"shared expert of {shared_cols} columns is neither "
                         f"whole ({cfg.shared_width}) nor a block of it "
                         f"over {w} ranks")
    if seq_batch is None:
        out = collectives.all_reduce(out.contiguous(), group)
    else:
        out = collectives.reduce_scatter(out.reshape(seq_batch, -1, d),
                                         group, 1).reshape(-1, d)
    if shared_cols:
        out = out + apply_swiglu(params["shared"], x)
    return out, aux


def expert_parallel_specs(params):
    """The spec tree of an MoE layer's parameters under expert
    parallelism: the expert stacks [..., E, ...] sharded on E over "model"
    (``param_spec_tree``'s rule, ``stack`` leading dims left whole), the
    router and the shared expert replicated."""
    from repro_torch.dist.sharding import Spec, replicated_specs

    specs = replicated_specs(params)
    e_dim = {k: w.dim() - 3 for k, w in params["experts"].items()}
    specs["experts"] = {k: Spec((None,) * d + ("model", None, None))
                        for k, d in e_dim.items()}
    return specs
