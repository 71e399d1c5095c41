"""Mixture-of-experts dispatch into capacity buffers (Switch-style),
single device.

Counterpart of ``repro.dist.moe``.  Each token's top-k assignments are
routed into fixed-size per-expert buffers (the grouped-GEMM layout
``[E, capacity, d]``), so expert compute is O(N·k) rather than the dense
oracle's O(E·N) (``repro_torch.models.layers.apply_moe_dense``).  The
reference annotates the buffers expert-sharded so that a mesh turns the
gather and scatter into all-to-alls; on one device there is nothing to
annotate, and the expert-parallel form waits for the ``torch.distributed``
layer.  ``e_start``/``e_count`` keep the reference's expert window:
partial outputs over disjoint windows sum to the full one.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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
    counts = torch.bincount(flat, minlength=n_experts)
    first = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(flat)
    rank[order] = torch.arange(n * k, device=dev) - first[flat[order]]

    keep = (rank < capacity) & (flat >= e_start) & (flat < e_start + e_count)
    slot = (flat - e_start) * capacity + rank
    slot_of = torch.where(keep, slot, -1).reshape(n, k).to(torch.int32)

    n_slots = e_count * capacity
    scatter_to = torch.where(keep, slot, n_slots)             # drops: spill row
    buf_token = torch.zeros(n_slots + 1, dtype=torch.long, device=dev
                            ).scatter_(0, scatter_to, token_of)[:n_slots]
    buf_valid = torch.zeros(n_slots + 1, dtype=torch.bool, device=dev
                            ).scatter_(0, scatter_to, keep)[:n_slots]
    return buf_token.to(torch.int32), buf_valid, slot_of


def moe_apply_grouped(params, x: torch.Tensor, cfg: MoEConfig, *,
                      e_start: int = 0, e_count: int | None = None,
                      capacity: int | None = None):
    """Routed-expert output via the capacity-buffer dispatch.

    x: [N, d].  Computes only experts ``[e_start, e_start + e_count)``
    (the whole padded range by default) and does NOT add the shared expert
    (see :func:`moe_apply`).  Returns ([N, d], aux_loss); a dropped
    assignment contributes zero."""
    e_pad = cfg.n_experts_padded
    if e_count is None:
        e_count = e_pad
    n, d = x.shape
    if capacity is None:
        capacity = expert_capacity(n, cfg)

    topk_idx, topk_w, aux = moe_router(params, x, cfg)
    buf_token, buf_valid, slot_of = dispatch_indices(
        topk_idx, e_pad, capacity, e_start, e_count)

    # gather tokens into the [e, capacity, d] buffers (zero for empty slots)
    xb = x[buf_token.long()] * buf_valid[:, None].to(x.dtype)
    xb = xb.reshape(e_count, capacity, d)
    ex = params["experts"]
    wg, wu, wd = (ex[name][e_start:e_start + e_count]
                  for name in ("w_gate", "w_up", "w_down"))
    h = F.silu(torch.einsum("ecd,edf->ecf", xb, wg)) * torch.einsum(
        "ecd,edf->ecf", xb, wu)
    y = torch.einsum("ecf,efd->ecd", h, wd).reshape(e_count * capacity, d)

    # combine: out[t] = sum_j w[t, j] * y[slot_of[t, j]] over kept ones
    kept = slot_of >= 0
    rows = y[slot_of.clamp_min(0).long().reshape(-1)].reshape(n, cfg.top_k, d)
    w = topk_w * kept.to(topk_w.dtype)
    return torch.einsum("nk,nkd->nd", w, rows), aux


def moe_apply(params, x: torch.Tensor, cfg: MoEConfig):
    """The MoE layer: routed experts (grouped dispatch over the whole
    padded expert range) plus the always-on shared expert.
    x: [N, d] -> ([N, d], aux_loss)."""
    out, aux = moe_apply_grouped(params, x, cfg)
    if cfg.n_shared:
        out = out + apply_swiglu(params["shared"], x)
    return out, aux
