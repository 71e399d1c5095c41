"""Optimizers over the reference's parameter pytrees, on torch tensors.

Counterpart of ``repro.train.optimizer``, with its formulas and defaults:

- ``adamw``  : LM / GNN training; b2 = 0.95, moments in float32 whatever
  the parameter's dtype, the update ``(m/bc1) / (sqrt(v/bc2) + eps)`` with
  the weight decay added to it.
- ``rowwise_adagrad``: DLRM-style embedding training; one float32
  accumulator a row (the mean of g^2 over the row) for a 2-D embedding
  table, full accumulators elsewhere.  A leaf is an embedding table by the
  reference's path rule: a dict key on its path in ``embedding_keys`` and
  two dimensions.
- ``sgd``    : baseline, with optional momentum.

Each factory returns an ``Optimizer`` of (init, update):
    state = init(params)
    params, state = update(params, grads, state)
``params`` is a pytree of tensors (a model's ``tree()``: its
``nn.Parameter``s) and ``grads`` the same tree of gradients.  Where the
reference returns new arrays, ``update`` writes the new values into the
parameter and state tensors in place (a multi-GB table has no room for a
second copy) and returns the same trees.

``rowwise_adagrad`` updates a table, and ``adamw`` every leaf, in chunks
of rows along the first dimension (``CHUNK_ELEMENTS`` elements each) with
the same elementwise arithmetic, so the float32 temporaries stay near
256 MB each: dlrm-rm2's 16.6 GB bf16 table would need 33 GB for one
whole-table float32 copy, llama3.2-3b's stacked [28, 3072, 8192] weights
2.8 GB.  A row whose gradient is zero comes out of ``rowwise_adagrad``
bitwise unchanged (``a + 0``; ``p - 0`` rounds back to p).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.common.tree import tree_leaves, tree_map, tree_map_with_path

# Elements of a table a rowwise_adagrad chunk covers (its float32
# temporaries are this many elements each).
CHUNK_ELEMENTS = 1 << 26


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable
    name: str = ""


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _row_chunks(p: torch.Tensor):
    """Slices of ``p``'s first dimension of about CHUNK_ELEMENTS each (one
    slice over a 0-d tensor)."""
    if p.dim() == 0:
        yield ...  # the whole of a 0-d tensor
        return
    rows = max(1, CHUNK_ELEMENTS // max(p[0].numel(), 1))
    for s in range(0, p.shape[0], rows):
        yield slice(s, s + rows)


def sgd(lr: float = 0.01, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum:
            return {"mu": tree_map(torch.zeros_like, params)}
        return {}

    @torch.no_grad()
    def update(params, grads, state):
        if momentum:
            def step(p, mu, g):
                mu.copy_(momentum * mu + g)
                p.copy_(p - lr * mu)
            tree_map(step, params, state["mu"], grads)
        else:
            tree_map(lambda p, g: p.copy_(p - lr * g), params, grads)
        return params, state

    return Optimizer(init, update, f"sgd(lr={lr})")


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        leaf = tree_leaves(params)[0]
        return {"m": tree_map(_zeros_f32, params),
                "v": tree_map(_zeros_f32, params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=leaf.device)}

    @torch.no_grad()
    def update(params, grads, state):
        step = state["step"] + 1
        t = step.float()
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t

        def upd(p, m, v, g):
            g32 = g.float()
            m.copy_(b1 * m + (1 - b1) * g32)
            v.copy_(b2 * v + (1 - b2) * g32.square())
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            p.copy_((p.float() - lr * u).to(p.dtype))

        def upd_chunked(p, m, v, g):
            for rows in _row_chunks(p):
                upd(p[rows], m[rows], v[rows], g[rows])

        tree_map(upd_chunked, params, state["m"], state["v"], grads)
        state["step"] = step
        return params, state

    return Optimizer(init, update, f"adamw(lr={lr})")


def rowwise_adagrad(lr: float = 0.01, eps: float = 1e-8,
                    embedding_keys: tuple[str, ...] = ("table", "hot", "cold"),
                    ) -> Optimizer:
    """AdaGrad with row-wise accumulators for 2-D embedding tables (one
    scalar per row) and full accumulators elsewhere."""

    def is_table(path, p) -> bool:
        return p.dim() == 2 and any(
            isinstance(k, str) and k in embedding_keys for k in path)

    def init(params):
        def acc(path, p):
            if is_table(path, p):
                return torch.zeros((p.shape[0], 1), dtype=torch.float32,
                                   device=p.device)
            return _zeros_f32(p)
        return {"acc": tree_map_with_path(acc, params)}

    def step(p, g, a, rowwise: bool):
        g32 = g.float()
        a.add_(g32.square().mean(dim=1, keepdim=True) if rowwise
               else g32.square())
        p.copy_((p.float() - lr * g32 / (torch.sqrt(a) + eps)).to(p.dtype))

    @torch.no_grad()
    def update(params, grads, state):
        def upd(path, p, g, a):
            if not is_table(path, p):
                step(p, g, a, False)
                return
            for rows in _row_chunks(p):
                step(p[rows], g[rows], a[rows], True)

        tree_map_with_path(upd, params, grads, state["acc"])
        return params, state

    return Optimizer(init, update, f"rowwise_adagrad(lr={lr})")
