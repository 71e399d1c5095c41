"""GraphSAGE (arXiv:1706.02216) — mean aggregator, 2 layers.

Counterpart of ``repro.models.gnn``.  Aggregation is a gather and a
scatter over an edge list (src -> dst): ``index_select`` and
``index_add`` (the reference's ``jnp.take`` and ``jax.ops.segment_sum``),
``scatter_reduce("amax")`` for the max aggregator.  None of it is a
Pallas kernel in the reference, so it stays plain torch here; on a card
``index_add`` adds in no fixed order, so sums differ from the CPU's by
rounding.  Three execution modes cover the assigned shapes:

- full   : full-graph training (cora / ogb_products scales) over an edge
           list [2, E];
- mini   : layer-wise sampled mini-batch (reddit) with fixed fanout: dense
           [B, f1, f2] blocks from ``repro_torch.data.graph``'s sampler;
           aggregation is a masked mean over the fanout axis;
- batched: many small graphs (molecule) packed block-diagonally; per-graph
           readout by a scatter over graph ids.

Parameters follow the reference's pytree (``{"layers": [{"w_self",
"w_neigh", "b"}...], "cls"}``, weights [in, out]); ``GraphSAGE.tree()``
gives it back.  The reference's ``logical.constrain`` (a sharding hint)
is a no-op on one device and is dropped.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.autograd.function import once_differentiable

from repro_torch.common.convert import tree_from_numpy
from repro_torch.common.init import xavier_init
from repro_torch.common.types import TensorSpec


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    d_feat: int
    d_hidden: int = 128
    n_layers: int = 2
    n_classes: int = 41
    aggregator: str = "mean"
    fanout: tuple[int, ...] = (25, 10)
    mode: str = "full"  # full | mini | batched
    readout: str = "node"  # node | graph
    dtype: torch.dtype = torch.float32


def _degree(dst: torch.Tensor, n_nodes: int, dtype) -> torch.Tensor:
    ones = torch.ones(dst.shape[0], dtype=dtype, device=dst.device)
    deg = torch.zeros(n_nodes, dtype=dtype, device=dst.device).index_add(
        0, dst, ones)
    return deg.clamp_min(1.0)[:, None]


class _GatherSum(torch.autograd.Function):
    """sum over edges (src -> dst) of h[src] into dst: ``index_select``
    then ``index_add_``, and the same two transposed for the gradient.
    Autograd's own ``index_add`` keeps the [E, d] messages for its
    backward (31 GB a layer at ogb_products); this keeps the edge list."""

    @staticmethod
    def forward(ctx, h, src, dst, n_nodes):
        ctx.save_for_backward(src, dst)
        ctx.h_rows = h.shape[0]
        out = torch.zeros((n_nodes, h.shape[1]), dtype=h.dtype,
                          device=h.device)
        return out.index_add_(0, dst, h.index_select(0, src))

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        src, dst = ctx.saved_tensors
        g = torch.zeros((ctx.h_rows, grad.shape[1]), dtype=grad.dtype,
                        device=grad.device)
        return g.index_add_(0, src, grad.index_select(0, dst)), None, None, None


def aggregate_full(h: torch.Tensor, edges: torch.Tensor, n_nodes: int,
                   aggregator: str = "mean") -> torch.Tensor:
    """Gather-scatter aggregation over an edge list. edges: [2, E].

    A node with no in-edges aggregates to 0 (``max`` included: the
    reference's segment_max gives -inf there and then 0)."""
    src, dst = edges[0].long(), edges[1].long()
    if aggregator == "max":
        msg = h.index_select(0, src)  # [E, d]
        out = torch.zeros((n_nodes, h.shape[1]), dtype=h.dtype,
                          device=h.device)
        return out.scatter_reduce(0, dst[:, None].expand_as(msg), msg, "amax",
                                  include_self=False)
    agg = _GatherSum.apply(h, src, dst, n_nodes)
    if aggregator == "mean":
        agg = agg / _degree(dst, n_nodes, h.dtype)
    return agg


def _sage_combine(layer, h_self, h_agg, activate=True):
    out = h_self @ layer["w_self"] + h_agg @ layer["w_neigh"] + layer["b"]
    return torch.relu(out) if activate else out


def apply_full(params, feats, edges, cfg: GNNConfig) -> torch.Tensor:
    """Full-graph forward: feats [N, d_feat], edges [2, E] -> logits [N, C]."""
    n_nodes = feats.shape[0]
    h = feats.to(cfg.dtype)
    for layer in params["layers"]:
        agg = aggregate_full(h, edges, n_nodes, cfg.aggregator)
        h = _sage_combine(layer, h, agg, activate=True)
    return h @ params["cls"]


def apply_minibatch(params, hop_feats, hop_masks, cfg: GNNConfig
                    ) -> torch.Tensor:
    """Sampled mini-batch forward with fixed fanout.

    hop_feats: list of L+1 tensors — hop_feats[j] has shape
      [B, f1, ..., fj, d_feat] (features of the j-hop frontier).
    hop_masks: matching validity masks [B, f1, ..., fj] (True = real edge);
      hop_masks[0] is unused.
    Layer i aggregates hop j=i+1 into hop j, shrinking the pyramid until
    only the seeds [B, d_hidden] remain. Returns logits [B, C].
    """
    L = cfg.n_layers
    h = [f.to(cfg.dtype) for f in hop_feats]
    for i, layer in enumerate(params["layers"]):
        nxt = []
        for j in range(L - i):
            m = hop_masks[j + 1][..., None].to(h[0].dtype)
            if cfg.aggregator == "max":
                # the reference's fill: a seed with no sampled neighbour
                # keeps -1e30 (finite, so its isfinite test keeps it)
                agg = torch.where(m > 0, h[j + 1], -1e30).amax(dim=-2)
            else:
                s = (h[j + 1] * m).sum(dim=-2)
                if cfg.aggregator == "mean":
                    s = s / m.sum(dim=-2).clamp_min(1.0)
                agg = s
            nxt.append(_sage_combine(layer, h[j], agg, activate=True))
        h = nxt
    return h[0] @ params["cls"]


def apply_batched(params, feats, edges, node_mask, graph_ids, n_graphs: int,
                  cfg: GNNConfig) -> torch.Tensor:
    """Packed small graphs: feats [Nt, d], edges [2, Et] (block-diagonal),
    graph_ids [Nt] -> graph logits [G, C] via mean readout."""
    n_nodes = feats.shape[0]
    h = feats.to(cfg.dtype)
    for layer in params["layers"]:
        agg = aggregate_full(h, edges, n_nodes, cfg.aggregator)
        h = _sage_combine(layer, h, agg, activate=True)
    mask = node_mask.to(h.dtype)
    h = h * mask[:, None]
    gid = graph_ids.long()
    summed = torch.zeros((n_graphs, h.shape[1]), dtype=h.dtype,
                         device=h.device).index_add(0, gid, h)
    counts = torch.zeros(n_graphs, dtype=h.dtype, device=h.device).index_add(
        0, gid, mask)
    pooled = summed / counts.clamp_min(1.0)[:, None]
    return pooled @ params["cls"]


def softmax_ce(logits, labels, mask=None) -> torch.Tensor:
    """Cross-entropy with integer labels; mask selects supervised rows."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    loss = logz - gold
    if mask is not None:
        m = mask.float()
        return (loss * m).sum() / m.sum().clamp_min(1.0)
    return loss.mean()


def input_specs(cfg: GNNConfig, shape_dims: dict) -> dict[str, TensorSpec]:
    """Shapes and dtypes of one batch of each mode (no allocation)."""
    d = shape_dims
    if cfg.mode == "full":
        n, e = d["n_nodes"], d["n_edges"]
        return {
            "feats": TensorSpec((n, cfg.d_feat), cfg.dtype),
            "edges": TensorSpec((2, e), torch.int32),
            "labels": TensorSpec((n,), torch.int32),
            "label_mask": TensorSpec((n,), torch.bool),
        }
    if cfg.mode == "mini":
        B = d["batch_nodes"]
        fan = d.get("fanout", cfg.fanout)
        specs = {}
        shape = (B,)
        for j in range(cfg.n_layers + 1):
            specs[f"hop{j}_feats"] = TensorSpec((*shape, cfg.d_feat),
                                                cfg.dtype)
            if j > 0:
                specs[f"hop{j}_mask"] = TensorSpec(shape, torch.bool)
            if j < cfg.n_layers:
                shape = (*shape, fan[j])
        specs["labels"] = TensorSpec((B,), torch.int32)
        return specs
    if cfg.mode == "batched":
        G, n, e = d["batch"], d["n_nodes"], d["n_edges"]
        Nt, Et = G * n, G * e
        return {
            "feats": TensorSpec((Nt, cfg.d_feat), cfg.dtype),
            "edges": TensorSpec((2, Et), torch.int32),
            "node_mask": TensorSpec((Nt,), torch.bool),
            "graph_ids": TensorSpec((Nt,), torch.int32),
            "labels": TensorSpec((G,), torch.int32),
        }
    raise ValueError(f"unknown mode {cfg.mode}")


class GraphSAGE(nn.Module):
    """GraphSAGE holding the reference's parameter pytree."""

    def __init__(self, cfg: GNNConfig, params):
        super().__init__()
        self.cfg = cfg
        layers = params["layers"]
        self.w_self = nn.ParameterList(
            [nn.Parameter(p["w_self"]) for p in layers])
        self.w_neigh = nn.ParameterList(
            [nn.Parameter(p["w_neigh"]) for p in layers])
        self.b = nn.ParameterList([nn.Parameter(p["b"]) for p in layers])
        self.cls = nn.Parameter(params["cls"])

    def tree(self):
        """The parameters as the reference's pytree (the same tensors)."""
        return {"layers": [{"w_self": ws, "w_neigh": wn, "b": b}
                           for ws, wn, b in zip(self.w_self, self.w_neigh,
                                                self.b)],
                "cls": self.cls}

    def forward(self, batch) -> torch.Tensor:
        """Logits of a batch of ``cfg.mode`` (``input_specs``' keys)."""
        cfg, p = self.cfg, self.tree()
        if cfg.mode == "full":
            return apply_full(p, batch["feats"], batch["edges"], cfg)
        if cfg.mode == "mini":
            L = cfg.n_layers
            return apply_minibatch(
                p, [batch[f"hop{j}_feats"] for j in range(L + 1)],
                [None] + [batch[f"hop{j}_mask"] for j in range(1, L + 1)],
                cfg)
        return apply_batched(p, batch["feats"], batch["edges"],
                             batch["node_mask"], batch["graph_ids"],
                             batch["labels"].shape[0], cfg)

    def loss(self, batch) -> torch.Tensor:
        """The train cells' loss: ``softmax_ce`` of the logits against the
        labels (the full mode's over its supervised mask)."""
        return softmax_ce(self(batch), batch["labels"],
                          batch.get("label_mask"))


def init(cfg: GNNConfig, *, generator: torch.Generator,
         device: torch.device) -> GraphSAGE:
    """A GraphSAGE with xavier weights drawn on ``device`` from
    ``generator`` (the reference's init; ``jax.random``'s numbers differ)."""
    kw = dict(generator=generator, device=device, dtype=cfg.dtype)
    layers = []
    d_in = cfg.d_feat
    for _ in range(cfg.n_layers):
        layers.append({
            "w_self": xavier_init((d_in, cfg.d_hidden), **kw),
            "w_neigh": xavier_init((d_in, cfg.d_hidden), **kw),
            "b": torch.zeros((cfg.d_hidden,), dtype=cfg.dtype, device=device),
        })
        d_in = cfg.d_hidden
    return GraphSAGE(cfg, {"layers": layers,
                           "cls": xavier_init((cfg.d_hidden, cfg.n_classes),
                                              **kw)})


def params_from_reference(tree, *, device: torch.device):
    """The reference ``gnn.init`` pytree (numpy leaves) as tensors on
    ``device``, ready for ``GraphSAGE(cfg, params)``."""
    return tree_from_numpy(tree, device)
