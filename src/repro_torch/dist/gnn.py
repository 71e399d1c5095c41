"""Sharded GraphSAGE: the edge list over every mesh axis, or whole graphs
over the data axes.

Counterpart of ``repro.dist.gnn``, whose ``shard_map`` bodies are written
out here over ``torch.distributed``:

- Full graph: each rank holds one block of the edge list (its block
  index over all mesh axes, major first), gathers the messages of its
  edges from the replicated node states and adds them into a partial
  [N, d] aggregate; an ``all_reduce`` over the whole mesh gives the exact
  full-graph aggregate (sum and mean are linear in the edge set; max
  reduces with MAX, a node with no in-edge in a shard taking -inf there
  and 0 in the end).  The dense SAGE combine runs replicated.  Under
  autograd the node states enter each rank's gather through
  ``collectives.enter`` (their gradient summed over the ranks) and the
  aggregate's ``all_reduce`` passes its gradient through, so a replicated
  loss gives every rank the single-device parameter gradients.
- Batched small graphs (molecule cells): each rank takes a contiguous block
  of whole graphs over the data axes, rebases the global node and graph
  ids to its block and runs the plain batched forward; no collective.
"""
from __future__ import annotations

import torch

from repro_torch.dist import collectives
from repro_torch.dist.logical import shard_index, shards
from repro_torch.models import gnn as gnn_lib


def _sharded_aggregate(h, edges_local, mesh, n_nodes: int, aggregator: str):
    """Exact full-graph aggregation from this rank's edge block: h [N, d]
    replicated, edges_local [2, E_local] (global node ids) -> (aggregate
    [N, d], in-degree [N, 1]), both replicated."""
    group = mesh.group(mesh.axis_names)
    src, dst = edges_local[0].long(), edges_local[1].long()
    if aggregator == "max":
        msg = h.index_select(0, src)
        agg = torch.full((n_nodes, h.shape[1]), -torch.inf, dtype=h.dtype,
                         device=h.device)
        agg = agg.scatter_reduce(0, dst[:, None].expand_as(msg), msg, "amax",
                                 include_self=True)
        agg = torch.where(torch.isfinite(agg), agg, -torch.inf)
        agg = collectives.all_reduce(agg, group, op="max")
        agg = torch.where(torch.isfinite(agg), agg, 0.0)
        return agg, torch.ones((n_nodes, 1), dtype=h.dtype, device=h.device)
    agg = gnn_lib._GatherSum.apply(collectives.enter(h, group), src, dst,
                                   n_nodes)
    deg = torch.zeros(n_nodes, dtype=h.dtype, device=h.device).index_add_(
        0, dst, torch.ones(dst.shape[0], dtype=h.dtype, device=h.device))
    return (collectives.all_reduce(agg, group),
            collectives.all_reduce(deg, group)[:, None])


def edge_block(edges: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of a global edge list [2, E] sharded over every
    mesh axis (E must split evenly)."""
    n = shards(mesh.axis_names, mesh)
    E = edges.shape[1]
    if E % n:
        raise ValueError(f"{E} edges do not split into {n} shards")
    i = shard_index(mesh, mesh.axis_names)
    return edges[:, i * (E // n):(i + 1) * (E // n)]


def apply_full_sharded(params, feats, edges_local, labels, label_mask, cfg,
                       mesh, n_nodes: int) -> torch.Tensor:
    """Full-graph GraphSAGE forward and masked softmax CE with the edge
    list sharded: ``edges_local`` is this rank's block (``edge_block``),
    everything else replicated.  The single-device ``apply_full`` then
    ``softmax_ce``; returns the scalar loss, the same on every rank."""
    h = feats.to(cfg.dtype)
    for layer in params["layers"]:
        agg, deg = _sharded_aggregate(h, edges_local, mesh, n_nodes,
                                      cfg.aggregator)
        if cfg.aggregator == "mean":
            agg = agg / deg.clamp_min(1.0)
        h = gnn_lib._sage_combine(layer, h, agg, activate=True)
    return gnn_lib.softmax_ce(h @ params["cls"], labels, label_mask)


def graph_block(batch: dict, mesh, dp, n_graphs: int, n_nodes: int,
                n_edges: int) -> dict:
    """This rank's block of a uniformly packed batch of ``n_graphs`` graphs
    (graph g owns nodes [g * n_nodes, (g + 1) * n_nodes) and edges [g *
    n_edges, (g + 1) * n_edges)) with graphs sharded over the ``dp``
    axes."""
    n = shards(dp, mesh)
    if n_graphs % n:
        raise ValueError(f"{n_graphs} graphs do not tile {n} shards")
    g = n_graphs // n
    i = shard_index(mesh, dp)
    nodes = slice(i * g * n_nodes, (i + 1) * g * n_nodes)
    return {"feats": batch["feats"][nodes],
            "edges": batch["edges"][:, i * g * n_edges:(i + 1) * g * n_edges],
            "node_mask": batch["node_mask"][nodes],
            "graph_ids": batch["graph_ids"][nodes],
            "labels": batch["labels"][i * g:(i + 1) * g]}


def apply_batched_sharded(params, batch, cfg, mesh, dp, n_graphs: int,
                          n_nodes: int, n_edges: int):
    """Packed-small-graph forward with graphs sharded over the ``dp`` axes.

    ``batch``: this rank's block (``graph_block``): feats [g·n, d], edges
    [2, g·e] and graph_ids [g·n] with GLOBAL ids, node_mask [g·n], labels
    [g].  Rebases the ids to the block and runs the plain batched forward.
    Returns (logits [g, C], labels [g]), this rank's block, for the
    caller's loss."""
    n = shards(dp, mesh)
    if n_graphs % n:
        raise ValueError(f"{n_graphs} graphs do not tile {n} shards")
    g = n_graphs // n
    i = shard_index(mesh, dp)
    edges = batch["edges"] - i * (g * n_nodes)
    graph_ids = batch["graph_ids"] - i * g
    logits = gnn_lib.apply_batched(params, batch["feats"], edges,
                                   batch["node_mask"], graph_ids, g, cfg)
    return logits, batch["labels"]
