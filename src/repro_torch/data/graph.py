"""Graph data: synthetic power-law graphs in CSR form + the real layerwise
uniform neighbor sampler that feeds GraphSAGE mini-batch training.

Counterpart of ``repro.data.graph`` (numpy, bitwise the reference for the
same seed), with ``cell_batch``: a GNN train cell's inputs from a seed.

The sampler is the production piece (minibatch_lg requires it): given a CSR
adjacency, it draws fixed-fanout uniform samples per hop, padding nodes with
degree < fanout (mask=False), producing the dense [B, f1, ..., fj] id blocks
that repro_torch.models.gnn.apply_minibatch consumes.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray   # [N+1]
    indices: np.ndarray  # [E] neighbor ids
    feats: np.ndarray    # [N, d]
    labels: np.ndarray   # [N]

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def n_edges(self) -> int:
        return len(self.indices)

    def edge_list(self) -> np.ndarray:
        """[2, E] (src, dst): CSR row = dst, entries = src (in-neighbors)."""
        dst = np.repeat(np.arange(self.n_nodes), np.diff(self.indptr))
        return np.stack([self.indices, dst]).astype(np.int32)


def _stable_argsort(keys: np.ndarray, n_keys: int) -> np.ndarray:
    """``np.argsort(keys, kind="stable")`` for int keys in [0, n_keys):
    each key joined with its index is unique, so a plain sort of the
    joined keys gives the same order (several times faster than a stable
    argsort at 1e8 keys)."""
    shift = max(int(len(keys) - 1).bit_length(), 1)
    if int(n_keys - 1).bit_length() + shift > 62:
        return np.argsort(keys, kind="stable")
    joined = (keys.astype(np.int64) << shift) | np.arange(len(keys),
                                                          dtype=np.int64)
    joined.sort()
    return joined & ((1 << shift) - 1)


def synthetic_graph(n_nodes: int, avg_degree: int, d_feat: int, n_classes: int,
                    seed: int = 0, n_edges: int | None = None) -> CSRGraph:
    """Power-law (preferential-attachment-ish) synthetic graph in CSR, of
    ``n_edges`` edges (``n_nodes * avg_degree`` by default)."""
    rng = np.random.default_rng(seed)
    if n_edges is None:
        n_edges = n_nodes * avg_degree
    # power-law target popularity for edge endpoints
    pop = rng.zipf(1.3, n_edges * 2) % n_nodes
    src = pop[:n_edges].astype(np.int64)
    dst = rng.integers(0, n_nodes, n_edges)
    order = _stable_argsort(dst, n_nodes)
    src, dst = src[order], dst[order]
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.add.at(indptr, dst + 1, 1)
    indptr = np.cumsum(indptr)
    feats = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    return CSRGraph(indptr=indptr, indices=src.astype(np.int32),
                    feats=feats, labels=labels)


class NeighborSampler:
    """Uniform fixed-fanout layerwise sampler (GraphSAGE §3.1)."""

    def __init__(self, graph: CSRGraph, fanout: tuple[int, ...], seed: int = 0):
        self.g = graph
        self.fanout = fanout
        self.rng = np.random.default_rng(seed)

    def _sample_neighbors(self, nodes: np.ndarray, k: int):
        """nodes [M] -> (ids [M, k], mask [M, k]); no-neighbor rows masked."""
        g = self.g
        starts = g.indptr[nodes]
        degs = g.indptr[nodes + 1] - starts
        # uniform with replacement; degree-0 nodes get mask=False
        r = self.rng.integers(0, np.maximum(degs, 1)[:, None], (len(nodes), k))
        ids = g.indices[starts[:, None] + r]
        mask = (degs > 0)[:, None] & np.ones((1, k), bool)
        return ids.astype(np.int32), mask

    def sample_block(self, seeds: np.ndarray) -> dict:
        """Seeds [B] -> dense hop pyramid matching gnn.input_specs('mini')."""
        g = self.g
        out: dict[str, np.ndarray] = {"hop0_feats": g.feats[seeds]}
        frontier = seeds
        shape = (len(seeds),)
        mask_prev = np.ones(shape, bool)
        for j, k in enumerate(self.fanout, start=1):
            ids, mask = self._sample_neighbors(frontier.reshape(-1), k)
            shape = (*shape, k)
            ids = ids.reshape(shape)
            mask = mask.reshape(shape) & mask_prev[..., None]
            out[f"hop{j}_feats"] = g.feats[np.maximum(ids, 0)]
            out[f"hop{j}_mask"] = mask
            frontier, mask_prev = ids, mask
        out["labels"] = g.labels[seeds]
        return out


def pack_graphs(feats, edges, max_nodes: int, max_edges: int):
    """Pack G small graphs block-diagonally for gnn.apply_batched.

    feats: list of [n_i, d]; edges: list of [2, e_i]. Pads each graph to
    (max_nodes, max_edges); padded edges self-loop on a padded node.
    """
    G = len(feats)
    d = feats[0].shape[1]
    f_out = np.zeros((G * max_nodes, d), np.float32)
    e_out = np.zeros((2, G * max_edges), np.int32)
    node_mask = np.zeros((G * max_nodes,), bool)
    graph_ids = np.repeat(np.arange(G), max_nodes).astype(np.int32)
    for i, (f, e) in enumerate(zip(feats, edges)):
        n, ne = f.shape[0], e.shape[1]
        base_n, base_e = i * max_nodes, i * max_edges
        f_out[base_n : base_n + n] = f
        node_mask[base_n : base_n + n] = True
        e_out[:, base_e : base_e + ne] = e + base_n
        if ne < max_edges:  # pad: self-loops on the last padded node
            pad_node = base_n + max_nodes - 1
            e_out[:, base_e + ne : base_e + max_edges] = pad_node
    return f_out, e_out, node_mask, graph_ids


def cell_graph(cfg, dims: dict, seed: int) -> CSRGraph | None:
    """The synthetic graph a full or mini GNN cell draws from (None for a
    batched cell): ``dims["graph_nodes"]`` nodes at
    ``dims["graph_degree"]`` edges a node (a full graph: exactly
    ``dims["n_edges"]`` edges), ``cfg``'s features and classes."""
    if cfg.mode == "batched":
        return None
    return synthetic_graph(dims["graph_nodes"], dims["graph_degree"],
                           cfg.d_feat, cfg.n_classes, seed=seed,
                           n_edges=dims["n_edges"] if cfg.mode == "full"
                           else None)


def cell_batch(cfg, dims: dict, seed: int, graph: CSRGraph | None = None
               ) -> dict[str, np.ndarray]:
    """One batch (numpy) of a GNN train cell of ``cfg.mode`` at the sizes
    ``dims`` (``repro_torch.launch.steps``' ``CellProgram.dims``):

    - full: the whole ``cell_graph`` (features, edge list, labels) and a
      seeded half of its nodes as the supervised mask;
    - mini: ``NeighborSampler.sample_block`` of ``dims["batch_nodes"]``
      distinct seed nodes of ``cell_graph`` at ``dims["fanout"]``;
    - batched: ``pack_graphs`` of ``dims["batch"]`` random graphs, each of
      n_nodes/2..n_nodes nodes and n_edges/2..n_edges edges, padded to
      (n_nodes, n_edges), with a class each.

    ``graph`` is ``cell_graph(cfg, dims, seed)`` when the caller made it."""
    rng = np.random.default_rng([seed, 1])
    if cfg.mode == "batched":
        G, n, e = dims["batch"], dims["n_nodes"], dims["n_edges"]
        nodes = rng.integers(n // 2, n + 1, G)
        n_edges = rng.integers(e // 2, e + 1, G)
        feats = [rng.standard_normal((k, cfg.d_feat)).astype(np.float32)
                 for k in nodes]
        edges = [rng.integers(0, k, (2, m)).astype(np.int32)
                 for k, m in zip(nodes, n_edges)]
        f, ed, mask, gid = pack_graphs(feats, edges, n, e)
        return {"feats": f, "edges": ed, "node_mask": mask, "graph_ids": gid,
                "labels": rng.integers(0, cfg.n_classes, G).astype(np.int32)}
    g = graph if graph is not None else cell_graph(cfg, dims, seed)
    if cfg.mode == "full":
        return {"feats": g.feats, "edges": g.edge_list(), "labels": g.labels,
                "label_mask": rng.random(g.n_nodes) < 0.5}
    sampler = NeighborSampler(g, tuple(dims["fanout"]), seed=seed)
    seeds = rng.choice(g.n_nodes, dims["batch_nodes"], replace=False)
    return sampler.sample_block(seeds)
