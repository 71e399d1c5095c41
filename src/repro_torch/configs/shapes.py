"""Assigned input-shape cells per architecture family."""
from __future__ import annotations

from repro_torch.common.types import ShapeSpec

LM_SHAPES = (
    ShapeSpec("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
    ShapeSpec("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
    ShapeSpec("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
    ShapeSpec("long_500k", "decode", {"seq_len": 524288, "global_batch": 1}),
)

GNN_SHAPES = (
    ShapeSpec("full_graph_sm", "train",
              {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433}),
    ShapeSpec("minibatch_lg", "train",
              {"n_nodes": 232965, "n_edges": 114615892, "batch_nodes": 1024,
               "fanout": (15, 10), "d_feat": 602}),
    ShapeSpec("ogb_products", "train",
              {"n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100}),
    ShapeSpec("molecule", "train",
              {"n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 64}),
)

RECSYS_SHAPES = (
    ShapeSpec("train_batch", "train", {"batch": 65536}),
    ShapeSpec("serve_p99", "serve", {"batch": 512}),
    ShapeSpec("serve_bulk", "serve", {"batch": 262144}),
    ShapeSpec("retrieval_cand", "serve", {"batch": 1, "n_candidates": 1_000_000}),
)


def shapes_for(kind: str):
    return {"lm": LM_SHAPES, "gnn": GNN_SHAPES, "recsys": RECSYS_SHAPES}[kind]
