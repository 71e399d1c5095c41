"""Operator-level workload profiles.

Hercules classifies workloads by executing them on each server type; here
the execution engine is an analytic roofline over an *operator profile*
extracted from the real model configs. Each op
carries per-item (item = one candidate to rank / one token / one seed node)
flops and byte counts split by traffic class:

- stream_bytes : sequential activation traffic (DRAM/HBM streaming)
- gather_bytes : random-access embedding/table traffic (the NMP target)
- host_bytes   : host->accelerator input transfer (sparse ids, dense feats)
- weight_bytes : per-invocation weight reads (amortized over the batch)

``level`` encodes the dependency depth for op-parallelism modeling: ops at
the same level are independent (paper Fig. 5 — SparseNet ops parallelize,
the FC chain does not), so elapsed time with ``o`` workers is
``sum_level max(longest_op, level_work / o)`` — list-scheduling, which
reproduces the measured idle-cycle growth.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Sequence

import numpy as np

if TYPE_CHECKING:  # annotation only: core stays importable without torch
    from repro_torch.models.recsys_base import RecsysConfig


@dataclasses.dataclass(frozen=True)
class OpCost:
    name: str
    stage: str                 # "sparse" | "dense"
    level: int                 # dependency depth (for op-parallel modeling)
    flops: float = 0.0         # per item
    stream_bytes: float = 0.0  # per item
    gather_bytes: float = 0.0  # per item
    host_bytes: float = 0.0    # per item
    weight_bytes: float = 0.0  # per invocation
    sequential: bool = False   # recurrent op (GRU): no batch-dim speedup on MXU


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    name: str
    ops: tuple[OpCost, ...]
    table_gb: float            # embedding table footprint
    weight_gb: float           # dense weight footprint
    sla_ms: float              # paper Fig. 15 SLA targets
    # analytic hot-set hit rate: fraction of gather traffic served by a hot
    # cache holding `h` of `V` rows under the log-uniform popularity law.
    zipf_alpha: float = 1.05

    def hot_hit_rate(self, hot_frac: float) -> float:
        """P(access hits hottest `hot_frac` of rows) under log-uniform ids.

        ids ~ floor(V^u) with u = U(0,1)^alpha =>
        P(id < h) = P(u < log(h+1)/log V) = (log(h+1)/log V)^(1/alpha).
        """
        if hot_frac <= 0.0:
            return 0.0
        if hot_frac >= 1.0:
            return 1.0
        base = np.log1p(hot_frac * 1e7) / np.log(1e7)  # V-independent proxy
        return float(base ** (1.0 / self.zipf_alpha))

    @property
    def sparse_ops(self) -> tuple[OpCost, ...]:
        return tuple(op for op in self.ops if op.stage == "sparse")

    @property
    def dense_ops(self) -> tuple[OpCost, ...]:
        return tuple(op for op in self.ops if op.stage == "dense")

    def totals(self, ops: Sequence[OpCost] | None = None):
        ops = self.ops if ops is None else ops
        return {
            "flops": sum(o.flops for o in ops),
            "stream_bytes": sum(o.stream_bytes for o in ops),
            "gather_bytes": sum(o.gather_bytes for o in ops),
            "host_bytes": sum(o.host_bytes for o in ops),
            "weight_bytes": sum(o.weight_bytes for o in ops),
        }


def _mlp_cost(name, stage, level, sizes, dtype_bytes=4.0, seq=False):
    """Per-item FLOPs/bytes of an MLP [in, h1, ..., out]."""
    flops = 2.0 * sum(sizes[i] * sizes[i + 1] for i in range(len(sizes) - 1))
    act = sum(sizes) * dtype_bytes
    weights = sum(sizes[i] * sizes[i + 1] for i in range(len(sizes) - 1)) * dtype_bytes
    return OpCost(name=name, stage=stage, level=level, flops=flops,
                  stream_bytes=act, weight_bytes=weights, sequential=seq)


def profile_recsys(cfg: RecsysConfig, sla_ms: float) -> ModelProfile:
    """Build the operator profile from a RecsysConfig (per ranked item)."""
    emb = cfg.embedding
    ops: list[OpCost] = []
    d = emb.dim
    db = 4.0  # f32 serving

    if cfg.interaction in ("dot", "concat"):
        # one embedding-bag op per table: independent -> all level 0 sparse
        for f in range(emb.num_features):
            p = emb.pooling[f]
            ops.append(OpCost(
                name=f"emb_{f}", stage="sparse", level=0,
                flops=p * d,                      # pooling adds
                gather_bytes=p * d * db,          # random row reads
                host_bytes=p * 8.0,               # int64 ids
                stream_bytes=d * db,              # pooled output write
            ))
    if cfg.n_dense:
        ops.append(dataclasses.replace(
            _mlp_cost("bottom_mlp", "dense", 0, (cfg.n_dense, *cfg.bottom_mlp), db),
            host_bytes=cfg.n_dense * db))
    if cfg.interaction == "dot":
        n_vec = emb.num_features + (1 if cfg.n_dense else 0)
        ops.append(OpCost(
            name="interaction", stage="dense", level=1,
            flops=2.0 * n_vec * n_vec * d,
            stream_bytes=(n_vec * d + n_vec * n_vec) * db,
        ))
        top_in = n_vec * (n_vec - 1) // 2 + (d if cfg.n_dense else 0)
        ops.append(_mlp_cost("top_mlp", "dense", 2, (top_in, *cfg.top_mlp, 1), db))
    elif cfg.interaction == "concat":
        deep_in = emb.num_features * d + cfg.n_dense
        ops.append(_mlp_cost("deep_mlp", "dense", 1, (deep_in, *cfg.top_mlp), db))
        for t in range(cfg.n_tasks):
            ops.append(_mlp_cost(f"tower_{t}", "dense", 2, (cfg.top_mlp[-1], 1), db))
    elif cfg.interaction == "target-attn":
        T = cfg.seq_len
        # history embedding gather (the model's SparseNet)
        ops.append(OpCost(
            name="emb_hist", stage="sparse", level=0,
            flops=T * d, gather_bytes=(T + 1) * d * db, host_bytes=(T + 1) * 8.0,
            stream_bytes=T * d * db,
        ))
        attn_sizes = (4 * d, *cfg.attn_mlp, 1)
        attn = _mlp_cost("attn_unit", "dense", 1, attn_sizes, db)
        ops.append(dataclasses.replace(
            attn, flops=attn.flops * T, stream_bytes=attn.stream_bytes * T))
        if cfg.use_gru:  # DIEN: two GRU passes, sequential over T
            gru_flops = 2 * T * 6.0 * d * d * 2.0
            ops.append(OpCost(
                name="gru", stage="dense", level=1, flops=gru_flops,
                stream_bytes=2 * T * d * db, weight_bytes=12 * d * d * db,
                sequential=True,
            ))
        n_profile = cfg.embedding.num_features - 1
        ops.append(_mlp_cost(
            "top_mlp", "dense", 2, ((2 + n_profile) * d, *cfg.top_mlp, 1), db))
    elif cfg.interaction == "multi-interest":
        T, K = cfg.seq_len, cfg.n_interests
        ops.append(OpCost(
            name="emb_hist", stage="sparse", level=0,
            flops=T * d, gather_bytes=(T + 1) * d * db, host_bytes=(T + 1) * 8.0,
            stream_bytes=T * d * db,
        ))
        routing = cfg.capsule_iters * (2.0 * T * K * d * 2 + K * d)
        ops.append(OpCost(
            name="capsule_routing", stage="dense", level=1,
            flops=2.0 * T * d * d + routing,  # S-map + iterations
            stream_bytes=(T * d + T * K) * db, weight_bytes=d * d * db,
        ))
        head = _mlp_cost("head", "dense", 2, (d, 2 * d, d), db)
        ops.append(dataclasses.replace(
            head, flops=head.flops * K, stream_bytes=head.stream_bytes * K))

    table_gb = emb.bytes(4) / 1e9
    weight_gb = sum(o.weight_bytes for o in ops) / 1e9
    return ModelProfile(name=cfg.name, ops=tuple(ops), table_gb=table_gb,
                        weight_gb=weight_gb, sla_ms=sla_ms)
