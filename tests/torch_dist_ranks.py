"""Rank bodies of the distributed-layer tests (``tests/test_torch_dist_*``).

Each function runs in one rank process started by
``repro_torch.launch.mesh.spawn`` (gloo on the CPU), builds the mesh of its
test file, runs every case of that file in the one process group and
returns its results as numpy arrays, which the test process compares with
the reference.  Inputs arrive as numpy arrays or CPU tensors.  This module
imports neither jax nor the reference package: the ranks start faster
without them, and the tests that need the card reuse none of it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import numpy as np
import torch


def _np(t) -> np.ndarray:
    return t.detach().cpu().float().numpy() if torch.is_tensor(t) \
        else np.asarray(t)


def _mesh(shape=(2, 2), axes=("data", "model")):
    from repro_torch.launch.mesh import Mesh

    return Mesh(shape, axes, device_type="cpu")


# ---------------------------------------------------------------------------
# test_torch_dist_rules.py: the mesh, the binding, local_shard, build_cell
# ---------------------------------------------------------------------------


def rules_rank(rank: int, tree: dict) -> dict:
    import torch.distributed as dist

    from repro_torch.dist import collectives, logical
    from repro_torch.dist.sharding import P, local_shard
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.steps import build_cell

    mesh = mesh_lib.make_debug_mesh(2, 2, device_type="cpu")
    out = {"coords": dict(mesh.coords), "size": mesh.size,
           "data_axes": mesh_lib.data_axes(mesh),
           "all_axes": mesh_lib.all_axes(mesh),
           "group_sizes": {a: dist.get_world_size(mesh.group(a))
                           for a in (("data",), ("model",),
                                     ("data", "model"))}}
    # a sum over each group: which ranks a group holds
    sums = {}
    for axes in (("data",), ("model",), ("data", "model")):
        x = torch.tensor([float(rank)])
        sums[axes] = float(collectives.all_reduce(x, mesh.group(axes))[0])
    out["group_rank_sums"] = sums
    specs = {"a": P("model", None), "b": P(None, ("data", "model")),
             "c": P(("data", "model"), None), "d": P(None, None)}
    blocks = local_shard(tree, specs, mesh)
    out["blocks"] = {k: _np(v) for k, v in blocks.items()}
    out["shard_index"] = {
        "data_model": logical.shard_index(mesh, ("data", "model")),
        "model": logical.shard_index(mesh, "model")}
    # constrain: the binding's local shape, checked
    with logical.axis_rules(mesh, {"batch": "data", "model": "model"}):
        x = torch.zeros(4, 3)
        logical.constrain(x, ("batch", None), shape=(8, 3))
        try:
            logical.constrain(x, ("batch", None), shape=(4, 3))
            out["constrain_raises"] = False
        except ValueError:
            out["constrain_raises"] = True
        out["resolve"] = logical.resolve(("batch", "model", None, "vocab"))
        out["bound_model"] = logical.model_axis_name()
    out["unbound_model"] = logical.model_axis_name()
    # build_cell's wiring of the decode cells onto the mesh
    cells = {}
    for shape, batch in (("long_500k", 1), ("decode_32k", 128)):
        cell = build_cell("qwen2-7b", shape, "cpu", batch=batch, mesh=mesh)
        cells[shape] = {
            "decode_impl": cell.cfg.decode_impl,
            "kv_seq": cell.rules["kv_seq"], "batch": cell.rules["batch"],
            "model": cell.rules["model"],
            "cache_k": tuple(cell.batch_specs["cache"]["k"].shape),
            "token": tuple(cell.batch_specs["token"].shape)}
    out["cells"] = cells
    try:
        mesh_lib.make_production_mesh(device_type="cpu")
        out["production_mesh_raises"] = False
    except ValueError:
        out["production_mesh_raises"] = True
    out["collective_calls"] = dict(collectives.calls)
    return out


def lock_worker(path: str, log: str, n: int) -> None:
    """Hold ``_build.build_lock`` ``n`` times, writing a start and an end
    line into ``log`` inside each hold, with a pause between them."""
    from repro_torch.kernels import _build

    for _ in range(n):
        with _build.build_lock(path):
            with open(log, "a") as f:
                f.write(f"start {os.getpid()}\n")
                f.flush()
            time.sleep(0.02)
            with open(log, "a") as f:
                f.write(f"end {os.getpid()}\n")


# ---------------------------------------------------------------------------
# test_torch_dist_embedding.py
# ---------------------------------------------------------------------------


def embedding_rank(rank: int, cases: list, cell_case: dict) -> dict:
    """Every case: the whole table (numpy), the config's fields, the whole
    batch of ids; the rank pools its batch block through the row-sharded
    table and returns it with its coordinates."""
    from repro_torch.common.types import ArchKind
    from repro_torch.dist import collectives, logical
    from repro_torch.dist.sharded_embedding import sharded_row_gather
    from repro_torch.dist.sharding import P, local_shard, param_spec_tree
    from repro_torch.models.embedding import EmbeddingConfig, embedding_bag

    mesh = _mesh()
    rules = {"batch": "data", "model": "model"}
    out = {"coords": dict(mesh.coords), "cases": []}
    for case in cases:
        cfg = EmbeddingConfig(**case["cfg"])
        params = {"table": torch.from_numpy(case["table"])}
        local = local_shard(params, param_spec_tree(ArchKind.RECSYS, params),
                            mesh)
        ids = local_shard(torch.from_numpy(case["ids"]),
                          P("data", None, None), mesh)
        collectives.reset()
        with logical.axis_rules(mesh, rules):
            pooled = embedding_bag(local, ids, cfg)
        out["cases"].append({"pooled": _np(pooled),
                             "all_reduces": collectives.calls["all_reduce"],
                             "rows_held": local["table"].shape[0]})
    # sharded_row_gather on rows of every shard
    table = torch.from_numpy(cases[0]["table"])
    local = local_shard(table, P("model", None), mesh)
    rows = torch.arange(table.shape[0] - 1, -1, -7)
    with logical.axis_rules(mesh, rules):
        out["row_gather"] = _np(sharded_row_gather(local, rows))
    out["cell"] = _recsys_cell_rank(mesh, **cell_case)
    return out


def _recsys_cell_rank(mesh, arch_id: str, seed: int, batch: dict) -> dict:
    """The recsys serve cell on the mesh: this rank's state made from the
    seed (only its table rows), its block of the whole batch."""
    from repro_torch.launch.steps import build_cell

    cell = build_cell(arch_id, "serve_p99", "cpu", mesh=mesh)
    model = cell.init_state(torch.Generator().manual_seed(seed))
    local = cell.local_batch({k: torch.from_numpy(v) for k, v in
                              batch.items()})
    scores = cell.run(model, local)["scores"]
    return {"scores": _np(scores), "table_rows": model.table.shape[0],
            "table": _np(model.table)}


def multipod_rank(rank: int, emb_case: dict, ce_case: dict) -> dict:
    """The reference's multi-pod layout, ("pod", "data", "model") on 2 x 2
    x 2 ranks, batch over ("pod", "data"): the row-sharded embedding and
    the vocab-parallel loss."""
    from repro_torch.dist import logical
    from repro_torch.dist.loss import ce_loss
    from repro_torch.dist.sharding import P, local_shard
    from repro_torch.models.embedding import EmbeddingConfig, embedding_bag

    mesh = _mesh((2, 2, 2), ("pod", "data", "model"))
    rules = {"batch": ("pod", "data"), "model": "model", "vocab": "model"}
    cfg = EmbeddingConfig(**emb_case["cfg"])
    table = local_shard(torch.from_numpy(emb_case["table"]),
                        P("model", None), mesh)
    ids = local_shard(torch.from_numpy(emb_case["ids"]),
                      P(("pod", "data"), None, None), mesh)
    logits = local_shard(torch.from_numpy(ce_case["logits"]),
                         P(("pod", "data"), None, "model"), mesh)
    with logical.axis_rules(mesh, rules):
        pooled = embedding_bag({"table": table}, ids, cfg)
        loss = ce_loss(logits, local_shard(torch.from_numpy(
            ce_case["targets"]), P(("pod", "data"), None), mesh))
    return {"coords": dict(mesh.coords), "pooled": _np(pooled),
            "loss": float(loss)}


# ---------------------------------------------------------------------------
# test_torch_dist_decode.py
# ---------------------------------------------------------------------------


def decode_rank(rank: int, attn: dict, lm: dict) -> dict:
    from repro_torch.dist import collectives, logical
    from repro_torch.dist.decode import (
        decode_attention,
        flash_decode_sharded,
        flash_decode_sharded_int8,
    )
    from repro_torch.dist.sharding import P, local_shard

    mesh = _mesh()
    q, k, v = (torch.from_numpy(attn[n]) for n in ("q", "k", "v"))
    kq, ks, vq, vs = (torch.from_numpy(attn[n]) for n in ("kq", "ks", "vq",
                                                           "vs"))
    out = {"coords": dict(mesh.coords), "attn": {}, "int8": {}}
    layouts = {"long_500k": (("data", "model"), ()),
               "decode_32k": (("model",), ("data",))}
    for name, (seq_axes, batch_axes) in layouts.items():
        b_ax = batch_axes or None
        kv_spec = P(b_ax, seq_axes, None, None)
        q_l = local_shard(q, P(b_ax, None, None, None), mesh)
        k_l, v_l, kq_l, ks_l, vq_l, vs_l = (local_shard(t, kv_spec, mesh)
                                            for t in (k, v, kq, ks, vq, vs))
        for kv_len in attn["kv_lens"]:
            got = flash_decode_sharded(q_l, k_l, v_l, kv_len=kv_len,
                                       mesh=mesh, seq_axes=seq_axes)
            out["attn"][(name, kv_len)] = _np(got)
            got8 = flash_decode_sharded_int8(
                q_l, kq_l, ks_l, vq_l, vs_l, kv_len=kv_len, mesh=mesh,
                seq_axes=seq_axes)
            out["int8"][(name, kv_len)] = _np(got8)
    # the binding's entry picks the same path
    with logical.axis_rules(mesh, {"batch": "data", "kv_seq": "model"}):
        kv_spec = P("data", "model", None, None)
        got = decode_attention(local_shard(q, P("data", None, None, None),
                                           mesh),
                               local_shard(k, kv_spec, mesh),
                               local_shard(v, kv_spec, mesh), kv_len=700)
    out["bound"] = _np(got)
    out["gathers"] = collectives.calls["all_gather"]
    out["lm"] = {kv: _lm_step_rank(mesh, kv, **case)
                 for kv, case in lm.items()}
    return out


def _lm_step_rank(mesh, kv_quant: str, cfg: dict, params, cache: dict,
                  token, pos: int) -> dict:
    """One decode step of the LM with this rank's slice of the cache
    (sequence-sharded over ("data", "model"), the long_500k layout)."""
    from repro_torch.dist import logical
    from repro_torch.dist.sharding import kv_cache_spec, local_shard
    from repro_torch.models import transformer as tf_lib

    lm_cfg = dataclasses.replace(tf_lib.LMConfig(**cfg), decode_impl="flash")
    spec = kv_cache_spec(1)
    local = local_shard(cache, {k: spec for k in cache}, mesh)
    before = {k: v.clone() for k, v in local.items()}
    rules = {"batch": None, "kv_seq": ("data", "model")}
    with torch.inference_mode(), logical.axis_rules(mesh, rules):
        logits, new = tf_lib.decode_step(params, token, local, pos, lm_cfg)
    changed = sorted({int(r) for k in new
                      for r in torch.nonzero((new[k] != before[k]).reshape(
                          *new[k].shape[:3], -1).any(-1))[:, 2]})
    return {"logits": _np(logits), "cache": {k: _np(v) for k, v in
                                             new.items()},
            "changed_rows": changed, "s_local": local["k"].shape[2]}


# ---------------------------------------------------------------------------
# test_torch_dist_moe_loss_gnn.py
# ---------------------------------------------------------------------------


def moe_loss_gnn_rank(rank: int, moe: dict, ce: dict, gnn: dict) -> dict:
    from repro_torch.dist import logical
    from repro_torch.dist.gnn import (
        apply_batched_sharded,
        apply_full_sharded,
        edge_block,
        graph_block,
    )
    from repro_torch.dist.loss import ce_loss
    from repro_torch.dist.moe import expert_parallel_specs, moe_apply
    from repro_torch.dist.sharding import P, local_shard
    from repro_torch.models import gnn as gnn_lib
    from repro_torch.models.layers import MoEConfig

    mesh = _mesh()
    out = {"coords": dict(mesh.coords)}
    # MoE, expert parallel over "model", tokens over "data"
    cfg = MoEConfig(**moe["cfg"])
    params = local_shard(moe["params"], expert_parallel_specs(moe["params"]),
                         mesh)
    x = local_shard(torch.from_numpy(moe["x"]), P("data", None), mesh)
    with logical.axis_rules(mesh, {"batch": "data", "model": "model"}):
        y, aux = moe_apply(params, x, cfg)
    out["moe"] = _np(y)
    out["moe_experts_held"] = params["experts"]["w_gate"].shape[0]
    # vocab-parallel CE: logits [B, T, V] over ("data", None, "model")
    logits = local_shard(torch.from_numpy(ce["logits"]),
                         P("data", None, "model"), mesh).requires_grad_(True)
    targets = local_shard(torch.from_numpy(ce["targets"]), P("data", None),
                          mesh)
    with logical.axis_rules(mesh, {"batch": "data", "model": "model",
                                   "vocab": "model"}):
        loss = ce_loss(logits, targets)
        (g,) = torch.autograd.grad(loss, logits)
    out["ce"], out["ce_grad"] = float(loss.detach()), _np(g)
    # GNN: the full graph's edges over every axis, the packed graphs over
    # the data axis
    gnn_out = {}
    for agg, case in gnn["full"].items():
        gcfg = gnn_lib.GNNConfig(**case["cfg"])
        params = {k: v for k, v in case["params"].items()}
        leaves = [p for layer in params["layers"] for p in layer.values()] \
            + [params["cls"]]
        for p in leaves:
            p.requires_grad_(agg == "mean")
        edges = edge_block(torch.from_numpy(case["edges"]), mesh)
        loss = apply_full_sharded(
            params, torch.from_numpy(case["feats"]), edges,
            torch.from_numpy(case["labels"]),
            torch.from_numpy(case["mask"]), gcfg, mesh, case["n_nodes"])
        res = {"loss": float(loss.detach())}
        if agg == "mean":
            res["grads"] = [_np(t) for t in torch.autograd.grad(loss, leaves)]
        gnn_out[agg] = res
    b = gnn["batched"]
    gcfg = gnn_lib.GNNConfig(**b["cfg"])
    block = graph_block({k: torch.from_numpy(v) for k, v in
                         b["batch"].items()}, mesh, ("data",), b["n_graphs"],
                        b["n_nodes"], b["n_edges"])
    with torch.no_grad():
        logits, labels = apply_batched_sharded(
            b["params"], block, gcfg, mesh, ("data",), b["n_graphs"],
            b["n_nodes"], b["n_edges"])
    gnn_out["batched"] = {"logits": _np(logits), "labels": _np(labels)}
    out["gnn"] = gnn_out
    return out


# ---------------------------------------------------------------------------
# test_torch_dist_train*.py: the train and prefill cells on a mesh
# ---------------------------------------------------------------------------


def _local_tree(tree, kind, mesh):
    from repro_torch.dist.sharding import local_shard, param_spec_tree

    return local_shard(tree, param_spec_tree(kind, tree), mesh)


def _cell_state(cell, params):
    """This rank's train state of a cell from the whole parameter tree (CPU
    tensors): the LM's blocks, the recsys model over its table rows, the
    whole GNN.  The tree is copied first: the spawned ranks share its
    storage, and the step updates the leaves in place."""
    from repro_torch.common.tree import tree_map
    from repro_torch.common.types import ArchKind
    from repro_torch.models import RECSYS_MODELS
    from repro_torch.models import gnn as gnn_lib

    params = tree_map(torch.clone, params)

    if cell.is_lm:
        return cell.train_state(cell.local_params(params))
    if cell.kind == ArchKind.GNN:
        return cell.train_state(gnn_lib.GraphSAGE(cell.cfg, params))
    local = _local_tree(params, cell.kind, cell.mesh)
    lib = RECSYS_MODELS[cell.cfg.interaction]
    cls = type(lib.init(cell.cfg, generator=torch.Generator().manual_seed(0),
                        device=torch.device("cpu")))
    return cell.train_state(cls(cell.cfg, local))


def _tree_np(tree):
    from repro_torch.common.tree import tree_map

    return tree_map(_np, tree)


def train_step_case(mesh, multi_pod: bool, arch_id: str, shape: str,
                    params, batch: dict, batch_size=None, n_layers=None
                    ) -> dict:
    """One train step of ``build_cell(arch_id, shape, "cpu", mesh=...)``
    from the whole parameters and batch: the loss, this rank's gradient
    blocks, its parameters and optimizer state after the step, the spec
    trees and the collectives' calls."""
    from repro_torch.dist import collectives
    from repro_torch.dist.sharding import opt_spec_tree, param_spec_tree
    from repro_torch.launch.steps import build_cell

    cell = build_cell(arch_id, shape, "cpu", mesh=mesh, multi_pod=multi_pod,
                      batch=batch_size, n_layers=n_layers)
    state = _cell_state(cell, params)
    local = cell.local_batch({k: torch.as_tensor(v) for k, v in
                              batch.items()})
    p_specs = param_spec_tree(cell.kind, cell.params(state))
    collectives.reset()
    loss, grads = cell.value_and_grad(state, local)
    calls = dict(collectives.calls)
    state, out = cell.run(state, local)
    opt = {k: v for k, v in state["opt"].items()}
    return {"loss": float(loss), "step_loss": float(out["loss"]),
            "grads": _tree_np(grads), "params": _tree_np(cell.params(state)),
            "opt": _tree_np(opt), "p_specs": p_specs,
            "o_specs": opt_spec_tree(cell.kind, opt, p_specs, strict=True),
            "rules": dict(cell.rules), "grad_axes": cell.grad_axes,
            "calls": calls,
            "batch_shapes": {k: tuple(v.shape) for k, v in local.items()}}


def train_cells_rank(rank: int, cases: dict, shape=(2, 2),
                     axes=("data", "model")) -> dict:
    """Every case of ``train_step_case`` on one mesh."""
    mesh = _mesh(shape, axes)
    multi_pod = len(axes) == 3
    return {"coords": dict(mesh.coords),
            "cases": {name: train_step_case(mesh, multi_pod, **case)
                      for name, case in cases.items()}}


def prefill_case(mesh, arch_id: str, params, tokens) -> dict:
    """The prefill cell on the mesh: this rank's vocabulary slice of the
    last logits and its block of the cache."""
    from repro_torch.dist import collectives
    from repro_torch.launch.steps import build_cell

    cell = build_cell(arch_id, "prefill_32k", "cpu", mesh=mesh)
    local = cell.local_params(params)
    collectives.reset()
    out = cell.run(local, cell.local_batch({"tokens": torch.as_tensor(
        tokens)}))
    return {"logits": _np(out["logits"]),
            "cache": {k: _np(v) for k, v in out["cache"].items()},
            "calls": dict(collectives.calls)}


def moe_drop_case(mesh, moe: dict) -> dict:
    """``moe_apply`` with its tokens over "data" and its experts over
    "model" at a capacity that drops tokens: the output, the aux loss, and
    this rank's gradients of sum(y * r) / N + aux (its parameter blocks
    summed over "data") and of its token block."""
    from repro_torch.common.tree import tree_leaves, tree_unflatten
    from repro_torch.dist import collectives, logical
    from repro_torch.dist.moe import moe_apply
    from repro_torch.dist.sharding import P, Spec, local_shard
    from repro_torch.models.layers import MoEConfig

    cfg = MoEConfig(**moe["cfg"])
    specs = {"router": P(None, None),
             "experts": {k: Spec(("model", None, None))
                         for k in moe["params"]["experts"]},
             "shared": {"w_gate": P(None, "model"), "w_up": P(None, "model"),
                        "w_down": P("model", None)}}
    params = local_shard(moe["params"], specs, mesh)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    x = local_shard(torch.from_numpy(moe["x"]), P("data", None),
                    mesh).requires_grad_(True)
    r = local_shard(torch.from_numpy(moe["r"]), P("data", None), mesh)
    with torch.enable_grad(), logical.axis_rules(
            mesh, {"batch": "data", "model": "model"}):
        y, aux = moe_apply(params, x, cfg)
        loss = collectives.block_mean((y * r).sum(-1).mean(), "data") + aux
        grads = torch.autograd.grad(loss, tree_leaves(params) + [x])
    pgrads = collectives.reduce_grads(list(grads[:-1]), tree_leaves(specs),
                                      mesh, ("data",))
    return {"y": _np(y), "aux": float(aux), "loss": float(loss),
            "grads": _tree_np(tree_unflatten(params, pgrads)),
            "x_grad": _np(grads[-1])}


def lm_prefill_moe_rank(rank: int, prefill: dict, moe: dict) -> dict:
    from repro_torch.launch.steps import build_cell

    mesh = _mesh()
    # a decode cell's state on the mesh: this rank's weight blocks
    decode = build_cell(prefill["arch_id"], "decode_32k", "cpu", mesh=mesh,
                        batch=16).init_state(torch.Generator().manual_seed(0))
    return {"coords": dict(mesh.coords),
            "prefill": prefill_case(mesh, **prefill),
            "moe": moe_drop_case(mesh, moe),
            "decode_shapes": {k: tuple(v.shape) for k, v in
                              decode["blocks"]["attn"].items()}}


def qr_grad_case(mesh, qr: dict) -> dict:
    """``embedding_bag`` of a config with a QR feature through the
    row-sharded table (rows over "model", bags over "data") under autograd:
    the pooled block and this rank's table-row gradient of mean_b sum(pooled
    * r), summed over "data"."""
    from repro_torch.dist import collectives, logical
    from repro_torch.dist.sharding import P, local_shard
    from repro_torch.models.embedding import EmbeddingConfig, embedding_bag

    cfg = EmbeddingConfig(**qr["cfg"])
    table = local_shard(torch.from_numpy(qr["table"]), P("model", None),
                        mesh).requires_grad_(True)
    ids = local_shard(torch.from_numpy(qr["ids"]), P("data", None, None),
                      mesh)
    r = local_shard(torch.from_numpy(qr["r"]), P("data", None, None), mesh)
    with torch.enable_grad(), logical.axis_rules(
            mesh, {"batch": "data", "model": "model"}):
        pooled = embedding_bag({"table": table}, ids, cfg)
        loss = collectives.block_mean((pooled * r).sum((1, 2)).mean(), "data")
        g, = torch.autograd.grad(loss, table)
    g = collectives.reduce_grads([g], [P("model", None)], mesh, ("data",))[0]
    return {"pooled": _np(pooled), "grad": _np(g), "loss": float(loss)}


def recsys_gnn_rank(rank: int, cases: dict, qr: dict) -> dict:
    mesh = _mesh()
    return {"coords": dict(mesh.coords),
            "cases": {name: train_step_case(mesh, False, **case)
                      for name, case in cases.items()},
            "qr": qr_grad_case(mesh, qr)}


# ---------------------------------------------------------------------------
# test_torch_dist_uneven.py: the uneven head split
# ---------------------------------------------------------------------------


def uneven_case(mesh, arch_id: str, overrides: dict, params, tokens) -> dict:
    """One train step and one prefill of ``arch_id``'s SMOKE config with
    ``overrides`` (its heads) on the mesh, from the whole parameters and
    tokens: this rank's gradient blocks, parameters and optimizer state
    after the step, prefill logits and cache, and where its heads lie; or
    the message of the error ``build_cell`` raised."""
    from repro_torch.common.tree import tree_map
    from repro_torch.configs.registry import get_arch
    from repro_torch.dist import logical
    from repro_torch.launch.steps import build_cell

    cfg = dataclasses.replace(get_arch(arch_id).SMOKE, **overrides)
    try:
        cell = build_cell(arch_id, "train_4k", "cpu", mesh=mesh,
                          cfg_override=cfg)
    except ValueError as e:
        return {"error": str(e)}
    state = _cell_state(cell, params)
    local = cell.local_batch({"tokens": torch.as_tensor(tokens)})
    loss, grads = cell.value_and_grad(state, local)
    state, _ = cell.run(state, local)
    pre = build_cell(arch_id, "prefill_32k", "cpu", mesh=mesh,
                     cfg_override=cfg)
    out = pre.run(pre.local_params(tree_map(torch.clone, params)),
                  pre.local_batch({"tokens": torch.as_tensor(tokens)}))
    i = logical.shard_index(mesh, cell.rules["heads"])
    return {"loss": float(loss), "grads": _tree_np(grads),
            "params": _tree_np(cell.params(state)),
            "opt": _tree_np({k: state["opt"][k] for k in ("m", "v")}),
            "logits": _np(out["logits"]),
            "cache": {k: _np(v) for k, v in out["cache"].items()},
            "q_heads": cell.heads.q_heads(i),
            "kv_heads": cell.heads.kv_heads(i), "share": cell.heads.share}


def uneven_rank(rank: int, cases: dict, shape, axes=("data", "model")
                ) -> dict:
    """Every ``uneven_case`` on one mesh."""
    mesh = _mesh(tuple(shape), axes)
    return {"coords": dict(mesh.coords),
            "cases": {name: uneven_case(mesh, **case)
                      for name, case in cases.items()}}


# ---------------------------------------------------------------------------
# test_torch_dist_tp_decode.py: the tensor-parallel decode cells
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _recorded_decode(attn: list, partial_heads: list):
    """Record each layer's attention output of this rank's heads and the q
    heads each K3 partials call takes."""
    from repro_torch.dist import decode as dd
    from repro_torch.models import transformer as tf_lib

    own = tf_lib.own_heads
    saved_p = {name: getattr(dd, name) for name in (
        "flash_decode_partials", "flash_decode_int8_partials")}

    def recorded(*args):
        out = own(*args)
        attn.append(_np(out))
        return out

    def counting(fn):
        def wrapped(q, *args, **kw):
            partial_heads.append(q.shape[2])
            return fn(q, *args, **kw)
        return wrapped

    tf_lib.own_heads = recorded
    for name, fn in saved_p.items():
        setattr(dd, name, counting(fn))
    try:
        yield
    finally:
        tf_lib.own_heads = own
        for name, fn in saved_p.items():
            setattr(dd, name, fn)


def tp_decode_case(mesh, arch_id: str, overrides: dict, params, steps: dict
                   ) -> dict:
    """Every decode step of ``steps`` ((layout, kv_quant) -> its batch:
    token, whole cache, positions) on the mesh: the cell of ``arch_id``'s
    SMOKE config with ``overrides`` (its heads), this rank's block of the
    parameters, its slice of the cache; at ``S - 1`` through the cell's
    step, inside the cache through ``decode_step`` under the cell's
    binding.  Each step's logits, its cache slice before and after, its
    attention outputs, the q heads each K3 partials call took and the
    collectives' calls; or the message of the error ``build_cell``
    raised."""
    from repro_torch.common.tree import tree_map
    from repro_torch.configs.registry import get_arch
    from repro_torch.dist import collectives, logical
    from repro_torch.dist.decode import kv_shard
    from repro_torch.launch.steps import build_cell, run_cell
    from repro_torch.models import transformer as tf_lib

    out = {}
    for (layout, kv_quant), step in steps.items():
        cfg = dataclasses.replace(get_arch(arch_id).SMOKE,
                                  kv_quant=kv_quant, **overrides)
        try:
            cell = build_cell(arch_id, layout, "cpu", mesh=mesh,
                              batch=step["token"].shape[0],
                              cfg_override=cfg)
        except ValueError as e:
            return {"error": str(e)}
        local = cell.local_params(tree_map(torch.clone, params))
        i = logical.shard_index(mesh, cell.rules["heads"])
        for pos in step["positions"]:
            batch = cell.local_batch({
                "token": torch.as_tensor(step["token"]),
                "cache": {k: torch.from_numpy(v).clone()
                          for k, v in step["cache"].items()}})
            before = {k: _np(v) for k, v in batch["cache"].items()}
            attn, heads = [], []
            collectives.reset()
            with _recorded_decode(attn, heads):
                if pos == cell.seq_len - 1:
                    res = cell.run(local, batch)
                else:
                    with torch.inference_mode():
                        res = run_cell(cell, lambda: dict(zip(
                            ("logits", "cache"), tf_lib.decode_step(
                                local, batch["token"], batch["cache"], pos,
                                cell.cfg))))
            off = run_cell(cell, lambda: kv_shard(
                batch["cache"]["k"].shape[2]))[0]
            out[(layout, kv_quant, pos)] = {
                "logits": _np(res["logits"]), "before": before,
                "after": {k: _np(v) for k, v in res["cache"].items()},
                "attn": attn, "partial_heads": heads, "offset": off,
                "calls": dict(collectives.calls),
                "q_heads": cell.heads.q_heads(i),
                "rules": dict(cell.rules)}
    return {"steps": out}


def tp_decode_rank(rank: int, cases: dict, shape, axes=("data", "model")
                   ) -> dict:
    """Every ``tp_decode_case`` on one mesh."""
    mesh = _mesh(tuple(shape), axes)
    return {"coords": dict(mesh.coords),
            "cases": {name: tp_decode_case(mesh, **case)
                      for name, case in cases.items()}}


# ---------------------------------------------------------------------------
# test_torch_dryrun.py: the collectives of one step on real ranks
# ---------------------------------------------------------------------------


def collectives_rank(rank: int, cells: list) -> dict:
    """One step of each (arch, shape, config) cell on a (2, 2) mesh, from
    ``dryrun``'s state and batch (a seeded draw, zeros): the collectives'
    calls and per-rank bytes."""
    from repro_torch.dist import collectives
    from repro_torch.launch.dryrun import _batch
    from repro_torch.launch.steps import build_cell

    mesh = _mesh()
    out = {}
    for arch_id, shape, cfg in cells:
        cell = build_cell(arch_id, shape, "cpu", mesh=mesh, cfg_override=cfg)
        state = cell.init_state(torch.Generator().manual_seed(0))
        batch = _batch(cell)
        collectives.reset()
        cell.run(state, batch)
        out[f"{arch_id}|{shape}"] = {"calls": dict(collectives.calls),
                                     "nbytes": dict(collectives.nbytes)}
    return out


# ---------------------------------------------------------------------------
# test_torch_dist_seq_shard.py: the sequence-parallel residual stream
# ---------------------------------------------------------------------------


def seq_collectives_case(mesh, arrays: dict) -> dict:
    """``reduce_scatter`` and ``gather`` under autograd over the "model"
    group (2 ranks) and the whole world (4), along each dimension: this
    rank's outputs, its input gradients of sum(out * c) (``c`` this rank's
    cotangent) and the counts each forward and backward took."""
    import torch.distributed as dist

    from repro_torch.dist import collectives

    out = {}
    for axes in (("model",), ("data", "model")):
        group = mesh.group(axes)
        members = dist.get_process_group_ranks(group)
        for dim in range(3):
            for op in ("reduce_scatter", "gather"):
                x = torch.from_numpy(arrays[f"{op}_x"][dist.get_rank()]
                                     ).clone().requires_grad_(True)
                if op == "gather":
                    x = x.narrow(dim, 0, x.shape[dim] // len(members)
                                 ).detach().requires_grad_(True)
                collectives.reset()
                y = getattr(collectives, op)(x, group, dim)
                fwd = dict(collectives.calls), dict(collectives.nbytes)
                c = torch.from_numpy(arrays[f"{op}_c"][dist.get_rank()])
                if op == "reduce_scatter":
                    c = c.narrow(dim, dist.get_group_rank(
                        group, dist.get_rank()) * y.shape[dim], y.shape[dim])
                g, = torch.autograd.grad((y * c).sum(), x)
                out[(len(members), dim, op)] = {
                    "members": members, "y": _np(y), "grad": _np(g),
                    "fwd_calls": fwd[0], "fwd_bytes": fwd[1],
                    "calls": dict(collectives.calls),
                    "nbytes": dict(collectives.nbytes)}
    return out


def seq_train_case(mesh, arch_id: str, overrides: dict, params, tokens
                   ) -> dict:
    """One train step of ``arch_id``'s SMOKE config with ``overrides`` on
    the mesh, with seq_shard and without: the loss, this rank's gradient
    blocks (and, with seq_shard, those of a cell whose gradient axes leave
    "model" out: the planted fault of the norms' sum left out), its
    parameters before the step and its moments after, the rules, the
    gradient axes and the collectives of the gradient pass."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.dist import collectives
    from repro_torch.launch.steps import build_cell

    out = {}
    for seq in (False, True):
        cfg = dataclasses.replace(get_arch(arch_id).SMOKE, seq_shard=seq,
                                  **overrides)
        cell = build_cell(arch_id, "train_4k", "cpu", mesh=mesh,
                          cfg_override=cfg)
        state = _cell_state(cell, params)
        local = cell.local_batch({"tokens": torch.as_tensor(tokens)})
        before = _tree_np(cell.params(state))
        collectives.reset()
        loss, grads = cell.value_and_grad(state, local)
        res = {"loss": float(loss), "grads": _tree_np(grads),
               "calls": dict(collectives.calls),
               "nbytes": dict(collectives.nbytes),
               "rules": dict(cell.rules), "grad_axes": cell.grad_axes,
               "params": before}
        if seq:
            fault = dataclasses.replace(cell, grad_axes=tuple(
                a for a in cell.grad_axes if a != "model"))
            res["fault_grads"] = _tree_np(fault.value_and_grad(state,
                                                               local)[1])
        state, step = cell.run(state, local)
        res["step_loss"] = float(step["loss"])
        res["opt"] = _tree_np({k: state["opt"][k] for k in ("m", "v")})
        out[seq] = res
    return out


def seq_infer_case(mesh, arch_id: str, params, tokens) -> dict:
    """prefill_32k and a decode_32k step (B 4 on the CPU: batch
    replicated, the cache over "model") with seq_shard and without: this
    rank's logits slice and cache block, and the collectives' calls."""
    from repro_torch.common.tree import tree_map
    from repro_torch.configs.registry import get_arch
    from repro_torch.dist import collectives
    from repro_torch.launch.steps import build_cell

    out = {}
    for seq in (False, True):
        cfg = dataclasses.replace(get_arch(arch_id).SMOKE, seq_shard=seq)
        pre = build_cell(arch_id, "prefill_32k", "cpu", mesh=mesh,
                         cfg_override=cfg)
        collectives.reset()
        p = pre.run(pre.local_params(tree_map(torch.clone, params)),
                    pre.local_batch({"tokens": torch.as_tensor(tokens)}))
        p_calls = dict(collectives.calls)
        dec = build_cell(arch_id, "decode_32k", "cpu", mesh=mesh,
                         cfg_override=cfg)
        batch = dec.local_batch({
            "token": torch.as_tensor(tokens[:, -1:]),
            "cache": {k: v.detach().clone() for k, v in
                      _whole_cache(p["cache"], mesh).items()}})
        collectives.reset()
        d = dec.run(dec.local_params(tree_map(torch.clone, params)), batch)
        out[seq] = {"prefill_logits": _np(p["logits"]),
                    "prefill_cache": {k: _np(v) for k, v in
                                      p["cache"].items()},
                    "prefill_calls": p_calls,
                    "decode_logits": _np(d["logits"]),
                    "decode_cache": {k: _np(v) for k, v in
                                     d["cache"].items()},
                    "decode_calls": dict(collectives.calls),
                    "rules": (dict(pre.rules), dict(dec.rules))}
    return out


def _whole_cache(cache: dict, mesh) -> dict:
    """The whole prefill cache from every rank's block (its batch rows
    over "data", its kv heads over "model"), on every rank."""
    from repro_torch.dist import collectives

    out = {}
    for k, v in cache.items():
        heads = collectives.all_gather(v, mesh.group("model"))  # [W, ...]
        v = torch.cat(list(heads), dim=3)
        rows = collectives.all_gather(v, mesh.group("data"))
        out[k] = torch.cat(list(rows), dim=1)
    return out


def seq_unsplit_case(mesh, arch_id: str, params, tokens) -> dict:
    """The loss, the raw gradients (no sum over ranks) and the logits of
    tokens whose length does not split over the "model" ranks, under a
    seq_shard cell's binding and under the same cell's without seq_shard,
    and the collectives each took."""
    from repro_torch.common.tree import tree_leaves, tree_map
    from repro_torch.configs.registry import get_arch
    from repro_torch.dist import collectives
    from repro_torch.launch.steps import build_cell, run_cell
    from repro_torch.models import transformer as tf_lib

    out = {}
    for seq in (False, True):
        cfg = dataclasses.replace(get_arch(arch_id).SMOKE, seq_shard=seq)
        cell = build_cell(arch_id, "train_4k", "cpu", mesh=mesh,
                          cfg_override=cfg)
        local = cell.params(cell.train_state(cell.local_params(
            tree_map(torch.clone, params))))
        toks = cell.local_batch({"tokens": torch.as_tensor(tokens)})
        collectives.reset()

        def step():
            loss = tf_lib.lm_loss(local, toks, cell.cfg)
            return (loss, torch.autograd.grad(loss, tree_leaves(local)),
                    tf_lib.sequence_split(toks["tokens"].shape[1]),
                    tf_lib.sequence_split(cell.seq_len))

        with torch.enable_grad():
            loss, grads, split, split_cell = run_cell(cell, step)
        out[seq] = {"loss": float(loss), "grads": [_np(g) for g in grads],
                    "calls": dict(collectives.calls), "split": split,
                    "split_cell": split_cell}
    return out


def seq_shard_rank(rank: int, coll: dict, train: dict, infer: dict,
                   unsplit: dict, uneven: dict) -> dict:
    """Every case of test_torch_dist_seq_shard.py: on (data 2, model 2)
    the collectives, the train cases, prefill and decode and the length
    that does not split; on (data 1, model 4) the uneven head split."""
    mesh = _mesh()
    out = {"coords": dict(mesh.coords),
           "coll": seq_collectives_case(mesh, coll),
           "train": {name: seq_train_case(mesh, **case)
                     for name, case in train.items()},
           "infer": seq_infer_case(mesh, **infer),
           "unsplit": seq_unsplit_case(mesh, **unsplit)}
    wide = _mesh((1, 4))
    out["wide_coords"] = dict(wide.coords)
    out["uneven"] = {name: seq_train_case(wide, **case)
                     for name, case in uneven.items()}
    return out
