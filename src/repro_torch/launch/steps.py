"""Per-(architecture x shape) programs: the LM train, prefill and decode
cells, the recsys serve and train cells, and the GNN train cells.

Counterpart of ``repro.launch.steps`` (``build_cell`` / ``CellProgram``) on
one device.  The reference's mesh becomes an explicit device:

- ``device="cpu"`` mirrors the reference's ``mesh=None`` smoke cell: the
  arch's ``SMOKE`` config, for an LM at batch 4 and sequence 32, for a
  recsys arch at batch 16 and 128 candidates; every GNN shape takes the
  GNN's ``SMOKE`` config (mode ``mini``, 8 seeds) as the reference does,
  sampled from a synthetic graph of ``SMOKE_GRAPH`` (nodes, edges a node);
- ``device="cuda"`` (the default) runs the ``FULL`` config (a GNN shape's
  ``SHAPE_CONFIGS`` entry) at the shape's sizes and, for LM decode, with
  ``decode_impl="flash"`` (kernel K3), as the reference's device-placed
  cells do.  The batch is the shape's unless the caller states a cut with
  ``batch=``, and an LM's depth its config's unless the caller states one
  with ``n_layers=``; nothing shrinks either silently.  A full-graph GNN
  cell draws a synthetic graph of the shape's nodes at ``round(E / N)``
  edges a node (``dims``; ogb_products: 25, so 61,225,725 edges of the
  shape's 61,859,140).

LM decode is one token at ``pos = S - 1`` against an S-long cache passed
in the batch; prefill fills a fresh cache from position 0.  A recsys serve
cell scores its batch (``serve_p99``, ``serve_bulk``); ``retrieval_cand``
scores one user's history against every candidate for DIN and MIND, and
scores the candidates as one bulk batch for the CTR rankers (Wide & Deep,
DLRM).

A train cell (LM ``train_4k``: ``adamw(lr=3e-4)`` on ``lm_loss``; recsys
``train_batch``: ``rowwise_adagrad(lr=0.01)`` on ``binary_ce``; every GNN
shape: ``adamw(lr=1e-3)`` on ``softmax_ce``) has the state ``{"model",
"opt"}`` (the model module and its optimizer state over the model's
``tree()``) or, for an LM, the reference's ``{"params", "opt"}`` (the
parameter tree, each leaf requiring grad).  ``run`` takes one step with
grad enabled (the recsys tables' gradient through K1's backward on a
card), updates the state in place and returns ``(state, {"loss"})``, the
loss before the update, as the reference's step does.  ``value_and_grad``
gives the loss and the gradient tree without the update.

``mesh`` (a ``repro_torch.launch.mesh.Mesh`` over the ranks that run the
cell; ``device`` is then each rank's device) places a decode or a recsys
serve cell on the distributed layer, as the reference's mesh cells:

- a decode cell (``decode_32k``, ``long_500k``) binds ``kv_seq`` to
  ``kv_seq_axes(B)`` and, below batch 16, "batch" to None; its batch specs
  hold only this rank's cache slice (``kv_cache_spec``) and token block.
  The LM's weights stay replicated in this slice: its tensor-parallel
  names ("model", "heads", "kv_heads", "ffn", "vocab", "expert") are bound
  to None, and column- and row-parallel execution of those placements
  comes with the sharded train cells;
- a recsys serve cell binds "model" (and "batch" over the data axes); its
  state holds only this rank's rows of each embedding table
  (``row_shard``), its batch specs this rank's batch block.

``batch_spec_tree`` gives each batch leaf's ``Spec``; ``local_batch``
cuts a whole batch to this rank's block, and ``run`` enters the cell's
binding (``logical.axis_rules``).  Train, prefill and GNN cells take no
mesh yet.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import torch

from repro_torch.common.tree import tree_leaves, tree_unflatten
from repro_torch.common.types import ArchKind, ShapeSpec, TensorSpec, resolve_device
from repro_torch.configs.registry import get_arch
from repro_torch.dist import logical
from repro_torch.dist.sharding import (
    P,
    kv_cache_spec,
    kv_seq_axes,
    local_shard,
    logical_rules,
)
from repro_torch.models import RECSYS_MODELS
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.models.recsys_base import binary_ce
from repro_torch.models.recsys_base import input_specs as recsys_input_specs
from repro_torch.train import optimizer as opt_lib

SMOKE_BATCH, SMOKE_SEQ = 4, 32  # the reference's mesh=None cut
SMOKE_RECSYS_BATCH, SMOKE_CANDIDATES = 16, 128  # its recsys cut
RECSYS_LR = 0.01  # the reference's recsys train_batch rowwise AdaGrad
# the reference's mesh=None GNN cut: 8 seeds (mini), or 64 nodes and 256
# edges (full), or 8 graphs of 6 nodes and 10 edges (batched)
SMOKE_GNN_BATCH, SMOKE_GNN_FULL, SMOKE_GNN_GRAPHS = 8, (64, 4), (8, 6, 10)
SMOKE_GRAPH = (256, 8)  # the graph a CPU minibatch cell samples from


@dataclasses.dataclass
class CellProgram:
    arch_id: str
    shape: ShapeSpec
    kind: ArchKind
    cfg: Any               # LMConfig, RecsysConfig or GNNConfig
    device: torch.device
    batch: int
    seq_len: int
    step_fn: Callable | None  # step(state, batch) -> outputs (None: train)
    batch_specs: dict      # TensorSpec tree of the step's batch
    init_fn: Callable      # init(cfg, *, generator, device) -> model
    opt: opt_lib.Optimizer | None = None  # train cells
    loss_fn: Callable | None = None       # train: loss(model, batch)
    dims: dict | None = None  # GNN cells: sizes for data.graph.cell_batch
    mesh: Any = None          # the ranks' Mesh, or None on one device
    rules: dict | None = None             # the logical binding of a mesh
    batch_spec_tree: dict | None = None   # Spec of each batch leaf

    def init_state(self, generator: torch.Generator):
        """Random parameters on the cell's device (``generator`` lives
        there): the LM's parameter tree, the recsys or GNN model, or for a
        train cell ``{"model", "opt"}`` (an LM's ``{"params", "opt"}``)."""
        if self.mesh is not None and self.kind == ArchKind.RECSYS:
            model_axis = self.rules["model"]
            row_shard = (logical.shard_index(self.mesh, model_axis),
                         logical.shards(model_axis, self.mesh))
            return self.init_fn(self.cfg, generator=generator,
                                device=self.device, row_shard=row_shard)
        model = self.init_fn(self.cfg, generator=generator, device=self.device)
        if self.opt is None:
            return model
        if self.kind in (ArchKind.LM_DENSE, ArchKind.LM_MOE):
            for t in tree_leaves(model):
                t.requires_grad_(True)
            return {"params": model, "opt": self.opt.init(model)}
        return {"model": model, "opt": self.opt.init(model.tree())}

    @staticmethod
    def params(state):
        """A train state's parameter tree: the LM's, or the model's
        ``tree()`` (the same tensors)."""
        return state["params"] if "params" in state else state["model"].tree()

    def value_and_grad(self, state, batch):
        """A train cell's loss on ``batch`` and the gradient of every
        parameter, as the tree of ``params`` (no update)."""
        params = self.params(state)
        with torch.enable_grad():
            loss = self.loss_fn(state.get("model", params), batch)
            grads = torch.autograd.grad(loss, tree_leaves(params),
                                        materialize_grads=True)
        return loss.detach(), tree_unflatten(params, grads)

    def train_step(self, state, batch):
        """Loss and gradients, then the optimizer's in-place update of the
        parameters -> ``(state, {"loss"})``."""
        loss, grads = self.value_and_grad(state, batch)
        self.opt.update(self.params(state), grads, state["opt"])
        return state, {"loss": loss}

    def local_batch(self, batch):
        """This rank's block of a whole batch (the batch itself without a
        mesh)."""
        if self.mesh is None:
            return batch
        return local_shard(batch, self.batch_spec_tree, self.mesh)

    def run(self, state, batch):
        if self.opt is not None:
            return self.train_step(state, batch)
        binding = contextlib.nullcontext() if self.mesh is None else \
            logical.axis_rules(self.mesh, self.rules)
        with torch.inference_mode(), binding:
            return self.step_fn(state, batch)


# the LM's tensor-parallel logical names, unbound while its weights stay
# replicated (see the module docstring)
_LM_TP_NAMES = ("model", "heads", "kv_heads", "ffn", "vocab", "expert")


def _dp_axes(multi_pod: bool) -> tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def _lm_cell(arch, shape: ShapeSpec, device: torch.device,
             batch: int | None, n_layers: int | None, mesh,
             multi_pod: bool) -> CellProgram:
    on_card = device.type == "cuda"
    cfg = arch.FULL if on_card else arch.SMOKE
    B = shape["global_batch"] if on_card else SMOKE_BATCH
    S = shape["seq_len"] if on_card else SMOKE_SEQ
    if batch is not None:
        B = batch
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    step = opt = loss_fn = None

    if shape.step == "train":
        batch_specs = tf_lib.input_specs(cfg, B, S)
        opt = opt_lib.adamw(lr=3e-4)

        def loss_fn(params, batch):
            return tf_lib.lm_loss(params, batch, cfg)

    elif shape.step == "prefill":
        batch_specs = tf_lib.input_specs(cfg, B, S)

        def step(params, batch):
            cache = tf_lib.init_kv_cache(cfg, B, S, device=device)
            last, new_cache = tf_lib.prefill(params, batch["tokens"], cache, cfg)
            return {"logits": last, "cache": new_cache}

    else:  # decode (decode_32k / long_500k): one token against an S cache
        if on_card or mesh is not None:
            cfg = dataclasses.replace(cfg, decode_impl="flash")
        batch_specs = {"token": TensorSpec((B, 1), torch.int32),
                       "cache": tf_lib.kv_cache_specs(cfg, B, S)}
        pos = S - 1

        def step(params, batch):
            logits, new_cache = tf_lib.decode_step(
                params, batch["token"], batch["cache"], pos, cfg)
            return {"logits": logits, "cache": new_cache}

    rules = spec_tree = None
    if mesh is not None:
        if shape.step != "decode":
            raise NotImplementedError(f"{shape.name}: only the decode cells "
                                      "of an LM take a mesh yet")
        rules = logical_rules(arch.KIND, multi_pod)
        rules.update({name: None for name in _LM_TP_NAMES})
        rules["kv_seq"] = kv_seq_axes(B, multi_pod)
        if B < 16:
            rules["batch"] = None  # batch 1: token replicated, KV seq-sharded
        spec = kv_cache_spec(B, multi_pod)
        spec_tree = {"token": P(_dp_axes(multi_pod), None) if B >= 16
                     else P(None, None),
                     "cache": {k: spec for k in batch_specs["cache"]}}
        batch_specs = local_shard(batch_specs, spec_tree, mesh)
    return CellProgram(arch_id=arch.ARCH_ID, shape=shape, kind=arch.KIND,
                       cfg=cfg, device=device, batch=B, seq_len=S,
                       step_fn=step, batch_specs=batch_specs,
                       init_fn=tf_lib.init, opt=opt, loss_fn=loss_fn,
                       mesh=mesh, rules=rules, batch_spec_tree=spec_tree)


def recsys_train_cell(cfg, batch: int, device: torch.device, *, lr: float,
                      arch_id: str, shape: ShapeSpec) -> CellProgram:
    """A recsys model's train step as a cell: ``rowwise_adagrad(lr)`` on
    ``binary_ce``, state ``{"model", "opt"}``."""
    specs = recsys_input_specs(cfg, batch, with_labels=True)
    return CellProgram(
        arch_id=arch_id, shape=shape, kind=ArchKind.RECSYS, cfg=cfg,
        device=device, batch=batch, seq_len=cfg.seq_len, step_fn=None,
        batch_specs={k: TensorSpec(*v) for k, v in specs.items()},
        init_fn=RECSYS_MODELS[cfg.interaction].init,
        opt=opt_lib.rowwise_adagrad(lr=lr),
        loss_fn=lambda model, b: binary_ce(model(b), b["label"]))


def _recsys_cell(arch, shape: ShapeSpec, device: torch.device,
                 batch: int | None, mesh, multi_pod: bool) -> CellProgram:
    on_card = device.type == "cuda"
    cfg = arch.FULL if on_card else arch.SMOKE
    B = shape["batch"] if on_card else SMOKE_RECSYS_BATCH
    if mesh is not None and shape.step == "train":
        raise NotImplementedError("a recsys train cell takes no mesh yet: "
                                  "its gradients through the row-sharded "
                                  "table come with the sharded train cells")
    if shape.step == "train":
        return recsys_train_cell(cfg, B if batch is None else batch, device,
                                 lr=RECSYS_LR, arch_id=arch.ARCH_ID,
                                 shape=shape)
    n_cand = shape.get("n_candidates", 0)
    if n_cand and not on_card:
        n_cand = SMOKE_CANDIDATES
    if batch is not None:
        if n_cand:
            raise ValueError("retrieval_cand scores one query; it takes no "
                             "batch")
        B = batch

    if n_cand and cfg.interaction in ("target-attn", "multi-interest"):
        B = shape["batch"]  # always 1: the retrieval query
        specs = recsys_input_specs(cfg, B, n_candidates=n_cand)

        def step(model, batch):
            return {"scores": model.retrieval_scores(batch,
                                                     batch["candidate_ids"])}
    else:
        if n_cand:  # CTR rankers score the candidates as one bulk batch
            B = n_cand
        specs = recsys_input_specs(cfg, B)

        def step(model, batch):
            return {"scores": model(batch)}

    batch_specs = {k: TensorSpec(*v) for k, v in specs.items()}
    rules = spec_tree = None
    if mesh is not None:
        rules = logical_rules(arch.KIND, multi_pod)
        dp = _dp_axes(multi_pod)
        # the reference's recsys batch layout: a leading dimension over one
        # shards over the data axes
        spec_tree = {k: P(dp if len(v.shape) and v.shape[0] > 1 else None,
                          *[None] * (len(v.shape) - 1))
                     for k, v in batch_specs.items()}
        batch_specs = local_shard(batch_specs, spec_tree, mesh)
    return CellProgram(
        arch_id=arch.ARCH_ID, shape=shape, kind=arch.KIND, cfg=cfg,
        device=device, batch=B, seq_len=cfg.seq_len, step_fn=step,
        batch_specs=batch_specs,
        init_fn=RECSYS_MODELS[cfg.interaction].init, mesh=mesh,
        rules=rules, batch_spec_tree=spec_tree)


def _gnn_cell(arch, shape: ShapeSpec, device: torch.device,
              batch: int | None) -> CellProgram:
    on_card = device.type == "cuda"
    cfg = arch.SHAPE_CONFIGS[shape.name] if on_card else arch.SMOKE
    # the shape's nodes at its edges a node, rounded
    graph = (shape["n_nodes"], round(shape["n_edges"] / shape["n_nodes"]))
    if cfg.mode == "full":
        N, deg = graph if on_card else SMOKE_GNN_FULL
        if batch is not None:
            raise ValueError("a full-graph cell trains on the whole graph; "
                             "it takes no batch")
        dims = {"graph_nodes": N, "graph_degree": deg, "n_nodes": N,
                "n_edges": N * deg}
        B = N
    elif cfg.mode == "mini":
        B = shape.get("batch_nodes", 1024) if on_card else SMOKE_GNN_BATCH
        if batch is not None:
            B = batch
        n, deg = graph if on_card else SMOKE_GRAPH
        dims = {"batch_nodes": B, "fanout": tuple(shape.get("fanout",
                                                            cfg.fanout)),
                "graph_nodes": n, "graph_degree": deg}
    else:  # batched small graphs (molecule)
        B, n, e = ((shape.get("batch", 128), shape["n_nodes"],
                    shape["n_edges"]) if on_card else SMOKE_GNN_GRAPHS)
        if batch is not None:
            B = batch
        dims = {"batch": B, "n_nodes": n, "n_edges": e}
    return CellProgram(
        arch_id=arch.ARCH_ID, shape=shape, kind=arch.KIND, cfg=cfg,
        device=device, batch=B, seq_len=0, step_fn=None,
        batch_specs=gnn_lib.input_specs(cfg, dims), init_fn=gnn_lib.init,
        opt=opt_lib.adamw(lr=1e-3),
        loss_fn=gnn_lib.GraphSAGE.loss, dims=dims)


def build_cell(arch_id: str, shape_name: str, device: str | torch.device = "cuda",
               *, batch: int | None = None, n_layers: int | None = None,
               mesh=None, multi_pod: bool = False) -> CellProgram:
    """The cell ``shape_name`` of ``arch_id`` on ``device``; ``batch``
    replaces the cell's batch and ``n_layers`` an LM's depth (the cuts a
    card needs).  ``mesh``: this rank's ``Mesh`` for a decode or recsys
    serve cell on the distributed layer (``multi_pod``: the ("pod",
    "data", "model") rules)."""
    dev = resolve_device(device)
    arch = get_arch(arch_id)
    shape = next(s for s in arch.SHAPES if s.name == shape_name)
    if n_layers is not None and arch.KIND not in (ArchKind.LM_DENSE,
                                                  ArchKind.LM_MOE):
        raise ValueError(f"{arch_id}: n_layers cuts an LM's depth only")
    if arch.KIND == ArchKind.RECSYS:
        return _recsys_cell(arch, shape, dev, batch, mesh, multi_pod)
    if arch.KIND == ArchKind.GNN:
        if mesh is not None:
            raise NotImplementedError("a GNN cell takes no mesh yet; the "
                                      "sharded GNN train cells come next")
        return _gnn_cell(arch, shape, dev, batch)
    return _lm_cell(arch, shape, dev, batch, n_layers, mesh, multi_pod)
