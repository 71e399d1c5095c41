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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.common.tree import tree_leaves, tree_unflatten
from repro_torch.common.types import ArchKind, ShapeSpec, TensorSpec, resolve_device
from repro_torch.configs.registry import get_arch
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

    def init_state(self, generator: torch.Generator):
        """Random parameters on the cell's device (``generator`` lives
        there): the LM's parameter tree, the recsys or GNN model, or for a
        train cell ``{"model", "opt"}`` (an LM's ``{"params", "opt"}``)."""
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

    def run(self, state, batch):
        if self.opt is not None:
            return self.train_step(state, batch)
        with torch.inference_mode():
            return self.step_fn(state, batch)


def _lm_cell(arch, shape: ShapeSpec, device: torch.device,
             batch: int | None, n_layers: int | None) -> CellProgram:
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
        if on_card:
            cfg = dataclasses.replace(cfg, decode_impl="flash")
        batch_specs = {"token": TensorSpec((B, 1), torch.int32),
                       "cache": tf_lib.kv_cache_specs(cfg, B, S)}
        pos = S - 1

        def step(params, batch):
            logits, new_cache = tf_lib.decode_step(
                params, batch["token"], batch["cache"], pos, cfg)
            return {"logits": logits, "cache": new_cache}

    return CellProgram(arch_id=arch.ARCH_ID, shape=shape, kind=arch.KIND,
                       cfg=cfg, device=device, batch=B, seq_len=S,
                       step_fn=step, batch_specs=batch_specs,
                       init_fn=tf_lib.init, opt=opt, loss_fn=loss_fn)


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
                 batch: int | None) -> CellProgram:
    on_card = device.type == "cuda"
    cfg = arch.FULL if on_card else arch.SMOKE
    B = shape["batch"] if on_card else SMOKE_RECSYS_BATCH
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

    return CellProgram(
        arch_id=arch.ARCH_ID, shape=shape, kind=arch.KIND, cfg=cfg,
        device=device, batch=B, seq_len=cfg.seq_len, step_fn=step,
        batch_specs={k: TensorSpec(*v) for k, v in specs.items()},
        init_fn=RECSYS_MODELS[cfg.interaction].init)


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
               *, batch: int | None = None, n_layers: int | None = None
               ) -> CellProgram:
    """The cell ``shape_name`` of ``arch_id`` on ``device``; ``batch``
    replaces the cell's batch and ``n_layers`` an LM's depth (the cuts a
    card needs)."""
    dev = resolve_device(device)
    arch = get_arch(arch_id)
    shape = next(s for s in arch.SHAPES if s.name == shape_name)
    if n_layers is not None and arch.KIND not in (ArchKind.LM_DENSE,
                                                  ArchKind.LM_MOE):
        raise ValueError(f"{arch_id}: n_layers cuts an LM's depth only")
    if arch.KIND == ArchKind.RECSYS:
        return _recsys_cell(arch, shape, dev, batch)
    if arch.KIND == ArchKind.GNN:
        return _gnn_cell(arch, shape, dev, batch)
    return _lm_cell(arch, shape, dev, batch, n_layers)
