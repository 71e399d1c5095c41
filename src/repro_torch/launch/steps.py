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
  cell draws a synthetic graph of the shape's nodes and edges (``dims``;
  on a mesh both padded to a multiple of the ranks, as the reference pads
  them);
- ``device="meta"`` is the card's cell on tensors that hold no data: the
  dry run's (``repro_torch.launch.dryrun``), which builds it without a
  card and traces one step of it.

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
cell; ``device`` is then each rank's device) places every cell on the
distributed layer, as the reference's mesh cells, with the rules of
``logical_rules(kind, multi_pod)``:

- an LM train or prefill cell runs tensor- and expert-parallel over
  "model" (``repro_torch.models.transformer``, ``repro_torch.dist.moe``):
  its state holds this rank's block of every parameter by
  ``param_spec_tree`` (and, training, the optimizer state of those
  blocks, which ``opt_spec_tree`` mirrors leaf for leaf), the tokens
  shard over the data axes, and the loss is the vocab-parallel
  ``ce_loss``.  The attention leaves are cut by whole heads (``heads``, a
  ``dist.sharding.HeadSplit``): where the "model" ranks outnumber the kv
  heads, as the production meshes' 16 do for llama3.2-3b, qwen2-7b and
  deepseek-67b, each kv head is whole on the ranks that share it and its
  q heads are padded with zero heads to a multiple of them;
  ``value_and_grad`` gives a padded head a zero gradient and sums a
  replicated kv head's gradient over its ranks (``Mesh.block_group``).
  Prefill returns this rank's vocabulary slice of the last logits
  (``P(dp, "model")``) and a cache of its batch block and its kv heads,
  whole along the sequence;
- a decode cell (``decode_32k``, ``long_500k``) binds ``kv_seq`` to
  ``kv_seq_axes(B)`` and, below batch 16, "batch" to None; its batch specs
  hold only this rank's cache slice (``kv_cache_spec``) and token block.
  Its weights are whole on every rank: the tensor-parallel names
  ("model", "heads", "kv_heads", "ffn", "vocab", "expert") are bound to
  None;
- a recsys cell binds "model" (and "batch" over the data axes); its state
  holds only this rank's rows of each embedding table (``row_shard``), its
  batch specs this rank's batch block; training, the tables' gradient is
  K1's backward through the rank's row window;
- a GNN cell keeps its parameters whole on every rank: ``full_graph_sm``
  and ``ogb_products`` shard their nodes and edge list over every axis,
  as the reference's batch specs do (the loss gathers the nodes'
  features, labels and mask, then runs ``dist.gnn.apply_full_sharded``),
  ``molecule`` its graphs over the
  data axes (``apply_batched_sharded``) and ``minibatch_lg`` its seeds
  over the data axes (data-parallel).

A train cell on a mesh takes the one-device step's loss: each rank's
block loss is a mean over its block divided by the blocks and summed over
the data axes (``collectives.block_mean``; the full graph's loss is whole
on every rank), and ``value_and_grad`` sums each gradient leaf over the
data axes its spec does not shard (``collectives.reduce_grads``) before
the update, which every rank makes on its own blocks.  ``init_state``
gives a rank its block of the state that one device draws from the same
generator (the recsys tables by the chunked ``row_shard`` draw), so the
one-device step is the mesh step's oracle.

``batch_spec_tree`` gives each batch leaf's ``Spec``; ``local_batch``
cuts a whole batch to this rank's block, and ``run`` (and
``value_and_grad``) enters the cell's binding (``logical.axis_rules``), as
``run_cell(cell, fn)`` does for any ``fn``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import types
from typing import Any, Callable

import torch

from repro_torch.common.tree import (
    tree_leaves,
    tree_map_with_path,
    tree_unflatten,
)
from repro_torch.common.types import ArchKind, ShapeSpec, TensorSpec, resolve_device
from repro_torch.configs.registry import get_arch
from repro_torch.dist import collectives, logical
from repro_torch.dist import gnn as dist_gnn
from repro_torch.dist.sharding import (
    P,
    head_leaf,
    kv_cache_spec,
    kv_seq_axes,
    local_shape,
    local_shard,
    logical_rules,
    pad_mask,
    param_spec_tree,
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
    grad_axes: tuple = ()  # mesh axes a train cell's gradients sum over
    heads: Any = None      # an LM's HeadSplit over its tensor-parallel ranks

    @property
    def is_lm(self) -> bool:
        return self.kind in (ArchKind.LM_DENSE, ArchKind.LM_MOE)

    def init_state(self, generator: torch.Generator):
        """Random parameters on the cell's device (``generator`` lives
        there): the LM's parameter tree, the recsys or GNN model, or for a
        train cell ``{"model", "opt"}`` (an LM's ``{"params", "opt"}``).
        On a mesh, this rank's block of them (module docstring)."""
        if self.mesh is not None and self.kind == ArchKind.RECSYS:
            model_axis = self.rules["model"]
            row_shard = (logical.shard_index(self.mesh, model_axis),
                         logical.shards(model_axis, self.mesh))
            model = self.init_fn(self.cfg, generator=generator,
                                 device=self.device, row_shard=row_shard)
        else:
            model = self.init_fn(self.cfg, generator=generator,
                                 device=self.device)
        if self.mesh is not None and self.is_lm:
            model = self.local_params(model)
        if self.opt is None:
            return model
        return self.train_state(model)

    def local_params(self, params):
        """This rank's block of a whole LM parameter tree
        (``param_spec_tree``'s placements; the tree itself without a mesh
        or where "model" is unbound, as in a decode cell, whose weights
        are whole on every rank)."""
        if self.mesh is None or not self.rules.get("model"):
            return params
        heads = None if self.heads is None else (self.heads,
                                                 self.cfg.head_dim)
        return local_shard(params, param_spec_tree(self.kind, params),
                           self.mesh, heads=heads)

    def train_state(self, model):
        """A train state of ``model`` (an LM's parameter tree, whose leaves
        are then made to require grad, or a recsys or GNN model) with a
        fresh optimizer state of its leaves."""
        if self.is_lm:
            for t in tree_leaves(model):
                t.requires_grad_(True)
            return {"params": model, "opt": self.opt.init(model)}
        return {"model": model, "opt": self.opt.init(model.tree())}

    def binding(self):
        """The cell's logical binding, entered (a no-op without a mesh)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return logical.axis_rules(self.mesh, self.rules)

    @staticmethod
    def params(state):
        """A train state's parameter tree: the LM's, or the model's
        ``tree()`` (the same tensors)."""
        return state["params"] if "params" in state else state["model"].tree()

    def value_and_grad(self, state, batch):
        """A train cell's loss on ``batch`` and the gradient of every
        parameter, as the tree of ``params`` (no update).  On a mesh: the
        global loss and this rank's block of each gradient, summed over
        ``grad_axes``."""
        params = self.params(state)
        with torch.enable_grad(), self.binding():
            loss = self.loss_fn(state.get("model", params), batch)
            grads = torch.autograd.grad(loss, tree_leaves(params),
                                        materialize_grads=True)
        if self.mesh is not None and self.grad_axes:
            grads = collectives.reduce_grads(
                list(grads), tree_leaves(param_spec_tree(self.kind, params)),
                self.mesh, self.grad_axes)
        if self.heads is not None:
            grads = self._head_grads(params, list(grads))
        return loss.detach(), tree_unflatten(params, grads)

    def _head_grads(self, params, grads: list) -> list:
        """The uneven head split's gradients (``HeadSplit``): a padded q
        head's entries take a zero gradient (it is no parameter, so the
        update leaves it and its optimizer state at zero), and a
        replicated kv head's gradient is summed over the ranks that share
        it, each holding its own q heads' share; that sum comes last, so
        every copy takes the same update and stays bitwise equal."""
        split = self.heads
        i = logical.shard_index(self.mesh, self.rules["heads"])
        paths = []
        tree_map_with_path(lambda path, _: paths.append(path), params)
        out = []
        for path, g in zip(paths, grads):
            names = [k for k in path if isinstance(k, str)]
            kind = head_leaf(names)
            if kind == "q":
                pad = pad_mask(names, split, i, self.cfg.head_dim, g.dim())
                if pad is not None:
                    axis, mask = pad
                    index = torch.as_tensor(mask.nonzero()[0],
                                            device=g.device)
                    g = g.index_fill(axis, index, 0)
            elif kind == "kv" and split.share > 1:
                g = collectives.all_reduce(
                    g.contiguous(), self.mesh.block_group(
                        self.rules["heads"], split.share))
            out.append(g)
        return out

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
        with torch.inference_mode(), self.binding():
            return self.step_fn(state, batch)


# the LM's tensor-parallel logical names, unbound in a decode cell, whose
# weights are whole on every rank (see the module docstring)
_LM_TP_NAMES = ("model", "heads", "kv_heads", "ffn", "vocab", "expert")


def _dp_axes(multi_pod: bool) -> tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def _pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def _full_size(device: torch.device) -> bool:
    """The card's sizes (FULL config, the shape's batch) on a card and on
    the dry run's ``meta`` device; SMOKE's on the CPU."""
    return device.type in ("cuda", "meta")


def _lm_cell(arch, shape: ShapeSpec, device: torch.device,
             batch: int | None, n_layers: int | None, mesh,
             multi_pod: bool) -> CellProgram:
    on_card = _full_size(device)
    cfg = arch.FULL if on_card else arch.SMOKE
    B = shape["global_batch"] if on_card else SMOKE_BATCH
    S = shape["seq_len"] if on_card else SMOKE_SEQ
    if batch is not None:
        B = batch
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    step = opt = loss_fn = heads = None
    dp = _dp_axes(multi_pod)
    if mesh is not None and shape.step != "decode":
        heads = tf_lib.head_split(cfg, logical.shards("model", mesh))
        if shape.step == "train" and heads.share > 1:
            # made here, on every rank in one order, not inside a step
            mesh.block_group("model", heads.share)
    # the cache prefill fills: this rank's batch block and kv_heads
    cache_specs = tf_lib.kv_cache_specs(cfg, B, S)
    if mesh is not None and shape.step == "prefill":
        cache_specs = {k: TensorSpec((v.shape[0], *local_shape(
            v.shape[1:3], P(dp, None), mesh), heads.kv_local, v.shape[4]),
            v.dtype) for k, v in cache_specs.items()}

    if shape.step == "train":
        batch_specs = tf_lib.input_specs(cfg, B, S)
        opt = opt_lib.adamw(lr=3e-4)

        def loss_fn(params, batch):
            return tf_lib.lm_loss(params, batch, cfg)

    elif shape.step == "prefill":
        batch_specs = tf_lib.input_specs(cfg, B, S)

        def step(params, batch):
            cache = tf_lib.cache_from_specs(cache_specs, device)
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
    grad_axes = ()
    if mesh is not None:
        rules = logical_rules(arch.KIND, multi_pod)
        if shape.step == "decode":
            rules.update({name: None for name in _LM_TP_NAMES})
            rules["kv_seq"] = kv_seq_axes(B, multi_pod)
            if B < 16:
                rules["batch"] = None  # batch 1: token replicated, KV seq-sharded
            spec = kv_cache_spec(B, multi_pod)
            spec_tree = {"token": P(dp, None) if B >= 16 else P(None, None),
                         "cache": {k: spec for k in batch_specs["cache"]}}
        else:
            spec_tree = {"tokens": P(dp, None)}
            grad_axes = dp if shape.step == "train" else ()
        batch_specs = local_shard(batch_specs, spec_tree, mesh)
    return CellProgram(arch_id=arch.ARCH_ID, shape=shape, kind=arch.KIND,
                       cfg=cfg, device=device, batch=B, seq_len=S,
                       step_fn=step, batch_specs=batch_specs,
                       init_fn=tf_lib.init, opt=opt, loss_fn=loss_fn,
                       mesh=mesh, rules=rules, batch_spec_tree=spec_tree,
                       grad_axes=grad_axes, heads=heads)


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


def _recsys_batch_spec_tree(batch_specs: dict, dp) -> dict:
    """The reference's recsys batch layout: a leading dimension over one
    shards over the data axes."""
    return {k: P(dp if len(v.shape) and v.shape[0] > 1 else None,
                 *[None] * (len(v.shape) - 1))
            for k, v in batch_specs.items()}


def _recsys_cell(arch, shape: ShapeSpec, device: torch.device,
                 batch: int | None, mesh, multi_pod: bool) -> CellProgram:
    on_card = _full_size(device)
    cfg = arch.FULL if on_card else arch.SMOKE
    B = shape["batch"] if on_card else SMOKE_RECSYS_BATCH
    dp = _dp_axes(multi_pod)
    if shape.step == "train":
        cell = recsys_train_cell(cfg, B if batch is None else batch, device,
                                 lr=RECSYS_LR, arch_id=arch.ARCH_ID,
                                 shape=shape)
        if mesh is None:
            return cell
        spec_tree = _recsys_batch_spec_tree(cell.batch_specs, dp)

        def loss_fn(model, b):
            return collectives.block_mean(binary_ce(model(b), b["label"]), dp)

        return dataclasses.replace(
            cell, mesh=mesh, rules=logical_rules(arch.KIND, multi_pod),
            batch_spec_tree=spec_tree, grad_axes=dp, loss_fn=loss_fn,
            batch_specs=local_shard(cell.batch_specs, spec_tree, mesh))
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
        spec_tree = _recsys_batch_spec_tree(batch_specs, dp)
        batch_specs = local_shard(batch_specs, spec_tree, mesh)
    return CellProgram(
        arch_id=arch.ARCH_ID, shape=shape, kind=arch.KIND, cfg=cfg,
        device=device, batch=B, seq_len=cfg.seq_len, step_fn=step,
        batch_specs=batch_specs,
        init_fn=RECSYS_MODELS[cfg.interaction].init, mesh=mesh,
        rules=rules, batch_spec_tree=spec_tree)


def _gnn_cell(arch, shape: ShapeSpec, device: torch.device,
              batch: int | None, mesh, multi_pod: bool) -> CellProgram:
    on_card = _full_size(device)
    cfg = arch.SHAPE_CONFIGS[shape.name] if on_card else arch.SMOKE
    if mesh is not None and not on_card:
        # the shape's mode at the SMOKE widths: a CPU mesh runs the
        # sharded dataflow of each shape
        mode = arch.SHAPE_CONFIGS[shape.name]
        cfg = dataclasses.replace(cfg, mode=mode.mode, readout=mode.readout,
                                  aggregator=mode.aggregator)
    # the shape's nodes at its edges a node, rounded
    graph = (shape["n_nodes"], round(shape["n_edges"] / shape["n_nodes"]))
    if cfg.mode == "full":
        N, deg = graph if on_card else SMOKE_GNN_FULL
        E = shape["n_edges"] if on_card else N * deg
        if batch is not None:
            raise ValueError("a full-graph cell trains on the whole graph; "
                             "it takes no batch")
        if mesh is not None:  # nodes and edges split over every rank
            N, E = _pad_to(N, mesh.size), _pad_to(E, mesh.size)
        dims = {"graph_nodes": N, "graph_degree": deg, "n_nodes": N,
                "n_edges": E}
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
    batch_specs = gnn_lib.input_specs(cfg, dims)
    loss_fn = gnn_lib.GraphSAGE.loss
    rules = spec_tree = None
    grad_axes = ()
    if mesh is not None:
        rules = logical_rules(arch.KIND, multi_pod)
        dp = _dp_axes(multi_pod)
        loss_fn, spec_tree, grad_axes = _gnn_mesh(cfg, dims, batch_specs,
                                                  mesh, dp)
        batch_specs = local_shard(batch_specs, spec_tree, mesh)
    return CellProgram(
        arch_id=arch.ARCH_ID, shape=shape, kind=arch.KIND, cfg=cfg,
        device=device, batch=B, seq_len=0, step_fn=None,
        batch_specs=batch_specs, init_fn=gnn_lib.init,
        opt=opt_lib.adamw(lr=1e-3), loss_fn=loss_fn, dims=dims, mesh=mesh,
        rules=rules, batch_spec_tree=spec_tree, grad_axes=grad_axes)


def _gnn_mesh(cfg, dims: dict, batch_specs: dict, mesh, dp):
    """(loss, batch spec tree, gradient axes) of a GNN cell on a mesh: the
    full graph's nodes and edges over every axis, as the reference's
    batch specs (the loss gathers the nodes' features, labels and mask
    whole, then takes its edge block; the loss whole on every rank, so no
    gradient sum), the packed graphs or the minibatch's seeds over the
    data axes (a block loss, its gradient summed over them)."""
    if cfg.mode == "full":
        axes = tuple(mesh.axis_names)
        spec_tree = {k: P(axes, *[None] * (len(v.shape) - 1))
                     for k, v in batch_specs.items()}
        spec_tree["edges"] = P(None, axes)

        def loss(model, b):
            group = mesh.group(axes)
            feats, labels = (collectives.all_gather(b[k], group).flatten(0, 1)
                             for k in ("feats", "labels"))
            mask = collectives.all_gather(b["label_mask"].to(torch.uint8),
                                          group).flatten().bool()
            return dist_gnn.apply_full_sharded(
                model.tree(), feats, b["edges"], labels, mask, cfg, mesh,
                dims["n_nodes"])

        return loss, spec_tree, ()
    spec_tree = {k: P(dp, *[None] * (len(v.shape) - 1))
                 for k, v in batch_specs.items()}
    if cfg.mode == "batched":
        spec_tree["edges"] = P(None, dp)

        def loss(model, b):
            logits, labels = dist_gnn.apply_batched_sharded(
                model.tree(), b, cfg, mesh, dp, dims["batch"],
                dims["n_nodes"], dims["n_edges"])
            return collectives.block_mean(gnn_lib.softmax_ce(logits, labels),
                                          dp)
    else:
        def loss(model, b):
            return collectives.block_mean(model.loss(b), dp)
    return loss, spec_tree, dp


def build_cell(arch_id: str, shape_name: str, device: str | torch.device = "cuda",
               *, batch: int | None = None, n_layers: int | None = None,
               mesh=None, multi_pod: bool = False,
               cfg_override=None) -> CellProgram:
    """The cell ``shape_name`` of ``arch_id`` on ``device``; ``batch``
    replaces the cell's batch and ``n_layers`` an LM's depth (the cuts a
    card needs).  ``mesh``: this rank's ``Mesh``, the cell then on the
    distributed layer (module docstring; ``multi_pod``: the ("pod",
    "data", "model") rules).  ``cfg_override`` replaces the config the
    cell takes (an LM's, a recsys or a GNN config: FULL, SMOKE on the CPU,
    a GNN shape's ``SHAPE_CONFIGS`` entry), as the reference's replaces
    FULL for the dry run's depth correction."""
    dev = resolve_device(device)
    arch = get_arch(arch_id)
    shape = next(s for s in arch.SHAPES if s.name == shape_name)
    if cfg_override is not None:
        arch = types.SimpleNamespace(
            ARCH_ID=arch.ARCH_ID, KIND=arch.KIND, SHAPES=arch.SHAPES,
            FULL=cfg_override, SMOKE=cfg_override,
            SHAPE_CONFIGS={s.name: cfg_override for s in arch.SHAPES}
            if arch.KIND == ArchKind.GNN else None)
    if n_layers is not None and arch.KIND not in (ArchKind.LM_DENSE,
                                                  ArchKind.LM_MOE):
        raise ValueError(f"{arch_id}: n_layers cuts an LM's depth only")
    if arch.KIND == ArchKind.RECSYS:
        return _recsys_cell(arch, shape, dev, batch, mesh, multi_pod)
    if arch.KIND == ArchKind.GNN:
        return _gnn_cell(arch, shape, dev, batch, mesh, multi_pod)
    return _lm_cell(arch, shape, dev, batch, n_layers, mesh, multi_pod)


def run_cell(cell: CellProgram, fn: Callable):
    """``fn()`` under the cell's logical binding (a plain call without a
    mesh), as the reference's ``run_cell``."""
    with cell.binding():
        return fn()
