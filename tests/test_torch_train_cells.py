"""The port's train cells (``repro_torch.launch.steps.build_cell`` on the
CPU) against the reference's ``build_cell(..., mesh=None)`` step on the
same parameters and batch: recsys ``train_batch`` of wide-deep, din, mind
and dlrm-rm2 (``rowwise_adagrad(lr=0.01)`` on ``binary_ce``) and every
GNN shape (the reference's CPU cell takes the GNN's SMOKE config, mode
``mini``, for all four; ``adamw(lr=1e-3)``).  The full and batched GNN
modes, which no CPU cell reaches, are held to the reference's
``apply_full`` / ``apply_batched`` + ``softmax_ce`` + ``jax.value_and_grad``
+ ``adamw(lr=1e-3)`` on small configs of those modes.

Compared at 1e-5, scaled by the largest value of each tensor: the loss
(the reference step's own output), every gradient (``jax.grad`` of the
step's loss), the optimizer state after the step, and the parameters
after it where |g| > 1e-3 x max |g| (a first AdaGrad or Adam step moves a
parameter by about lr x sign(g), which rounding can flip on a tiny g).
The SMOKE configs have no QR item table, so the reference's QR item-lookup
fault (ROADMAP queue 3) does not show here."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import graphsage_reddit as j_sage
from repro.launch import steps as j_steps
from repro.models import gnn as j_gnn
from repro.models.recsys_base import binary_ce as j_binary_ce
from repro.train import optimizer as j_opt
from repro_torch.common.tree import tree_map
from repro_torch.configs import graphsage_reddit as t_sage
from repro_torch.data.clicklog import cell_batch
from repro_torch.data.graph import cell_batch as graph_batch
from repro_torch.launch.steps import build_cell
from repro_torch.models import RECSYS_MODELS
from repro_torch.models import gnn as t_gnn

TOL = 1e-5
CPU = torch.device("cpu")
RECSYS = ("wide-deep", "din", "mind", "dlrm-rm2")
GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")


def _close(got, want, mask=None):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    if mask is not None:
        got, want = got[mask], want[mask]
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)


def _check_step(tcell, state, tbatch, jloss, jgrads, jnew):
    """The port's loss and gradients, then its step, against the
    reference's loss, gradients and stepped state ``jnew``."""
    loss, grads = tcell.value_and_grad(state, tbatch)
    _close(loss, jloss)
    tree_map(_close, grads, jgrads)
    before = tree_map(lambda t: t.detach().clone(), state["model"].tree())
    state, out = tcell.run(state, tbatch)
    assert float(out["loss"]) == float(loss)
    for key in ("acc", "m", "v"):
        if key in state["opt"]:
            tree_map(_close, state["opt"][key], jnew["opt"][key])

    def param(p, jp_new, g, p0):
        g = np.asarray(g, np.float32)
        assert not torch.equal(p, p0)  # the step moved it
        _close(p, jp_new, mask=np.abs(g) > 1e-3 * np.abs(g).max())
    tree_map(param, state["model"].tree(), jnew["params"], jgrads, before)


def _port_state(tcell, jparams, lib):
    model = type(tcell.init_state(torch.Generator().manual_seed(0))["model"])(
        tcell.cfg, lib.params_from_reference(
            jax.tree.map(np.asarray, jparams), device=CPU))
    return {"model": model, "opt": tcell.opt.init(model.tree())}


@pytest.mark.parametrize("arch_id", RECSYS)
def test_recsys_train_cell_matches_reference(arch_id):
    jcell = j_steps.build_cell(arch_id, "train_batch", mesh=None)
    tcell = build_cell(arch_id, "train_batch", device="cpu")
    assert tcell.cfg.name == jcell.cfg.name and tcell.batch == 16
    assert {k: v.shape for k, v in tcell.batch_specs.items()} == \
        {k: tuple(v.shape) for k, v in jcell.batch_specs.items()}
    jstate = jcell.init_state(jax.random.PRNGKey(0))
    lib = RECSYS_MODELS[tcell.cfg.interaction]
    state = _port_state(tcell, jstate["params"], lib)
    batch = cell_batch(tcell.cfg, tcell.batch_specs, seed=3)
    assert batch["label"].shape == tcell.batch_specs["label"].shape
    jbatch = jax.tree.map(jnp.asarray, batch)
    apply_fn = j_steps.RECSYS_APPLY[jcell.cfg.interaction]
    jloss, jgrads = jax.value_and_grad(lambda p: j_binary_ce(
        apply_fn(p, jbatch, jcell.cfg), jbatch["label"]))(jstate["params"])
    jnew, jout = jcell.run(jstate, jbatch)
    _close(torch.tensor(float(jout["loss"])), jloss)
    _check_step(tcell, state, {k: torch.from_numpy(v) for k, v in
                               batch.items()}, jout["loss"], jgrads, jnew)


def _gnn_ref_loss(jcfg, jbatch):
    L = jcfg.n_layers
    if jcfg.mode == "mini":
        def loss(p):
            logits = j_gnn.apply_minibatch(
                p, [jbatch[f"hop{j}_feats"] for j in range(L + 1)],
                [None] + [jbatch[f"hop{j}_mask"] for j in range(1, L + 1)],
                jcfg)
            return j_gnn.softmax_ce(logits, jbatch["labels"])
    elif jcfg.mode == "full":
        def loss(p):
            logits = j_gnn.apply_full(p, jbatch["feats"], jbatch["edges"],
                                      jcfg)
            return j_gnn.softmax_ce(logits, jbatch["labels"],
                                    jbatch["label_mask"])
    else:
        def loss(p):
            logits = j_gnn.apply_batched(
                p, jbatch["feats"], jbatch["edges"], jbatch["node_mask"],
                jbatch["graph_ids"], jbatch["labels"].shape[0], jcfg)
            return j_gnn.softmax_ce(logits, jbatch["labels"])
    return loss


@pytest.mark.parametrize("shape", GNN_SHAPES)
def test_gnn_train_cell_matches_reference(shape):
    jcell = j_steps.build_cell("graphsage-reddit", shape, mesh=None)
    tcell = build_cell("graphsage-reddit", shape, device="cpu")
    assert tcell.cfg.mode == jcell.cfg.mode == "mini"
    assert {k: v.shape for k, v in tcell.batch_specs.items()} == \
        {k: tuple(v.shape) for k, v in jcell.batch_specs.items()}
    jstate = jcell.init_state(jax.random.PRNGKey(1))
    state = _port_state(tcell, jstate["params"], t_gnn)
    batch = graph_batch(tcell.cfg, tcell.dims, seed=4)
    assert {k: v.shape for k, v in batch.items()} == \
        {k: v.shape for k, v in tcell.batch_specs.items()}
    jbatch = jax.tree.map(jnp.asarray, batch)
    jloss, jgrads = jax.value_and_grad(_gnn_ref_loss(jcell.cfg, jbatch))(
        jstate["params"])
    jnew, jout = jcell.run(jstate, jbatch)
    _close(torch.tensor(float(jout["loss"])), jloss)
    _check_step(tcell, state, {k: torch.from_numpy(v) for k, v in
                               batch.items()}, jout["loss"], jgrads, jnew)


SMALL_MODES = {
    "full_graph_sm": {"graph_nodes": 40, "graph_degree": 3, "n_nodes": 40,
                      "n_edges": 120},
    "molecule": {"batch": 6, "n_nodes": 7, "n_edges": 12},
}


@pytest.mark.parametrize("shape", list(SMALL_MODES))
def test_gnn_full_and_batched_step_match_reference(shape):
    """One port train step of the shape's mode (full, batched) on a small
    config of that mode, against the reference's apply + softmax_ce +
    value_and_grad + adamw(lr=1e-3)."""
    small = dict(d_feat=12, d_hidden=16)
    jcfg = dataclasses.replace(j_sage.SHAPE_CONFIGS[shape], **small)
    tcfg = dataclasses.replace(t_sage.SHAPE_CONFIGS[shape], **small)
    dims = SMALL_MODES[shape]
    tcell = dataclasses.replace(
        build_cell("graphsage-reddit", shape, device="cpu"), cfg=tcfg,
        dims=dims, batch_specs=t_gnn.input_specs(tcfg, dims))
    jparams = j_gnn.init(jax.random.PRNGKey(2), jcfg)
    state = _port_state(tcell, jparams, t_gnn)
    batch = graph_batch(tcfg, dims, seed=5)
    if shape == "molecule":
        assert not batch["node_mask"].all()  # padded graphs
    jbatch = jax.tree.map(jnp.asarray, batch)
    jloss, jgrads = jax.value_and_grad(_gnn_ref_loss(jcfg, jbatch))(jparams)
    opt = j_opt.adamw(lr=1e-3)
    jp, js = opt.update(jparams, jgrads, opt.init(jparams))
    _check_step(tcell, state, {k: torch.from_numpy(v) for k, v in
                               batch.items()}, jloss, jgrads,
                {"params": jp, "opt": js})


TRAIN_CELLS = [(a, "train_batch") for a in RECSYS] + [
    ("graphsage-reddit", s) for s in GNN_SHAPES]


@pytest.mark.parametrize("arch_id,shape", TRAIN_CELLS)
def test_smoke_train_loss_decreases(arch_id, shape):
    """A few steps on one fixed batch of each CPU train cell learn."""
    cell = build_cell(arch_id, shape, device="cpu")
    state = cell.init_state(torch.Generator().manual_seed(0))
    batch = (graph_batch(cell.cfg, cell.dims, seed=0) if cell.dims is not None
             else cell_batch(cell.cfg, cell.batch_specs, seed=0))
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses = []
    for _ in range(8):
        state, m = cell.run(state, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_train_cell_batch_and_device():
    """A stated batch replaces a train cell's (a full-graph cell takes
    none); the default device needs a card."""
    assert build_cell("din", "train_batch", device="cpu", batch=5).batch == 5
    cell = build_cell("graphsage-reddit", "molecule", device="cpu", batch=3)
    assert cell.batch == 3 and cell.batch_specs["labels"].shape == (3,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_cell("graphsage-reddit", "ogb_products")
