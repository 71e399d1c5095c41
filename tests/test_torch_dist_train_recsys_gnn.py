"""The recsys and GNN train cells on a mesh, and K1's backward through a
row window, against the reference's single-device step.

Four gloo ranks on a (2, 2) ("data", "model") mesh
(``torch_dist_ranks.recsys_gnn_rank``) run one step of
``build_cell(arch, shape, "cpu", mesh=...)`` from the reference's
parameters:

- ``train_batch`` of wide-deep, din, mind and dlrm-rm2: each rank holds
  its half of the combined table's rows (K1's forward and backward
  through its row window), its batch block over "data"; DIN's and MIND's
  item rows come through ``sharded_row_gather``;
- the four GNN shapes at the SMOKE widths in each shape's mode (the CPU
  mesh runs the sharded dataflow): full_graph_sm and ogb_products with
  the edge list over both axes, molecule with its graphs over "data",
  minibatch_lg with its seeds over "data";
- a config with a QR feature: ``embedding_bag`` through the row-sharded
  table under autograd (the QR rows through ``sharded_row_gather``).

The oracle is the reference's ``build_cell(..., mesh=None)`` step (the
recsys cells) or its ``apply`` + ``softmax_ce`` + ``value_and_grad`` +
``adamw(1e-3)`` on the same config (the GNN modes), on the whole batch:
the loss, each rank's block of every gradient leaf and of the optimizer
state after the step, and the parameters after it where |g| is not tiny.
Tolerances: f32 1e-5, scaled by the largest value compared (2e-4 for the
GNN's aggregates, whose partial sums the all-reduce adds in another
order).  The window's plain backward is held bitwise to the one-device
plain backward's rows and to the reference's ``jax.grad`` rows."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro.launch import steps as j_steps
from repro.models import embedding as j_emb
from repro.models import gnn as j_gnn
from repro.models.recsys_base import binary_ce as j_binary_ce
from repro.train import optimizer as j_opt
from repro_torch.common.tree import tree_map
from repro_torch.data.clicklog import cell_batch
from repro_torch.data.graph import cell_batch as graph_batch
from repro_torch.kernels.embedding_bag import ops as k1_ops
from repro_torch.kernels.embedding_bag.ref import (
    embedding_bag_features_grad_ref,
)
from repro_torch.launch.mesh import spawn
from repro_torch.launch.steps import build_cell
from repro_torch.models import RECSYS_MODELS
from repro_torch.models import gnn as t_gnn
from torch_dist_train_util import RankMesh, block, close

TOL, SUM_TOL = 1e-5, 2e-4
CPU = torch.device("cpu")
MESH = {"data": 2, "model": 2}
RECSYS = ("wide-deep", "din", "mind", "dlrm-rm2")
GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
QR = dict(vocab_sizes=(3000, 700, 5000), dim=16, pooling=(4, 2, 3),
          qr_features=(2,), qr_buckets=64)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _recsys_reference(arch_id):
    jcell = j_steps.build_cell(arch_id, "train_batch", mesh=None)
    tcell = build_cell(arch_id, "train_batch", device="cpu")
    jstate = jcell.init_state(jax.random.PRNGKey(0))
    batch = cell_batch(tcell.cfg, tcell.batch_specs, seed=3)
    jbatch = jax.tree.map(jnp.asarray, batch)
    apply_fn = j_steps.RECSYS_APPLY[jcell.cfg.interaction]
    jloss, jgrads = jax.value_and_grad(lambda p: j_binary_ce(
        apply_fn(p, jbatch, jcell.cfg), jbatch["label"]))(jstate["params"])
    params = _np_tree(jstate["params"])
    jnew, _ = jcell.run(jstate, jbatch)   # donates jstate
    lib = RECSYS_MODELS[tcell.cfg.interaction]
    case = {"arch_id": arch_id, "shape": "train_batch", "batch": batch,
            "params": lib.params_from_reference(params, device=CPU)}
    return case, {"loss": float(jloss), "grads": _np_tree(jgrads),
                  "new": _np_tree(jnew["params"]),
                  "opt": _np_tree(jnew["opt"])}


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


def _gnn_reference(shape, seed):
    # the mesh cell's config and sizes, built against the mesh's shape
    cell = build_cell("graphsage-reddit", shape, "cpu",
                      mesh=RankMesh(MESH, {"data": 0, "model": 0}))
    cfg = cell.cfg
    jcfg = j_gnn.GNNConfig(**{f.name: getattr(cfg, f.name) for f in
                              dataclasses.fields(cfg) if f.name != "dtype"})
    jp = j_gnn.init(jax.random.PRNGKey(seed), jcfg)
    batch = graph_batch(cfg, cell.dims, seed=seed)
    jbatch = jax.tree.map(jnp.asarray, batch)
    jloss, jgrads = jax.value_and_grad(_gnn_ref_loss(jcfg, jbatch))(jp)
    opt = j_opt.adamw(lr=1e-3)
    jnew, jopt = opt.update(jp, jgrads, opt.init(jp))
    case = {"arch_id": "graphsage-reddit", "shape": shape, "batch": batch,
            "params": t_gnn.params_from_reference(_np_tree(jp), device=CPU)}
    return case, {"loss": float(jloss), "grads": _np_tree(jgrads),
                  "new": _np_tree(jnew), "opt": _np_tree(jopt),
                  "mode": cfg.mode}


def _qr_inputs():
    cfg = j_emb.EmbeddingConfig(**QR)
    rng = np.random.default_rng(11)
    table = rng.standard_normal((cfg.total_rows, 16)).astype(np.float32)
    ids = np.stack([rng.integers(0, v, (16, 4)) for v in QR["vocab_sizes"]],
                   axis=1).astype(np.int32)
    ids[rng.random(ids.shape) < 0.3] = -1
    for f, p in enumerate(QR["pooling"]):
        ids[:, f, p:] = -1
    r = rng.standard_normal((16, 3, 16)).astype(np.float32)

    def loss(t):
        pooled = j_emb.embedding_bag_local({"table": t}, jnp.asarray(ids), cfg)
        return (pooled * r).sum((1, 2)).mean(), pooled
    (jloss, pooled), g = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(table))
    return ({"cfg": QR, "table": table, "ids": ids, "r": r},
            {"loss": float(jloss), "pooled": np.asarray(pooled),
             "grad": np.asarray(g)})


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("recsys_gnn_train")
    cases, refs = {}, {}
    for arch_id in RECSYS:
        cases[arch_id], refs[arch_id] = _recsys_reference(arch_id)
    for i, shape in enumerate(GNN_SHAPES):
        cases[shape], refs[shape] = _gnn_reference(shape, 20 + i)
    qr, qr_ref = _qr_inputs()
    out = spawn(ranks.recsys_gnn_rank, 4, backend="gloo",
                init_file=tmp / "init", device="cpu", args=(cases, qr))
    return {"refs": refs, "ranks": out, "qr_ref": qr_ref}


def _check(results, name, grad_tol):
    ref = results["refs"][name]
    for r in results["ranks"]:
        case, c = r["cases"][name], r["coords"]
        specs = case["p_specs"]
        close(case["loss"], ref["loss"], TOL)
        assert case["step_loss"] == case["loss"]
        grads = block(ref["grads"], specs, MESH, c)
        tree_map(lambda g, w: close(g, w, grad_tol), case["grads"], grads)
        for key in ("acc", "m", "v"):
            if key in case["opt"]:
                tree_map(lambda g, w: close(g, w, grad_tol),
                         case["opt"][key],
                         block(ref["opt"][key], case["o_specs"][key], MESH,
                               c))
        tree_map(lambda p, w, g: close(
            p, w, grad_tol, mask=np.abs(g) > 1e-3 * np.abs(g).max()),
            case["params"], block(ref["new"], specs, MESH, c), grads)
    return [r["cases"][name] for r in results["ranks"]]


@pytest.mark.parametrize("arch_id", RECSYS)
def test_recsys_train_step_on_mesh_matches_reference(results, arch_id):
    cases = _check(results, arch_id, TOL)
    case = cases[0]
    assert case["grad_axes"] == ("data",)
    assert case["batch_shapes"]["label"] == (8,)
    # each table is this rank's half of the rows; the rest is whole
    sharded = []

    def rows(spec, local, whole):
        if tuple(spec) == ("model", None):
            assert local.shape[0] * 2 == whole.shape[0]
            sharded.append(local.shape)
        else:
            assert local.shape == whole.shape
    tree_map(rows, case["p_specs"], case["params"],
             results["refs"][arch_id]["grads"])
    assert sharded


@pytest.mark.parametrize("shape", GNN_SHAPES)
def test_gnn_train_step_on_mesh_matches_reference(results, shape):
    cases = _check(results, shape, SUM_TOL)
    mode = results["refs"][shape]["mode"]
    assert cases[0]["grad_axes"] == (() if mode == "full" else ("data",))
    if mode == "full":   # the edge list over all four ranks, no gradient sum
        assert cases[0]["batch_shapes"]["edges"] == (2, 64)


def test_qr_gradient_through_row_sharded_table(results):
    """The QR feature's quotient and remainder rows through
    ``sharded_row_gather`` and the other features through K1's window:
    the pooled block, the loss and each rank's rows of the table gradient
    against ``jax.grad`` of the reference's ``embedding_bag_local``."""
    ref = results["qr_ref"]
    from repro_torch.dist.sharding import P
    for r in results["ranks"]:
        c = r["coords"]
        close(r["qr"]["pooled"], block(ref["pooled"], P("data", None, None),
                                       MESH, c), TOL)
        close(r["qr"]["loss"], ref["loss"], TOL)
        close(r["qr"]["grad"], block(ref["grad"], P("model", None), MESH, c),
              TOL)


WINDOWS = {"cut_feature": (1234, 3800), "first_rows": (0, 512),
           "last_rows": (4100, 4900), "no_ids": (4900, 5600),
           "empty": (2000, 2000)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("where", list(WINDOWS))
def test_k1_grad_window_plain_matches_one_device_rows(where, dtype):
    """K1's plain backward through a row window (the CPU path and the
    card's oracle): rows [lo, hi) of the one-device plain backward,
    bitwise (each row's pairs are added in the same order), and of
    ``jax.grad`` of the reference's ``embedding_bag_local`` at the dtype's
    tolerance; the window's rows past the table are zero, an empty window
    is [0, D].  Through ``ops`` on CPU tensors the window backward runs
    the plain version and launches nothing."""
    sizes = (3000, 700, 1200)
    H = sum(sizes)
    rng = np.random.default_rng(len(where))
    ids = np.stack([rng.integers(0, v, (64, 8)) for v in sizes],
                   axis=1).astype(np.int32)
    ids[rng.random(ids.shape) < 0.25] = -1
    off = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    g = rng.standard_normal((64, 3, 16)).astype(np.float32)
    lo, hi = WINDOWS[where]
    tg = torch.from_numpy(g).to(dtype)
    tid, toff = torch.from_numpy(ids), torch.from_numpy(off)
    whole = embedding_bag_features_grad_ref(tg, tid, toff, H)
    before = (k1_ops.grad_launches, k1_ops.grad_window_launches)
    got = k1_ops.embedding_bag_features_grad(tg, tid, toff, hi - lo,
                                             row_window=(lo, hi))
    assert (k1_ops.grad_launches, k1_ops.grad_window_launches) == before
    assert got.dtype == dtype and got.shape == (hi - lo, 16)
    inside = min(hi, H) - lo if lo < H else 0
    assert torch.equal(got[:inside], whole[lo:lo + inside])
    assert not got[inside:].any()
    jcfg = j_emb.EmbeddingConfig(vocab_sizes=sizes, dim=16,
                                 pooling=(8, 8, 8), row_pad=1)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax.grad(lambda t: (j_emb.embedding_bag_local(
        {"table": t}, jnp.asarray(ids), jcfg).astype(jnp.float32)
        * g.astype(np.float32)).sum())(jnp.zeros((H, 16), jdt))
    want = np.asarray(want.astype(jnp.float32))[lo:lo + inside]
    close(got[:inside].float().numpy(), want,
          1e-5 if dtype == torch.float32 else 3e-2)
