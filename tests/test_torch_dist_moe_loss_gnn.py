"""Expert-parallel MoE, the vocab-parallel loss and the sharded GraphSAGE.

Four gloo ranks on the CPU, a (2, 2) ("data", "model") mesh, spawned once
for the file (``torch_dist_ranks.moe_loss_gnn_rank``):

- MoE: each rank holds its window of 4 of the 8 padded experts and its
  data block of the tokens; held to the reference's single-device
  ``apply_moe_dense`` and ``moe_apply`` (their multi-device reference tests
  fail), on carried-across parameters;
- CE: logits [8, 16, 64] over ("data", None, "model"); the loss and each
  rank's block of its gradient against the reference's ``ce_loss`` and
  ``jax.grad``;
- GNN: ``apply_full_sharded`` (the edge list over both axes; mean and max
  aggregators) and ``apply_batched_sharded`` (8 graphs over "data")
  against the reference's own sharded functions, run in a subprocess with
  8 fake devices as ``tests/test_distributed.py::run_sub`` runs them (its
  ``test_gnn_vertex_partition_matches_local`` passes); and every parameter
  gradient of the full-graph loss against the port's single-device
  gradient.

Tolerances: f32 1e-5, 2e-4 where partial sums are added in another order
(the MoE windows' all-reduce, the GNN aggregates)."""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro.dist import loss as j_loss
from repro.dist import moe as j_moe
from repro.models import gnn as j_gnn
from repro.models import layers as j_layers
from repro_torch.common.convert import tree_from_numpy
from repro_torch.launch.mesh import spawn
from repro_torch.models import gnn as t_gnn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TOL, SUM_TOL = 1e-5, 2e-4
MOE = dict(d_model=32, d_ff=16, n_experts=6, top_k=2, n_shared=1,
           shared_d_ff=64, capacity_factor=8.0, pad_to=4)
GNN = dict(name="t", d_feat=8, d_hidden=16, n_classes=4)
N, E = 64, 256
G, GN, GE = 8, 6, 10   # packed graphs: graphs, nodes and edges a graph

REF_BODY = """
import os, sys, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import warnings; warnings.filterwarnings("ignore")
import jax, jax.numpy as jnp, numpy as np
from repro.models.gnn import GNNConfig
from repro.dist.gnn import apply_full_sharded, apply_batched_sharded
mesh = jax.make_mesh((2, 4), ("data", "model"))
with open(sys.argv[1], "rb") as f:
    inp = pickle.load(f)
out = {}
for agg, c in inp["full"].items():
    cfg = GNNConfig(**c["cfg"])
    p = jax.tree.map(jnp.asarray, c["params"])
    loss = jax.jit(lambda p, f, e, l, m, cfg=cfg: apply_full_sharded(
        p, f, e, l, m, cfg, mesh, c["n_nodes"]))(
        p, c["feats"], c["edges"], c["labels"], c["mask"])
    out["full_" + agg] = np.asarray(loss)
b = inp["batched"]
cfg = GNNConfig(**b["cfg"])
logits, labels = jax.jit(lambda p, bt: apply_batched_sharded(
    p, bt, cfg, mesh, ("data",), b["n_graphs"], b["n_nodes"], b["n_edges"]))(
    jax.tree.map(jnp.asarray, b["params"]),
    {k: jnp.asarray(v) for k, v in b["batch"].items()})
out["batched"] = np.asarray(logits)
np.savez(sys.argv[2], **out)
print("PASS")
"""


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _gnn_inputs():
    rng = np.random.default_rng(3)
    full = {}
    for i, agg in enumerate(("mean", "max")):
        cfg = dict(GNN, aggregator=agg)
        full[agg] = {
            "cfg": cfg, "n_nodes": N,
            "params": _np_tree(j_gnn.init(jax.random.PRNGKey(i),
                                          j_gnn.GNNConfig(**cfg))),
            "feats": rng.standard_normal((N, 8)).astype(np.float32),
            "edges": rng.integers(0, N, (2, E)).astype(np.int32),
            "labels": rng.integers(0, 4, N).astype(np.int32),
            "mask": rng.random(N) < 0.7}
    cfg = dict(GNN, mode="batched", readout="graph")
    src = rng.integers(0, GN, (G, GE)) + GN * np.arange(G)[:, None]
    dst = rng.integers(0, GN, (G, GE)) + GN * np.arange(G)[:, None]
    batched = {
        "cfg": cfg, "n_graphs": G, "n_nodes": GN, "n_edges": GE,
        "params": _np_tree(j_gnn.init(jax.random.PRNGKey(5),
                                      j_gnn.GNNConfig(**cfg))),
        "batch": {"feats": rng.standard_normal((G * GN, 8)).astype(
                      np.float32),
                  "edges": np.stack([src.reshape(-1), dst.reshape(-1)]
                                    ).astype(np.int32),
                  "node_mask": rng.random(G * GN) < 0.9,
                  "graph_ids": np.repeat(np.arange(G), GN).astype(np.int32),
                  "labels": rng.integers(0, 4, G).astype(np.int32)}}
    return {"full": full, "batched": batched}


def _torch_gnn(gnn):
    """The same inputs with the parameters as CPU tensors."""
    out = {"full": {}, "batched": dict(gnn["batched"])}
    for agg, c in gnn["full"].items():
        out["full"][agg] = dict(c, params=tree_from_numpy(c["params"], CPU))
    out["batched"]["params"] = tree_from_numpy(gnn["batched"]["params"], CPU)
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import pickle

    tmp = tmp_path_factory.mktemp("mlg")
    gnn = _gnn_inputs()
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(gnn, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REF_BODY), str(tmp / "in.pkl"),
         str(tmp / "ref.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    jcfg = j_layers.MoEConfig(**MOE)
    jp = j_layers.init_moe(jax.random.PRNGKey(0), jcfg)
    x = np.random.default_rng(1).standard_normal((64, 32)).astype(np.float32)
    moe = {"cfg": MOE, "params": tree_from_numpy(_np_tree(jp), CPU), "x": x}
    rng = np.random.default_rng(2)
    ce = {"logits": rng.standard_normal((8, 16, 64)).astype(np.float32),
          "targets": rng.integers(0, 64, (8, 16)).astype(np.int64)}
    try:
        out = spawn(ranks.moe_loss_gnn_rank, 4, backend="gloo",
                    init_file=tmp / "init", device="cpu",
                    args=(moe, ce, _torch_gnn(gnn)))
    finally:
        stdout, stderr = ref.communicate(timeout=300)
    assert ref.returncode == 0 and "PASS" in stdout, stderr
    return {"moe": (jcfg, jp, x), "ce": ce, "gnn": gnn,
            "ref": dict(np.load(tmp / "ref.npz")), "out": out}


def _by_data(out, get):
    by = {}
    for r in out:
        d = r["coords"]["data"]
        if d in by:
            np.testing.assert_array_equal(get(r), by[d])
        by[d] = get(r)
    return np.concatenate([by[d] for d in sorted(by)])


def test_moe_expert_parallel_matches_dense(results):
    jcfg, jp, x = results["moe"]
    out = results["out"]
    got = _by_data(out, lambda r: r["moe"])
    dense, _ = j_layers.apply_moe_dense(jp, jnp.asarray(x), jcfg)
    grouped, _ = j_moe.moe_apply(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got, np.asarray(dense), rtol=SUM_TOL,
                               atol=TOL)
    np.testing.assert_allclose(got, np.asarray(grouped), rtol=SUM_TOL,
                               atol=TOL)
    assert all(r["moe_experts_held"] == 4 for r in out)


def test_vocab_parallel_ce(results):
    ce, out = results["ce"], results["out"]
    logits, targets = jnp.asarray(ce["logits"]), jnp.asarray(ce["targets"])
    ref = float(j_loss.ce_loss(logits, targets))
    g_ref = np.asarray(jax.grad(lambda l: j_loss.ce_loss(l, targets))(logits))
    for r in out:
        assert abs(r["ce"] - ref) < TOL
        d, m = r["coords"]["data"], r["coords"]["model"]
        np.testing.assert_allclose(
            r["ce_grad"], g_ref[4 * d:4 * d + 4, :, 32 * m:32 * m + 32],
            rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("agg", ["mean", "max"])
def test_gnn_full_graph_sharded(results, agg):
    """The loss against the reference's apply_full_sharded and the port's
    single-device forward; with the mean aggregator every parameter's
    gradient against the single-device gradient."""
    c, ref, out = results["gnn"]["full"][agg], results["ref"], results["out"]
    cfg = t_gnn.GNNConfig(**c["cfg"])
    params = tree_from_numpy(c["params"], CPU)
    leaves = [p for layer in params["layers"] for p in layer.values()] + \
        [params["cls"]]
    for p in leaves:
        p.requires_grad_(True)
    loss = t_gnn.softmax_ce(
        t_gnn.apply_full(params, torch.from_numpy(c["feats"]),
                         torch.from_numpy(c["edges"]), cfg),
        torch.from_numpy(c["labels"]), torch.from_numpy(c["mask"]))
    grads = torch.autograd.grad(loss, leaves)
    for r in out:
        res = r["gnn"][agg]
        assert abs(res["loss"] - float(ref["full_" + agg])) < SUM_TOL
        assert abs(res["loss"] - float(loss.detach())) < TOL
        if agg == "mean":
            for got, want in zip(res["grads"], grads):
                np.testing.assert_allclose(got, want.numpy(), rtol=TOL,
                                           atol=TOL)


def test_gnn_batched_sharded(results):
    b, ref, out = results["gnn"]["batched"], results["ref"], results["out"]
    got = _by_data(out, lambda r: r["gnn"]["batched"]["logits"])
    np.testing.assert_allclose(got, ref["batched"], rtol=TOL, atol=TOL)
    labels = _by_data(out, lambda r: r["gnn"]["batched"]["labels"])
    np.testing.assert_array_equal(labels, b["batch"]["labels"])
    cfg = t_gnn.GNNConfig(**b["cfg"])
    t = {k: torch.from_numpy(v) for k, v in b["batch"].items()}
    whole = t_gnn.apply_batched(tree_from_numpy(b["params"], CPU), t["feats"],
                                t["edges"], t["node_mask"], t["graph_ids"],
                                G, cfg)
    np.testing.assert_allclose(got, whole.detach().numpy(), rtol=TOL,
                               atol=TOL)
