"""The port's GraphSAGE (``repro_torch.models.gnn``), its graph data
(``repro_torch.data.graph``), its config and ``profile_gnn`` against the
reference's, on the same inputs (made with numpy) and copied parameters.

Forward outputs and gradients (``torch.autograd`` against ``jax.grad``)
at 1e-5, scaled by the largest value compared: float32 sums in another
order (XLA's segment_sum and scatter against torch's ``index_add`` and
``scatter_reduce``).  The graph data and the workload profile bitwise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import graphsage_reddit as j_cfg
from repro.core.workload import profile_gnn as j_profile_gnn
from repro.data import graph as j_graph
from repro.models import gnn as j_gnn
from repro_torch.configs import graphsage_reddit as t_cfg
from repro_torch.configs.registry import get_arch
from repro_torch.core.workload import profile_gnn as t_profile_gnn
from repro_torch.data import graph as t_graph
from repro_torch.models import gnn as t_gnn

TOL = 1e-5
CPU = torch.device("cpu")
AGGREGATORS = ("mean", "sum", "max")


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _cfg(mode, aggregator="mean", **kw):
    base = dict(name="t", d_feat=12, d_hidden=16, n_layers=2, n_classes=5,
                aggregator=aggregator, fanout=(4, 3), mode=mode)
    base.update(kw)
    return j_gnn.GNNConfig(**base), t_gnn.GNNConfig(**base)


def _params(jcfg, seed=0):
    jp = j_gnn.init(jax.random.PRNGKey(seed), jcfg)
    np_tree = jax.tree.map(np.asarray, jp)
    return jp, t_gnn.params_from_reference(np_tree, device=CPU)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _graph_inputs(seed, n=30, e=90, d=12, isolated=(4, 11)):
    """feats [n, d], edges [2, e] with no edge into ``isolated``."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n, d)).astype(np.float32)
    dst = rng.integers(0, n, e)
    for v in isolated:
        dst[dst == v] = (v + 1) % n
    edges = np.stack([rng.integers(0, n, e), dst]).astype(np.int32)
    return feats, edges


@pytest.mark.parametrize("aggregator", AGGREGATORS)
def test_aggregate_full_matches_reference(aggregator):
    feats, edges = _graph_inputs(1)
    want = j_gnn.aggregate_full(jnp.asarray(feats), jnp.asarray(edges), 30,
                                aggregator)
    got = t_gnn.aggregate_full(_t(feats), _t(edges), 30, aggregator)
    _close(got, want)
    assert not got[[4, 11]].any()  # no in-edges: 0 (max: -inf, then 0)


def _softmax_ce_both(seed, n, masked):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 5, n).astype(np.int32)
    mask = rng.random(n) < 0.5 if masked else None
    return labels, mask


@pytest.mark.parametrize("aggregator", AGGREGATORS)
def test_apply_full_and_grads_match_reference(aggregator):
    jcfg, tcfg = _cfg("full", aggregator)
    jp, tp = _params(jcfg)
    feats, edges = _graph_inputs(2)
    labels, mask = _softmax_ce_both(3, 30, masked=True)

    def j_loss(p):
        logits = j_gnn.apply_full(p, jnp.asarray(feats), jnp.asarray(edges),
                                  jcfg)
        return j_gnn.softmax_ce(logits, jnp.asarray(labels),
                                jnp.asarray(mask)), logits

    (jl, jlogits), jg = jax.value_and_grad(j_loss, has_aux=True)(jp)
    leaves = [t.requires_grad_() for t in jax.tree.leaves(tp)]
    logits = t_gnn.apply_full(tp, _t(feats), _t(edges), tcfg)
    loss = t_gnn.softmax_ce(logits, _t(labels), _t(mask))
    _close(logits, jlogits)
    _close(loss, jl)
    for g, w in zip(torch.autograd.grad(loss, leaves), jax.tree.leaves(jg)):
        _close(g, w)


@pytest.mark.parametrize("aggregator", AGGREGATORS)
def test_apply_minibatch_and_grads_match_reference(aggregator):
    jcfg, tcfg = _cfg("mini", aggregator)
    jp, tp = _params(jcfg, 1)
    g = j_graph.synthetic_graph(60, 3, 12, 5, seed=4)
    block = j_graph.NeighborSampler(g, (4, 3), seed=5).sample_block(
        np.arange(0, 60, 6))
    block["hop2_mask"][0] = False  # a seed's whole second hop masked
    feats = [block[f"hop{j}_feats"] for j in range(3)]
    masks = [None] + [block[f"hop{j}_mask"] for j in (1, 2)]

    def j_loss(p):
        logits = j_gnn.apply_minibatch(
            p, [jnp.asarray(f) for f in feats],
            [None] + [jnp.asarray(m) for m in masks[1:]], jcfg)
        return j_gnn.softmax_ce(logits, jnp.asarray(block["labels"])), logits

    (jl, jlogits), jg = jax.value_and_grad(j_loss, has_aux=True)(jp)
    leaves = [t.requires_grad_() for t in jax.tree.leaves(tp)]
    logits = t_gnn.apply_minibatch(tp, [_t(f) for f in feats],
                                   [None] + [_t(m) for m in masks[1:]], tcfg)
    loss = t_gnn.softmax_ce(logits, _t(block["labels"]))
    _close(logits, jlogits)
    _close(loss, jl)
    for g, w in zip(torch.autograd.grad(loss, leaves), jax.tree.leaves(jg)):
        _close(g, w)


def _packed(seed, G=5, n=7, e=12, d=12):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(3, n + 1, G)
    feats = [rng.standard_normal((k, d)).astype(np.float32) for k in sizes]
    edges = [rng.integers(0, k, (2, rng.integers(4, e + 1))).astype(np.int32)
             for k in sizes]
    return feats, edges


def test_apply_batched_and_grads_match_reference():
    jcfg, tcfg = _cfg("batched", readout="graph")
    jp, tp = _params(jcfg, 2)
    f, e, m, gid = j_graph.pack_graphs(*_packed(6), 7, 12)
    labels, _ = _softmax_ce_both(7, 5, masked=False)

    def j_loss(p):
        logits = j_gnn.apply_batched(p, jnp.asarray(f), jnp.asarray(e),
                                     jnp.asarray(m), jnp.asarray(gid), 5, jcfg)
        return j_gnn.softmax_ce(logits, jnp.asarray(labels)), logits

    (jl, jlogits), jg = jax.value_and_grad(j_loss, has_aux=True)(jp)
    leaves = [t.requires_grad_() for t in jax.tree.leaves(tp)]
    logits = t_gnn.apply_batched(tp, _t(f), _t(e), _t(m), _t(gid), 5, tcfg)
    loss = t_gnn.softmax_ce(logits, _t(labels))
    _close(logits, jlogits)
    _close(loss, jl)
    for g, w in zip(torch.autograd.grad(loss, leaves), jax.tree.leaves(jg)):
        _close(g, w)


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_ce_and_grad_match_reference(masked):
    rng = np.random.default_rng(8)
    logits = (rng.standard_normal((20, 5)) * 3).astype(np.float32)
    labels, mask = _softmax_ce_both(9, 20, masked)
    jm = None if mask is None else jnp.asarray(mask)
    jl, jg = jax.value_and_grad(lambda x: j_gnn.softmax_ce(
        x, jnp.asarray(labels), jm))(jnp.asarray(logits))
    x = _t(logits).requires_grad_()
    loss = t_gnn.softmax_ce(x, _t(labels), None if mask is None else _t(mask))
    _close(loss, jl)
    _close(torch.autograd.grad(loss, x)[0], jg)


def test_graphsage_module_tree_and_init():
    """The module's tree is the reference's pytree structure; init gives
    its shapes and the reference's zero biases."""
    jcfg, tcfg = _cfg("full")
    specs = jax.eval_shape(lambda: j_gnn.init(jax.random.PRNGKey(0), jcfg))
    shapes = jax.tree.map(lambda a: tuple(a.shape), specs)
    model = t_gnn.init(tcfg, generator=torch.Generator().manual_seed(0),
                       device=CPU)
    tree = model.tree()
    assert jax.tree.map(lambda t: tuple(t.shape), tree) == shapes
    assert all(p.requires_grad for p in model.parameters())
    assert not tree["layers"][0]["b"].any()
    assert len(list(model.parameters())) == len(jax.tree.leaves(specs))


def test_graph_data_bitwise():
    jg = j_graph.synthetic_graph(500, 6, 10, 7, seed=3)
    tg = t_graph.synthetic_graph(500, 6, 10, 7, seed=3)
    for f in ("indptr", "indices", "feats", "labels"):
        a, b = getattr(jg, f), getattr(tg, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert np.array_equal(jg.edge_list(), tg.edge_list())
    js = j_graph.NeighborSampler(jg, (5, 4), seed=2)
    ts = t_graph.NeighborSampler(tg, (5, 4), seed=2)
    rng = np.random.default_rng(0)
    for _ in range(3):
        seeds = rng.choice(500, 16, replace=False)
        a, b = js.sample_block(seeds), ts.sample_block(seeds)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    feats, edges = _packed(11)
    for a, b in zip(j_graph.pack_graphs(feats, edges, 7, 12),
                    t_graph.pack_graphs(feats, edges, 7, 12)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("n_keys, size", [(5, 0), (1, 5), (7, 1000),
                                          (3000, 50_000), (2**40, 1000),
                                          (2**60, 1000)])
def test_stable_argsort_matches_numpy(n_keys, size):
    """The joined-key sort behind synthetic_graph's edge order (and its
    fallback past 62 bits) is numpy's stable argsort."""
    keys = np.random.default_rng(size).integers(0, n_keys, size)
    got = t_graph._stable_argsort(keys, n_keys)
    want = np.argsort(keys, kind="stable")
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("shape", list(j_cfg.SHAPE_CONFIGS))
def test_profile_gnn_bitwise(shape):
    j, t = j_cfg.SHAPE_CONFIGS[shape], t_cfg.SHAPE_CONFIGS[shape]
    for d_feat in (None, 33):
        a = j_profile_gnn(j, 25.0, d_feat)
        b = t_profile_gnn(t, 25.0, d_feat)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_configs_match_reference():
    mod = get_arch("graphsage-reddit")
    assert mod is t_cfg
    assert (mod.ARCH_ID, mod.KIND.value, [s.name for s in mod.SHAPES]) == \
        (j_cfg.ARCH_ID, j_cfg.KIND.value, [s.name for s in j_cfg.SHAPES])
    assert [dict(s.dims) for s in mod.SHAPES] == \
        [dict(s.dims) for s in j_cfg.SHAPES]
    pairs = [(t_cfg.FULL, j_cfg.FULL), (t_cfg.SMOKE, j_cfg.SMOKE)] + [
        (t_cfg.SHAPE_CONFIGS[k], j_cfg.SHAPE_CONFIGS[k])
        for k in j_cfg.SHAPE_CONFIGS]
    for t, j in pairs:
        for f in dataclasses.fields(j):
            if f.name != "dtype":
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.dtype == torch.float32


@pytest.mark.parametrize("mode", ["full", "mini", "batched"])
def test_input_specs_match_reference(mode):
    jcfg, tcfg = _cfg(mode)
    dims = {"n_nodes": 9, "n_edges": 20, "batch_nodes": 4, "fanout": (3, 2),
            "batch": 3}
    j = j_gnn.input_specs(jcfg, dims)
    t = t_gnn.input_specs(tcfg, dims)
    assert list(j) == list(t)
    for k in j:
        assert tuple(j[k].shape) == t[k].shape, k
