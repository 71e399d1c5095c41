"""The port's optimizers (``repro_torch.train.optimizer``) against the
reference's ``repro.train.optimizer``: three updates from the same
parameters with the same gradients (made with numpy), on pytrees with
float32 and bfloat16 leaves, a 2-D ``table`` and a ``wide/table`` (the
embedding-path rule), a 2-D weight that is no table and a vector.

Tolerances: float32 1e-6, bfloat16 3e-2 (the two frameworks round bf16
at other places), each relative and scaled by the largest value; both
sides start from the same bf16 values.  ``rowwise_adagrad``'s chunked
table update is bitwise its unchunked one, and a row whose gradient is
zero comes out bitwise unchanged."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.train import optimizer as j_opt
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.train import optimizer as t_opt

TOL = {"f32": 1e-6, "bf16": 3e-2}
NP_DT = {"f32": np.float32, "bf16": ml_dtypes.bfloat16}
T_DT = {"f32": torch.float32, "bf16": torch.bfloat16}

OPTIMIZERS = {
    "sgd": dict(lr=0.05),
    "sgd_momentum": dict(lr=0.05, momentum=0.9),
    "adamw": dict(lr=1e-2, weight_decay=0.1),
    "rowwise_adagrad": dict(lr=0.05),
}


def _make(name):
    kw = OPTIMIZERS[name]
    base = "sgd" if name.startswith("sgd") else name
    return getattr(j_opt, base)(**kw), getattr(t_opt, base)(**kw)


def _tree(rng, dtype):
    """Parameters as numpy (in ``dtype``): the reference's shapes of an
    embedding table, a wide table, MLP layers and a GNN-style vector."""
    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32).astype(
            NP_DT[dtype])
    return {"embedding": {"table": arr(40, 8)},
            "wide": {"table": arr(40, 1)},
            "mlp": [{"w": arr(6, 5), "b": arr(5)}, {"w": arr(5, 1),
                                                     "b": arr(1)}],
            "S": arr(4, 4)}


def _grads(rng, tree, zero_rows=(3, 17)):
    """Gradients like the parameters; rows ``zero_rows`` of both tables
    are exactly zero (rows no id read)."""
    g = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.3).astype(
        np.float32).astype(a.dtype), tree)
    for key in ("embedding", "wide"):
        g[key]["table"][list(zero_rows)] = 0
    return g


def _to_torch(tree):
    def conv(a):
        a = np.asarray(a)
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.uint16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    return jax.tree.map(conv, tree)


def _np(t):
    return t.float().numpy()


def _close(got_tree, want_tree, dtype):
    for got, want in zip(tree_leaves(got_tree), jax.tree.leaves(want_tree)):
        want = np.asarray(want, np.float32)
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(_np(got), want, rtol=TOL[dtype],
                                   atol=TOL[dtype] * scale)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_three_updates_match_reference(name, dtype):
    rng = np.random.default_rng(len(name))
    params = _tree(rng, dtype)
    grads = [_grads(rng, params) for _ in range(3)]
    j, t = _make(name)
    jp = jax.tree.map(jnp.asarray, params)
    js = j.init(jp)
    tp = _to_torch(params)
    ts = t.init(tp)
    for g in grads:
        jp, js = j.update(jp, jax.tree.map(jnp.asarray, g), js)
        tp_out, ts = t.update(tp, _to_torch(g), ts)
        assert tp_out is tp  # updated in place
    _close(tp, jp, dtype)
    assert all(a.dtype == T_DT[dtype] for a in tree_leaves(tp))
    if name == "rowwise_adagrad":
        assert tuple(ts["acc"]["embedding"]["table"].shape) == (40, 1)
        assert tuple(ts["acc"]["wide"]["table"].shape) == (40, 1)
        assert tuple(ts["acc"]["mlp"][0]["w"].shape) == (6, 5)
        assert tuple(ts["acc"]["S"].shape) == (4, 4)
        _close(ts["acc"], js["acc"], "f32")
    if name == "adamw":
        assert int(ts["step"]) == int(js["step"]) == 3
        assert all(m.dtype == torch.float32 for m in tree_leaves(ts["m"]))
        _close(ts["m"], js["m"], "f32")
        _close(ts["v"], js["v"], "f32")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rowwise_adagrad_chunked_bitwise_and_zero_rows(dtype, monkeypatch):
    """Chunks of 3 rows (a last chunk of 1) give the unchunked update
    bitwise; the rows with zero gradient are bitwise unchanged."""
    rng = np.random.default_rng(9)
    params = _tree(rng, dtype)
    grads = _to_torch(_grads(rng, params))
    opt = t_opt.rowwise_adagrad(lr=0.05)
    whole = _to_torch(params)
    opt.update(whole, grads, opt.init(whole))
    monkeypatch.setattr(t_opt, "CHUNK_ELEMENTS", 3 * 8)
    chunked = _to_torch(params)
    opt.update(chunked, grads, opt.init(chunked))
    for a, b in zip(tree_leaves(whole), tree_leaves(chunked)):
        assert torch.equal(a, b)
    before = _to_torch(params)
    for key in ("embedding", "wide"):
        got = chunked[key]["table"]
        want = before[key]["table"]
        assert torch.equal(got[[3, 17]], want[[3, 17]])
        assert not torch.equal(got[[4]], want[[4]])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_adamw_chunked_bitwise(dtype, monkeypatch):
    """adamw in chunks of rows (3-D and 2-D leaves cut mid-way, a vector,
    a 0-d leaf) gives the unchunked update bitwise, over two steps."""
    rng = np.random.default_rng(10)
    params = {**_tree(rng, dtype),
              "stack": rng.standard_normal((5, 3, 4)).astype(np.float32)
              .astype(NP_DT[dtype]),
              "scalar": np.asarray(0.5, np.float32).astype(NP_DT[dtype])}
    grads = [_to_torch(jax.tree.map(lambda a: (rng.standard_normal(
        a.shape) * 0.3).astype(np.float32).astype(a.dtype), params))
        for _ in range(2)]
    opt = t_opt.adamw(lr=1e-2, weight_decay=0.1)
    out = []
    for chunk in (None, 2 * 12):           # 2 rows of the [5, 3, 4] leaf
        if chunk:
            monkeypatch.setattr(t_opt, "CHUNK_ELEMENTS", chunk)
        p = _to_torch(params)
        state = opt.init(p)
        for g in grads:
            opt.update(p, g, state)
        out.append((p, state))
    (p0, s0), (p1, s1) = out
    for a, b in zip(tree_leaves((p0, s0)), tree_leaves((p1, s1))):
        assert torch.equal(a, b)


def test_tree_helpers():
    tree = {"a": [torch.ones(2), torch.zeros(1)], "b": {"c": torch.ones(3)}}
    assert [tuple(t.shape) for t in tree_leaves(tree)] == [(2,), (1,), (3,)]
    doubled = tree_map(lambda x, y: x + y, tree, tree)
    assert float(doubled["b"]["c"].sum()) == 6.0
