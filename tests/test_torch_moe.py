"""The port's mixture of experts against the reference: ``init_moe``'s
shapes and zero padding, ``moe_router`` (top-k, weights, aux loss and
their gradients), ``dispatch_indices`` bitwise (an expert window, a
capacity that drops), ``moe_apply_grouped`` / ``moe_apply`` and
``apply_moe_dense`` on carried-across parameters, and the reference's own
``TestMoE`` cases (tests/test_models.py) on the port.

Tolerances: f32 1e-5 scaled by the largest value (the reference's TestMoE
holds grouped against dense at 1e-4 / 1e-5); the dispatch bitwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import moe as j_moe
from repro.models import layers as j_layers
from repro_torch.common.convert import tree_from_numpy
from repro_torch.dist import moe as t_moe
from repro_torch.models import layers as t_layers

CPU = torch.device("cpu")
TOL = 1e-5
KW = dict(d_model=32, d_ff=16, n_experts=6, top_k=2, n_shared=1,
          shared_d_ff=48, capacity_factor=8.0, pad_to=4)
J_CFG, T_CFG = j_layers.MoEConfig(**KW), t_layers.MoEConfig(**KW)


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _params(seed=0, jcfg=J_CFG):
    jp = j_layers.init_moe(jax.random.PRNGKey(seed), jcfg)
    return jp, tree_from_numpy(jax.tree.map(np.asarray, jp), CPU)


def _x(n, seed=1):
    x = np.random.default_rng(seed).standard_normal((n, 32)).astype(
        np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def test_init_moe_shapes_and_padding():
    tp = t_layers.init_moe(T_CFG, generator=torch.Generator().manual_seed(0),
                           device=CPU)
    jp = jax.eval_shape(lambda: j_layers.init_moe(jax.random.PRNGKey(0),
                                                  J_CFG))
    assert jax.tree.map(lambda t: tuple(t.shape), tp) == \
        jax.tree.map(lambda a: tuple(a.shape), jp)
    assert T_CFG.n_experts_padded == 8 and tp["router"].dtype == torch.float32
    for w in tp["experts"].values():
        assert w.shape[0] == 8 and bool((w[6:] == 0).all())
        assert bool((w[:6] != 0).any(dim=(1, 2)).all())
    stacked = t_layers.init_moe(T_CFG, generator=torch.Generator(),
                                device=CPU, dtype=torch.bfloat16, stack=(3,))
    assert tuple(stacked["experts"]["w_down"].shape) == (3, 8, 16, 32)
    assert bool((stacked["experts"]["w_gate"][:, 6:] == 0).all())
    assert stacked["router"].dtype == torch.float32
    assert stacked["shared"]["w_up"].dtype == torch.bfloat16


def test_moe_router_matches_reference():
    jp, tp = _params()
    jx, tx = _x(40)

    def jfn(p, x):
        idx, w, aux = j_layers.moe_router(p, x, J_CFG)
        return (w * jnp.arange(1.0, 3.0)).sum() + aux, (idx, w, aux)

    (_, (jidx, jw, jaux)), jg = jax.value_and_grad(jfn, has_aux=True)(jp, jx)
    tp["router"].requires_grad_(True)
    tidx, tw, taux = t_layers.moe_router(tp, tx, T_CFG)
    (g,) = torch.autograd.grad((tw * torch.arange(1.0, 3.0)).sum() + taux,
                               tp["router"])
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    _close(tw, jw)
    _close(taux, jaux)
    _close(g, jg["router"])


@pytest.mark.parametrize("n,capacity,window", [
    (48, 32, (0, 8)),      # everything fits
    (64, 8, (0, 8)),       # capacity drops (position priority)
    (64, 8, (2, 3)),       # a window of experts, with drops
    (5, 16, (4, 4)),       # a window holding only the padded experts
])
def test_dispatch_indices_bitwise(n, capacity, window):
    rng = np.random.default_rng(n + capacity)
    # a skewed routing so that the first experts oversubscribe
    topk = np.stack([rng.permutation(6)[:2] for _ in range(n)]).astype(
        np.int32)
    topk[: n // 2, 0] = 0
    e_start, e_count = window
    want = j_moe.dispatch_indices(jnp.asarray(topk), 8, capacity, e_start,
                                  e_count)
    got = t_moe.dispatch_indices(torch.from_numpy(topk), 8, capacity,
                                 e_start, e_count)
    for g, w in zip(got, want):
        assert g.dtype == {np.dtype(np.int32): torch.int32,
                           np.dtype(bool): torch.bool}[np.asarray(w).dtype]
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if capacity == 8:
        assert bool((got[2] < 0).any())        # something dropped


def test_expert_capacity_matches_reference():
    for n in (1, 7, 48, 1000):
        assert t_moe.expert_capacity(n, T_CFG) == \
            j_moe.expert_capacity(n, J_CFG)


@pytest.mark.parametrize("capacity", [None, 8])
def test_moe_apply_matches_reference(capacity):
    jp, tp = _params(seed=2)
    jx, tx = _x(48, seed=3)
    want, jaux = j_moe.moe_apply_grouped(jp, jx, J_CFG, capacity=capacity)
    got, aux = t_moe.moe_apply_grouped(tp, tx, T_CFG, capacity=capacity)
    _close(got, want)
    _close(aux, jaux)
    want, jaux = j_moe.moe_apply(jp, jx, J_CFG)
    got, aux = t_moe.moe_apply(tp, tx, T_CFG)
    _close(got, want)
    _close(aux, jaux)
    want, _ = j_layers.apply_moe_dense(jp, jx, J_CFG)
    got, _ = t_layers.apply_moe_dense(tp, tx, T_CFG)
    _close(got, want)


def test_moe_apply_gradients_match_reference():
    jp, tp = _params(seed=4)
    jx, tx = _x(32, seed=5)

    def jloss(p, x):
        out, aux = j_moe.moe_apply(p, x, J_CFG)
        return (out * out).sum() + aux

    jg = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    leaves = jax.tree.leaves(tp)
    for t in leaves + [tx]:
        t.requires_grad_(True)
    out, aux = t_moe.moe_apply(tp, tx, T_CFG)
    grads = torch.autograd.grad((out * out).sum() + aux, leaves + [tx])
    want = jax.tree.leaves(jg[0]) + [jg[1]]
    for g, w in zip(grads, want):
        _close(g, w)


# the reference's TestMoE (tests/test_models.py), on the port


def test_grouped_matches_dense():
    _, p = _params()
    _, x = _x(48)
    want, _ = t_layers.apply_moe_dense(p, x, T_CFG)
    got, _ = t_moe.moe_apply_grouped(p, x, T_CFG)
    got = got + t_layers.apply_swiglu(p["shared"], x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_expert_partials_sum_to_full():
    _, p = _params()
    _, x = _x(32)
    full, _ = t_moe.moe_apply_grouped(p, x, T_CFG, capacity=64)
    lo, _ = t_moe.moe_apply_grouped(p, x, T_CFG, e_start=0, e_count=4,
                                    capacity=64)
    hi, _ = t_moe.moe_apply_grouped(p, x, T_CFG, e_start=4, e_count=4,
                                    capacity=64)
    np.testing.assert_allclose((lo + hi).numpy(), full.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_capacity_drops_are_bounded():
    """With tiny capacity, output is a damped version, never NaN."""
    _, p = _params()
    _, x = _x(64)
    out, _ = t_moe.moe_apply_grouped(p, x, T_CFG, capacity=8)
    assert bool(torch.isfinite(out).all())
