"""The port's DLRM against the reference's ``dlrm.apply`` on carried-across
parameters: the dlrm-rm2 SMOKE config and dlrm-rmc1 / dlrm-rmc3 at their
published widths with vocabularies cut to 1000 rows.

Logits use 1e-4: XLA-CPU and torch sum the matrix products in different
orders, which moves f32 logits by more than the kernel tolerance of 1e-5.
The bf16 case uses the bf16 tolerance, 3e-2."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm_rm2 as j_rm2
from repro.configs import paper_models as j_pm
from repro.data.clicklog import ClickLogGenerator as JClickLog
from repro.models import dlrm as jdlrm
from repro.models import recsys_base as jbase
from repro_torch.configs import dlrm_rm2 as t_rm2
from repro_torch.configs import paper_models as t_pm
from repro_torch.models import dlrm as tdlrm
from repro_torch.models import recsys_base as tbase

CPU = torch.device("cpu")
LOGIT_TOL = 1e-4


def _cut(cfg, rows=1000):
    emb = dataclasses.replace(cfg.embedding,
                              vocab_sizes=(rows,) * cfg.embedding.num_features)
    return dataclasses.replace(cfg, embedding=emb)


CONFIGS = {
    "dlrm-rm2-smoke": (j_rm2.SMOKE, t_rm2.SMOKE),
    "dlrm-rmc1-cut": (_cut(j_pm.rmc1(True)), _cut(t_pm.rmc1(True))),
    "dlrm-rmc3-cut": (_cut(j_pm.rmc3(True)), _cut(t_pm.rmc3(True))),
}


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(jcfg, tcfg, seed=0):
    jparams = jdlrm.init(jax.random.PRNGKey(seed), jcfg)
    model = tdlrm.DLRM(tcfg, tdlrm.params_from_reference(_tree_np(jparams),
                                                         device=CPU))
    return jparams, model


def _batch(jcfg, n=48, seed=2):
    return JClickLog(jcfg, seed=seed).batch(n, with_labels=False)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_logits_match_reference(name):
    jcfg, tcfg = CONFIGS[name]
    jparams, model = _pair(jcfg, tcfg)
    batch = _batch(jcfg)
    want = jdlrm.apply(jparams, jax.tree.map(jnp.asarray, batch), jcfg)
    with torch.inference_mode():
        got = model(tbase.batch_to_tensors(batch, CPU))
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    # the SparseNet alone (K1's path) holds the kernel tolerance
    pooled_j = jdlrm.apply_sparse(jparams, jax.tree.map(jnp.asarray, batch), jcfg)
    with torch.inference_mode():
        pooled_t = model.apply_sparse(tbase.batch_to_tensors(batch, CPU))
    np.testing.assert_allclose(pooled_t.numpy(), np.asarray(pooled_j),
                               rtol=1e-5, atol=1e-5)


def test_bf16_logits_match_reference():
    def bf16(cfg, dtype):
        emb = dataclasses.replace(cfg.embedding, dtype=dtype)
        return dataclasses.replace(cfg, embedding=emb, dtype=dtype)

    jcfg, tcfg = bf16(j_rm2.SMOKE, jnp.bfloat16), bf16(t_rm2.SMOKE, torch.bfloat16)
    jparams, model = _pair(jcfg, tcfg, seed=1)
    assert model.table.dtype == torch.bfloat16
    assert model.top_mlp.w[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        model.table.detach().float().numpy(),
        np.asarray(jparams["embedding"]["table"], np.float32))
    batch = _batch(jcfg)
    want = jdlrm.apply(jparams, jax.tree.map(jnp.asarray, batch), jcfg)
    with torch.inference_mode():
        got = model(tbase.batch_to_tensors(batch, CPU))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=3e-2, atol=3e-2)


def test_dot_interaction_pair_order():
    rng = np.random.default_rng(4)
    v = rng.standard_normal((3, 5, 8)).astype(np.float32)
    got = tdlrm.dot_interaction(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, np.asarray(jdlrm.dot_interaction(jnp.asarray(v))),
                               rtol=1e-5, atol=1e-5)
    iu, ju = np.triu_indices(5, k=1)
    want = np.einsum("bpd,bpd->bp", v[:, iu], v[:, ju])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert list(zip(iu[:4], ju[:4])) == [(0, 1), (0, 2), (0, 3), (0, 4)]


def test_init_matches_reference_shapes():
    for name, (jcfg, tcfg) in CONFIGS.items():
        jp = jax.eval_shape(lambda: jdlrm.init(jax.random.PRNGKey(0), jcfg))
        model = tdlrm.init(tcfg, generator=torch.Generator().manual_seed(0),
                           device=CPU)
        assert tuple(model.table.shape) == jp["embedding"]["table"].shape, name
        for mod, key in ((model.bottom_mlp, "bottom_mlp"), (model.top_mlp, "top_mlp")):
            got = [(tuple(l["w"].shape), tuple(l["b"].shape)) for l in mod.layers()]
            assert got == [(l["w"].shape, l["b"].shape) for l in jp[key]], name


def test_input_specs_and_binary_ce_match_reference():
    for jcfg, tcfg in CONFIGS.values():
        for kw in ({}, {"with_labels": True}):
            js = jbase.input_specs(jcfg, 16, **kw)
            ts = tbase.input_specs(tcfg, 16, **kw)
            assert {k: (tuple(v.shape), jnp.dtype(v.dtype).name) for k, v in js.items()} \
                == {k: (s, str(d).removeprefix("torch.")) for k, (s, d) in ts.items()}
    rng = np.random.default_rng(5)
    logits = rng.standard_normal(32).astype(np.float32) * 4
    labels = (rng.random(32) < 0.3).astype(np.float32)
    want = float(jbase.binary_ce(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(tbase.binary_ce(torch.from_numpy(logits), torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-6


def test_params_from_reference_keeps_dtype_and_values():
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": [np.asarray(jnp.asarray([1.5, -2.25], jnp.bfloat16))]}
    out = tdlrm.params_from_reference(tree, device=CPU)
    assert out["a"].dtype == torch.float32
    assert torch.equal(out["a"], torch.arange(6.0).reshape(2, 3))
    assert out["b"][0].dtype == torch.bfloat16
    assert out["b"][0].float().tolist() == [1.5, -2.25]


def test_common_initializers_devices_and_dtypes():
    from repro.common.types import dtype_of as j_dtype_of
    from repro_torch.common import init as tinit
    from repro_torch.common.types import dtype_of, resolve_device

    for name in ("bf16", "f32", "f16", "i32", "i64", "bool"):
        assert str(dtype_of(name)).removeprefix("torch.") == jnp.dtype(j_dtype_of(name)).name
    with pytest.raises(ValueError):
        dtype_of("f8")
    assert resolve_device("cpu") == CPU
    g = torch.Generator().manual_seed(0)
    shape = (400, 300)
    he = tinit.he_init(shape, generator=g, device=CPU)
    assert abs(he.std().item() - np.sqrt(2.0 / 400)) < 0.05 * np.sqrt(2.0 / 400)
    xa = tinit.xavier_init(shape, generator=g, device=CPU, dtype=torch.bfloat16)
    assert xa.dtype == torch.bfloat16
    assert xa.float().abs().max().item() <= np.sqrt(6.0 / 700) * 1.01
    emb = tinit.embedding_init(shape, generator=g, device=CPU)
    assert emb.abs().max().item() <= 1.0 / np.sqrt(400)
    nrm = tinit.normal_init(shape, generator=g, device=CPU, stddev=0.02)
    assert abs(nrm.std().item() - 0.02) < 0.001
