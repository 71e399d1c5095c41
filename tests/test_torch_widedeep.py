"""The port's Wide & Deep and MT-WnD (``repro_torch.models.widedeep``)
against the reference's ``widedeep.apply`` on carried-across parameters:
the wide-deep SMOKE config and mt-wnd at its published widths (26 one-hot
features, dim 32, deep MLP 1024-512-256) with vocabularies cut to 3,000
rows, with 5 task towers and with 1.

Tolerances: the pooled deep and wide embeddings (K1's path) 1e-5, the
kernel tolerance of tests/test_kernels.py; logits 1e-4, since XLA-CPU and
torch sum the matrix products in other orders (as tests/test_torch_dlrm.py).
Both scale with the largest value compared, so small outputs are not waved
through."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_models as j_pm
from repro.configs import wide_deep as j_wd
from repro.data.clicklog import ClickLogGenerator
from repro.models import widedeep as jwnd
from repro_torch.configs import paper_models as t_pm
from repro_torch.configs import wide_deep as t_wd
from repro_torch.models import embedding as t_emb
from repro_torch.models import widedeep as twnd
from repro_torch.models.recsys_base import batch_to_tensors

from test_torch_din import close
from torch_recsys_util import cut_vocab

CPU = torch.device("cpu")
LAYER_TOL = 1e-5
LOGIT_TOL = 1e-4


CONFIGS = {
    "wide-deep-smoke": (j_wd.SMOKE, t_wd.SMOKE),
    "mt-wnd-cut-5-tasks": (cut_vocab(j_pm.mt_wnd(True)), cut_vocab(t_pm.mt_wnd(True))),
    "mt-wnd-cut-1-task": (cut_vocab(j_pm.mt_wnd(True, n_tasks=1)),
                          cut_vocab(t_pm.mt_wnd(True, n_tasks=1))),
}


def _pair(jcfg, tcfg, seed=0):
    jparams = jwnd.init(jax.random.PRNGKey(seed), jcfg)
    model = twnd.WideDeep(tcfg, twnd.params_from_reference(
        jax.tree.map(np.asarray, jparams), device=CPU))
    return jparams, model


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_logits_match_reference(name):
    jcfg, tcfg = CONFIGS[name]
    jparams, model = _pair(jcfg, tcfg)
    batch = ClickLogGenerator(jcfg, seed=2).batch(48, with_labels=False)
    jbatch = jax.tree.map(jnp.asarray, batch)
    want = jwnd.apply(jparams, jbatch, jcfg)
    tb = batch_to_tensors(batch, CPU)
    with torch.inference_mode():
        got = model(tb)
        deep, wide = model.apply_sparse(tb)
    assert got.shape == ((48,) if jcfg.n_tasks == 1 else (48, jcfg.n_tasks))
    close(got.numpy(), want, LOGIT_TOL)
    jdeep, jwide = jwnd.apply_sparse(jparams, jbatch, jcfg)
    assert wide.shape == (48, jcfg.embedding.num_features, 1)
    close(deep.numpy(), jdeep, LAYER_TOL)
    close(wide.numpy(), jwide, LAYER_TOL)


def test_sparse_part_is_two_k1_calls(monkeypatch):
    """``apply_sparse`` pools the deep and the wide table through K1's
    per-feature entry, one call each (on a card, one launch each)."""
    jcfg, tcfg = CONFIGS["mt-wnd-cut-5-tasks"]
    _, model = _pair(jcfg, tcfg)
    calls = []
    entry = t_emb.embedding_bag_features

    def counted(table, ids, offsets):
        calls.append((tuple(table.shape), tuple(ids.shape)))
        return entry(table, ids, offsets)

    monkeypatch.setattr(t_emb, "embedding_bag_features", counted)
    batch = ClickLogGenerator(jcfg, seed=3).batch(8, with_labels=False)
    with torch.inference_mode():
        model(batch_to_tensors(batch, CPU))
    rows = tcfg.embedding.total_rows
    assert calls == [((rows, 32), (8, 26, 1)), ((rows, 1), (8, 26, 1))]


def test_wide_cfg_and_init_match_reference():
    for name, (jcfg, tcfg) in CONFIGS.items():
        jwide, twide = jwnd._wide_cfg(jcfg), twnd._wide_cfg(tcfg)
        assert (twide.dim, twide.total_rows) == (jwide.dim, jwide.total_rows)
        jp = jax.eval_shape(lambda: jwnd.init(jax.random.PRNGKey(0), jcfg))
        model = twnd.init(tcfg, generator=torch.Generator().manual_seed(0),
                          device=CPU)
        assert tuple(model.table.shape) == jp["embedding"]["table"].shape, name
        assert tuple(model.wide.shape) == jp["wide"]["table"].shape, name
        assert tuple(model.wide_dense.shape) == jp["wide_dense"].shape
        assert not model.wide_dense.any()
        got = [(tuple(l["w"].shape), tuple(l["b"].shape))
               for l in model.deep_mlp.layers()]
        assert got == [(l["w"].shape, l["b"].shape) for l in jp["deep_mlp"]]
        assert len(model.towers) == len(jp["towers"]) == jcfg.n_tasks
        for tower, jt in zip(model.towers, jp["towers"]):
            assert [tuple(l["w"].shape) for l in tower.layers()] == \
                [l["w"].shape for l in jt]
