"""The port's MIND (``repro_torch.models.mind``) against the reference's
``mind`` on carried-across parameters: the mind SMOKE config, ``squash``,
the dynamic routing (``interest_capsules``), ``apply`` and
``retrieval_scores``; and the QR item lookup (the reference reads past a
QR item table's storage and gives non-finite scores; the port equals the
reference with its item lookup replaced by the reference's own QR rule).

At the reference's init the item rows are U(-0.01, 0.01), so the capsules
are short and ``squash`` shrinks them to scores of ~1e-7; the cases run
there and with the item table scaled by 30 (scores of order 1, where
``squash`` saturates).  Tolerances: layers 1e-5, scores 1e-4 (XLA-CPU and
torch sum the products in other orders), both scaled by the largest value
compared, so the small scores are held relative to their size."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.mind as jmind_mod
from repro.configs import mind_arch as j_mind
from repro.data.clicklog import ClickLogGenerator
from repro.models import mind as jmind
from repro_torch.configs import mind_arch as t_mind
from repro_torch.models import mind as tmind
from repro_torch.models.recsys_base import batch_to_tensors

from test_torch_din import close, qr_item_lookup

CPU = torch.device("cpu")
LAYER_TOL = 1e-5
LOGIT_TOL = 1e-4
SCALES = [1.0, 30.0]


def _pair(jcfg, tcfg, scale=1.0, seed=0):
    jparams = jmind.init(jax.random.PRNGKey(seed), jcfg)
    jparams["embedding"]["table"] = jparams["embedding"]["table"] * scale
    model = tmind.MIND(tcfg, tmind.params_from_reference(
        jax.tree.map(np.asarray, jparams), device=CPU))
    return jparams, model


def _batches(jcfg, n=24, seed=2):
    batch = ClickLogGenerator(jcfg, seed=seed).batch(n, with_labels=False)
    return jax.tree.map(jnp.asarray, batch), batch_to_tensors(batch, CPU)


def test_squash_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 4, 16)).astype(np.float32)
    x[0] *= 1e-4  # short vectors: the eps regime
    for axis in (-1, 1):
        close(tmind.squash(torch.from_numpy(x), dim=axis).numpy(),
              jmind.squash(jnp.asarray(x), axis=axis), LAYER_TOL)


@pytest.mark.parametrize("scale", SCALES)
def test_interest_capsules_match_reference(scale):
    jparams, model = _pair(j_mind.SMOKE, t_mind.SMOKE, scale)
    jb, tb = _batches(j_mind.SMOKE)
    want = jmind.interest_capsules(jparams, jb["history_ids"], j_mind.SMOKE)
    got = tmind.interest_capsules(model.tree(), tb["history_ids"], t_mind.SMOKE)
    assert got.shape == (24, 4, 16)
    close(got.detach().numpy(), want, LAYER_TOL)


@pytest.mark.parametrize("scale", SCALES)
def test_logits_match_reference(scale):
    jparams, model = _pair(j_mind.SMOKE, t_mind.SMOKE, scale)
    jb, tb = _batches(j_mind.SMOKE)
    want = jmind.apply(jparams, jb, j_mind.SMOKE)
    with torch.inference_mode():
        got = model(tb)
    close(got.numpy(), want, LOGIT_TOL)


@pytest.mark.parametrize("scale", SCALES)
def test_retrieval_scores_match_reference(scale):
    jparams, model = _pair(j_mind.SMOKE, t_mind.SMOKE, scale)
    jb, tb = _batches(j_mind.SMOKE, n=3, seed=4)
    cand = np.random.default_rng(5).integers(0, 10_000, 300).astype(np.int32)
    want = jmind.retrieval_scores(jparams, jb, jnp.asarray(cand), j_mind.SMOKE)
    with torch.inference_mode():
        got = model.retrieval_scores(tb, torch.from_numpy(cand))
    assert got.shape == (3, 300)
    close(got.numpy(), want, LOGIT_TOL)


def test_init_matches_reference_shapes():
    jp = jax.eval_shape(lambda: jmind.init(jax.random.PRNGKey(0), j_mind.SMOKE))
    model = tmind.init(t_mind.SMOKE, generator=torch.Generator().manual_seed(0),
                       device=CPU)
    assert jax.tree.map(lambda a: tuple(a.shape), model.tree()) == \
        jax.tree.map(lambda s: tuple(s.shape), jp)


def _qr(cfg):
    """mind SMOKE with its item table QR-compressed: 100,000 ids in
    ceil(100000/64) + 64 = 1,627 stored rows."""
    emb = dataclasses.replace(cfg.embedding, vocab_sizes=(100_000, 1_000),
                              qr_features=(0,), qr_buckets=64)
    return dataclasses.replace(cfg, embedding=emb)


def test_qr_item_table_reference_fault_and_port(monkeypatch):
    jcfg, tcfg = _qr(j_mind.SMOKE), _qr(t_mind.SMOKE)
    jparams, model = _pair(jcfg, tcfg, scale=30.0)
    jb, tb = _batches(jcfg, n=32, seed=1)
    hist = np.asarray(jb["history_ids"])
    assert (hist >= jcfg.embedding.total_rows).any()  # ids past the table

    assert not np.isfinite(np.asarray(jmind.apply(jparams, jb, jcfg))).all()

    monkeypatch.setattr(jmind_mod, "_item_lookup", qr_item_lookup)
    want = jmind.apply(jparams, jb, jcfg)
    with torch.inference_mode():
        got = model(tb)
    close(got.numpy(), want, LOGIT_TOL)
