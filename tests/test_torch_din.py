"""The port's DIN and DIEN (``repro_torch.models.din``) against the
reference's ``din`` on carried-across parameters: the din SMOKE config (and
DIEN on it), and ``din(False)`` / ``dien(False)`` with vocabularies cut to
3,000 rows and ``seq_len`` kept at 200, so the GRU and the AUGRU run their
full length; the attention unit, the GRU cell, the AUGRU, the recurrence
and ``retrieval_scores`` alone.

The QR item lookup: on a DIN config whose item table is QR-compressed, the
reference's ``din.apply`` adds ``row_offsets[0]`` to the raw item id, reads
past the stored rows and gives non-finite logits; the port equals the
reference with its item lookup replaced by the reference's own QR rule
(``embedding._gather_with_qr`` for feature 0).

Tolerances: layers and GRU states 1e-5 (the kernel tolerance of
tests/test_kernels.py; the port's recurrence computes the input
projections of all steps in one product and ``lerp``s the update, other
f32 orders that stay within 1e-6 over 200 steps); logits 1e-4, as for the
DLRM (XLA-CPU and torch sum the matrix products in other orders).  Both
scale with the largest value compared, so small outputs are not waved
through."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.din as jdin_mod
from repro.configs import din_arch as j_din
from repro.configs import paper_models as j_pm
from repro.data.clicklog import ClickLogGenerator
from repro.models import din as jdin
from repro.models import embedding as j_emb
from repro_torch.common.convert import tree_from_numpy
from repro_torch.configs import din_arch as t_din
from repro_torch.configs import paper_models as t_pm
from repro_torch.models import din as tdin
from repro_torch.models.recsys_base import batch_to_tensors
from torch_recsys_util import cut_vocab

CPU = torch.device("cpu")
LAYER_TOL = 1e-5
LOGIT_TOL = 1e-4


def _cut(cfg):
    return cut_vocab(cfg, qr_features=())


def _gru(cfg):
    return dataclasses.replace(cfg, use_gru=True)


CONFIGS = {
    "din-smoke": (j_din.SMOKE, t_din.SMOKE),
    "dien-smoke": (_gru(j_din.SMOKE), _gru(t_din.SMOKE)),
    "din-cut-T200": (_cut(j_pm.din(False)), _cut(t_pm.din(False))),
    "dien-cut-T200": (_cut(j_pm.dien(False)), _cut(t_pm.dien(False))),
}


def close(got, want, tol):
    """Within ``tol`` elementwise and ``tol`` x the largest value compared;
    finite."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()), 1e-30))


def _pair(jcfg, tcfg, seed=0):
    jparams = jdin.init(jax.random.PRNGKey(seed), jcfg)
    model = tdin.DIN(tcfg, tdin.params_from_reference(
        jax.tree.map(np.asarray, jparams), device=CPU))
    return jparams, model


def _batches(jcfg, n=32, seed=2):
    batch = ClickLogGenerator(jcfg, seed=seed).batch(n, with_labels=False)
    return jax.tree.map(jnp.asarray, batch), batch_to_tensors(batch, CPU)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_logits_match_reference(name):
    jcfg, tcfg = CONFIGS[name]
    jparams, model = _pair(jcfg, tcfg)
    jb, tb = _batches(jcfg)
    assert tb["history_ids"].shape[1] == jcfg.seq_len
    want = jdin.apply(jparams, jb, jcfg)
    with torch.inference_mode():
        got = model(tb)
    close(got.numpy(), want, LOGIT_TOL)


def _embedded(jcfg, jparams, jb):
    hist = jb["history_ids"]
    mask = hist >= 0
    hist_emb = jdin._item_lookup(jparams, hist, jcfg) * mask[..., None]
    target = jdin._item_lookup(jparams, jb["target_id"], jcfg)
    return hist_emb, target, mask


def test_attention_scores_match_reference():
    jcfg, tcfg = CONFIGS["din-cut-T200"]
    jparams, model = _pair(jcfg, tcfg)
    jb, _ = _batches(jcfg)
    hist_emb, target, mask = _embedded(jcfg, jparams, jb)
    want = jdin.attention_scores(jparams, hist_emb, target, mask, jcfg)
    got = tdin.attention_scores(
        model.tree(), *(torch.from_numpy(np.array(a))
                        for a in (hist_emb, target, mask)), tcfg)
    close(got.detach().numpy(), want, LAYER_TOL)
    assert not got.detach().numpy()[~np.asarray(mask)].any()  # masked: 0


def _gru_params(seed, d=18, scale=6.0):
    """Reference GRU gates with weights 6x their init (so the gates leave
    their linear range), as numpy and as tensors."""
    jp = jax.tree.map(lambda a: np.asarray(a) * scale,
                      jdin._init_gru(jax.random.PRNGKey(seed), d, d))
    return jax.tree.map(jnp.asarray, jp), tree_from_numpy(jp, CPU)


@pytest.mark.parametrize("augru", [False, True])
def test_gru_cell_matches_reference(augru):
    jp, tp = _gru_params(1)
    rng = np.random.default_rng(3)
    h, x = (rng.standard_normal((64, 18)).astype(np.float32) for _ in range(2))
    a = rng.random(64).astype(np.float32) if augru else None
    want = jdin._gru_cell(jp, jnp.asarray(h), jnp.asarray(x),
                          None if a is None else jnp.asarray(a))
    got = tdin._gru_cell(tp, torch.from_numpy(h), torch.from_numpy(x),
                         None if a is None else torch.from_numpy(a))
    close(got.numpy(), want, LAYER_TOL)


@pytest.mark.parametrize("augru", [False, True])
def test_gru_recurrence_matches_reference_at_T200(augru):
    """The loop over T (input projections hoisted, r and z in one
    product) against the reference's ``lax.scan``."""
    jp, tp = _gru_params(2)
    rng = np.random.default_rng(4)
    xs = rng.standard_normal((16, 200, 18)).astype(np.float32)
    att = rng.random((16, 200)).astype(np.float32) if augru else None
    want = jdin._run_gru(jp, jnp.asarray(xs),
                         None if att is None else jnp.asarray(att))
    got = tdin._run_gru(tp, torch.from_numpy(xs),
                        None if att is None else torch.from_numpy(att))
    assert got.shape == (16, 200, 18)
    close(got.numpy(), want, LAYER_TOL)
    # the last state alone, as DIEN's AUGRU takes it
    last = tdin._gru_states(tp, torch.from_numpy(xs),
                            None if att is None else torch.from_numpy(att))[-1]
    assert torch.equal(last, got[:, -1])


def test_recurrence_is_not_torch_gru():
    """torch's GRU cell computes another function: n = tanh(W x + r * (U h
    + b)), h' = (1 - z) n + z h.  The port's recurrence is the reference's."""
    jp, tp = _gru_params(5, scale=1.0)
    rng = np.random.default_rng(6)
    h, x = (rng.standard_normal((8, 18)).astype(np.float32) for _ in range(2))
    cell = torch.nn.GRUCell(18, 18, bias=True)
    with torch.no_grad():
        wx = torch.cat([tp[g]["wx"] for g in "rzh"], dim=1).t()
        wh = torch.cat([tp[g]["wh"] for g in "rzh"], dim=1).t()
        cell.weight_ih.copy_(wx)
        cell.weight_hh.copy_(wh)
        cell.bias_ih.zero_()
        cell.bias_hh.zero_()
        theirs = cell(torch.from_numpy(x), torch.from_numpy(h))
    want = np.asarray(jdin._gru_cell(jp, jnp.asarray(h), jnp.asarray(x)))
    ours = tdin._gru_cell(tp, torch.from_numpy(h), torch.from_numpy(x))
    close(ours.numpy(), want, LAYER_TOL)
    assert float(np.abs(theirs.numpy() - want).max()) > 1e-2


@pytest.mark.parametrize("chunk", [tdin.RETRIEVAL_CHUNK, 7])
def test_retrieval_scores_match_reference(chunk, monkeypatch):
    """One user's history against 50 candidates; chunks of 7 candidates
    give the scores of the whole."""
    jcfg, tcfg = CONFIGS["din-cut-T200"]
    jparams, model = _pair(jcfg, tcfg)
    batch = ClickLogGenerator(jcfg, seed=5).batch(1, with_labels=False)
    cand = np.random.default_rng(6).integers(0, 3000, 50).astype(np.int32)
    want = jdin.retrieval_scores(jparams, jax.tree.map(jnp.asarray, batch),
                                 jnp.asarray(cand), jcfg)
    monkeypatch.setattr(tdin, "RETRIEVAL_CHUNK", chunk)
    with torch.inference_mode():
        got = tdin.retrieval_scores(model.tree(), batch_to_tensors(batch, CPU),
                                    torch.from_numpy(cand), tcfg)
    assert got.shape == (50,)
    close(got.numpy(), want, LOGIT_TOL)


def test_init_matches_reference_shapes():
    for name, (jcfg, tcfg) in CONFIGS.items():
        jp = jax.eval_shape(lambda: jdin.init(jax.random.PRNGKey(0), jcfg))
        model = tdin.init(tcfg, generator=torch.Generator().manual_seed(0),
                          device=CPU)
        shapes = jax.tree.map(lambda a: tuple(a.shape), model.tree())
        assert shapes == jax.tree.map(lambda s: tuple(s.shape), jp), name
        if tcfg.use_gru:
            assert not model.gru.tree()["z"]["b"].any()


# ---------------------------------------------------------------------------
# The reference's QR item lookup (ROADMAP queue 3)
# ---------------------------------------------------------------------------


def _qr(cfg, buckets=64):
    """A tiny config whose item table (feature 0) is QR-compressed: 100,000
    ids in ceil(100000/64) + 64 = 1,627 stored rows."""
    emb = dataclasses.replace(cfg.embedding, vocab_sizes=(100_000, 50, 20),
                              qr_features=(0,), qr_buckets=buckets)
    return dataclasses.replace(cfg, embedding=emb)


def qr_item_lookup(params, ids, cfg):
    """The oracle's item lookup: feature 0's rows by the reference's own
    ``_gather_with_qr`` (ids of any shape in the feature-0 column of
    [N, F, 1] ids)."""
    flat = ids.reshape(-1)
    F = cfg.embedding.num_features
    ids3 = jnp.zeros((flat.shape[0], F, 1), jnp.int32).at[:, 0, 0].set(flat)
    rows = j_emb._gather_with_qr(params["embedding"]["table"], ids3,
                                 cfg.embedding)[:, 0, 0]
    return rows.reshape(ids.shape + (cfg.embedding.dim,))


@pytest.mark.parametrize("use_gru", [False, True])
def test_qr_item_table_reference_fault_and_port(use_gru, monkeypatch):
    jcfg = _qr(dataclasses.replace(j_din.SMOKE, use_gru=use_gru))
    tcfg = _qr(dataclasses.replace(t_din.SMOKE, use_gru=use_gru))
    assert jcfg.embedding.storage_rows(0) == 1627
    jparams, model = _pair(jcfg, tcfg)
    jb, tb = _batches(jcfg, n=64, seed=1)
    hist = np.asarray(jb["history_ids"])
    assert (hist >= 1627).any()          # ids past feature 0's storage
    assert (hist >= jcfg.embedding.total_rows).any()  # and past the table

    broken = np.asarray(jdin.apply(jparams, jb, jcfg))
    assert not np.isfinite(broken).all()

    monkeypatch.setattr(jdin_mod, "_item_lookup", qr_item_lookup)
    want = jdin.apply(jparams, jb, jcfg)
    assert np.isfinite(np.asarray(want)).all()
    with torch.inference_mode():
        got = model(tb)
    close(got.numpy(), want, LOGIT_TOL)
