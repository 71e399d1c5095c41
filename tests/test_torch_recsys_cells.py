"""The port's recsys cells (``repro_torch.launch.steps.build_cell``) against
the reference's ``build_cell(..., mesh=None)``: serve_p99, serve_bulk and
retrieval_cand of wide-deep, din, mind and dlrm-rm2 on their SMOKE
configs (batch 16, 128 candidates), on the reference's parameters and the
same click-log inputs; the registry's configs equal the reference's; the
train cells build (their parity is tests/test_torch_train_cells.py).

Scores use 1e-4 (XLA-CPU and torch sum the matrix products in other
orders), scaled by the largest score compared."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as j_get_arch
from repro.launch.steps import build_cell as j_build_cell
from repro_torch.configs.registry import get_arch
from repro_torch.data.clicklog import cell_batch
from repro_torch.launch.steps import build_cell
from repro_torch.models import RECSYS_MODELS

CPU = torch.device("cpu")
LOGIT_TOL = 1e-4
ARCHS = ("wide-deep", "din", "mind", "dlrm-rm2")
SHAPES = ("serve_p99", "serve_bulk", "retrieval_cand")


def _spec_shapes(specs):
    return {k: tuple(v.shape) for k, v in specs.items()}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch_id", ARCHS)
def test_cell_matches_reference(arch_id, shape):
    jcell = j_build_cell(arch_id, shape, mesh=None)
    tcell = build_cell(arch_id, shape, device="cpu")
    assert tcell.cfg.name == jcell.cfg.name
    assert _spec_shapes(tcell.batch_specs) == _spec_shapes(jcell.batch_specs)
    jparams = jcell.init_state(jax.random.PRNGKey(0))
    lib = RECSYS_MODELS[tcell.cfg.interaction]
    model = type(tcell.init_state(torch.Generator().manual_seed(0)))(
        tcell.cfg, lib.params_from_reference(jax.tree.map(np.asarray, jparams),
                                             device=CPU))
    batch = cell_batch(tcell.cfg, tcell.batch_specs, seed=3)
    assert {k: v.shape for k, v in batch.items()} == \
        _spec_shapes(jcell.batch_specs)
    want = np.asarray(jcell.run(jparams, jax.tree.map(jnp.asarray, batch))[
        "scores"], np.float32)
    got = tcell.run(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    got = got["scores"].float().numpy()
    assert got.shape == want.shape
    assert got.shape == ((1, 128) if (shape == "retrieval_cand" and arch_id == "mind")
                         else (128,) if shape == "retrieval_cand" else (16,))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL,
                               atol=LOGIT_TOL * float(np.abs(want).max()))


@pytest.mark.parametrize("arch_id", ARCHS)
def test_registry_and_train_cell(arch_id):
    """get_arch returns the ported config module, its configs equal the
    reference's field by field, its random init runs; the train cell
    builds with the reference's optimizer and a labelled batch."""
    mod, jmod = get_arch(arch_id), j_get_arch(arch_id)
    assert (mod.ARCH_ID, mod.SLA_MS, [s.name for s in mod.SHAPES]) == \
        (jmod.ARCH_ID, jmod.SLA_MS, [s.name for s in jmod.SHAPES])
    for name in ("FULL", "SMOKE"):
        t, j = getattr(mod, name), getattr(jmod, name)
        for f in dataclasses.fields(j):
            if f.name not in ("dtype", "embedding"):
                assert getattr(t, f.name) == getattr(j, f.name), (name, f.name)
        for f in dataclasses.fields(j.embedding):
            if f.name != "dtype":
                assert getattr(t.embedding, f.name) == \
                    getattr(j.embedding, f.name), (name, f.name)
        assert t.embedding.total_rows == j.embedding.total_rows
    cell = build_cell(arch_id, "serve_p99", device="cpu")
    model = cell.init_state(torch.Generator().manual_seed(0))
    assert type(model).__module__ == \
        RECSYS_MODELS[cell.cfg.interaction].__name__
    train = build_cell(arch_id, "train_batch", device="cpu")
    assert train.opt.name == "rowwise_adagrad(lr=0.01)"
    assert train.batch == 16 and train.batch_specs["label"].shape == (16,)


def test_cell_batch_and_device():
    """A stated batch replaces a serve cell's; a retrieval cell takes none;
    the default device needs a card."""
    cell = build_cell("din", "serve_p99", device="cpu", batch=5)
    assert cell.batch == 5 and cell.batch_specs["history_ids"].shape == (5, 10)
    with pytest.raises(ValueError):
        build_cell("din", "retrieval_cand", device="cpu", batch=5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_cell("mind", "serve_p99")
