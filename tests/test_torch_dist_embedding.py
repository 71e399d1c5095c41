"""The row-sharded embedding lookup (the distributed SparseNet) against the
reference's and the port's single-device ``embedding_bag_local``.

Four gloo ranks on the CPU, a (2, 2) ("data", "model") mesh, spawned once
for the file (``torch_dist_ranks.embedding_rank``): each rank holds its
model block of the combined table's rows and its data block of the batch;
the cases cover ids on both sides of a shard boundary (feature 1's rows
straddle it), a QR feature with ``combine="mean"`` and an empty bag.  Then
``sharded_row_gather`` on rows of every shard, and the dlrm-rm2 serve
cell built on the mesh (its state only the rank's table rows, made from the
seed: bitwise that block of the whole table) against the whole cell.  Last
the reference's multi-pod layout, 2 x 2 x 2 ranks ("pod", "data",
"model"), with the vocab-parallel loss beside the embedding.

Tolerances: f32 1e-5 (the K1 plain version's float32 sums, then one
all-reduce of the partials: sums in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro.dist import loss as j_loss
from repro.models import embedding as j_emb
from repro_torch.data.clicklog import cell_batch
from repro_torch.launch.mesh import spawn
from repro_torch.launch.steps import build_cell
from repro_torch.models import embedding as t_emb

TOL = 1e-5
CASES = {
    "plain": dict(vocab_sizes=(100, 300, 50), dim=8, pooling=(4, 2, 1),
                  row_pad=8),
    "qr_mean": dict(vocab_sizes=(100, 5000, 50), dim=8, pooling=(3, 5, 2),
                    qr_features=(1,), qr_buckets=64, combine="mean",
                    row_pad=8),
}
CELL = dict(arch_id="dlrm-rm2", seed=3)


def _case(fields: dict, seed: int) -> dict:
    cfg = t_emb.EmbeddingConfig(**fields)
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1, 1, (cfg.total_rows, cfg.dim)).astype(np.float32)
    B, F, P = 16, cfg.num_features, cfg.max_pooling
    ids = np.stack([rng.integers(-1, v, (B, P)) for v in cfg.vocab_sizes],
                   axis=1).astype(np.int32)
    ids[3] = -1          # an empty bag in every feature
    ids[5, 1, :] = -1    # and one empty feature
    return {"cfg": fields, "table": table, "ids": ids}


def _whole(results, key, block_of):
    """The batch blocks of the ranks at model index 0, in data order, after
    checking that the other model ranks got the same block."""
    by = {}
    for r in results:
        d, m = r["coords"]["data"], r["coords"]["model"]
        got = block_of(r)
        if d in by:
            np.testing.assert_array_equal(got, by[d])
        by[d] = got
    return np.concatenate([by[d] for d in sorted(by)])


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    cases = [_case(f, seed) for seed, f in enumerate(CASES.values())]
    cell = build_cell(CELL["arch_id"], "serve_p99", "cpu")
    batch = cell_batch(cell.cfg, cell.batch_specs, seed=5)
    out = spawn(ranks.embedding_rank, 4, backend="gloo",
                init_file=tmp_path_factory.mktemp("emb") / "init",
                device="cpu", args=(cases, dict(CELL, batch=batch)))
    return cases, batch, out


@pytest.mark.parametrize("i,name", list(enumerate(CASES)))
def test_sharded_embedding_matches_local(results, i, name):
    cases, _, out = results
    case = cases[i]
    pooled = _whole(out, "pooled", lambda r: r["cases"][i]["pooled"])
    jcfg = j_emb.EmbeddingConfig(**case["cfg"])
    want = np.asarray(j_emb.embedding_bag_local(
        {"table": jnp.asarray(case["table"])}, jnp.asarray(case["ids"]),
        jcfg))
    np.testing.assert_allclose(pooled, want, rtol=TOL, atol=TOL)
    tcfg = t_emb.EmbeddingConfig(**case["cfg"])
    local = t_emb.embedding_bag_local(
        {"table": torch.from_numpy(case["table"])},
        torch.from_numpy(case["ids"]), tcfg).numpy()
    np.testing.assert_allclose(pooled, local, rtol=TOL, atol=TOL)
    assert np.all(pooled[3] == 0) and np.all(pooled[5, 1] == 0)
    for r in out:
        c = r["cases"][i]
        assert c["rows_held"] == tcfg.total_rows // 2
        # one all-reduce of the K1 partials, one more a QR feature's rows
        assert c["all_reduces"] == 1 + len(tcfg.qr_features)


def test_ids_straddle_the_shard_boundary(results):
    """Feature 1 of the plain case owns rows [100, 400) of 456: the shards
    split at row 228, and its ids reach both sides."""
    cases, _, _ = results
    case = cases[0]
    cfg = t_emb.EmbeddingConfig(**case["cfg"])
    rows = case["ids"][:, 1][case["ids"][:, 1] >= 0] + int(cfg.row_offsets[1])
    half = cfg.total_rows // 2
    assert (rows < half).any() and (rows >= half).any()


def test_sharded_row_gather(results):
    cases, _, out = results
    table = cases[0]["table"]
    want = table[np.arange(table.shape[0] - 1, -1, -7)]
    for r in out:
        np.testing.assert_array_equal(r["row_gather"], want)


def test_recsys_cell_on_the_mesh(results):
    """dlrm-rm2's serve cell on the mesh against the whole cell from the
    same seed: each rank's table block bitwise the whole table's, the
    scores of its batch block at 1e-5."""
    _, batch, out = results
    cell = build_cell(CELL["arch_id"], "serve_p99", "cpu")
    model = cell.init_fn(cell.cfg, generator=torch.Generator().manual_seed(
        CELL["seed"]), device=torch.device("cpu"))
    want = cell.run(model, {k: torch.from_numpy(v) for k, v in
                            batch.items()})["scores"].numpy()
    table = model.table.detach().numpy()
    rows = table.shape[0] // 2
    for r in out:
        m = r["coords"]["model"]
        assert r["cell"]["table_rows"] == rows
        np.testing.assert_array_equal(r["cell"]["table"],
                                      table[m * rows:(m + 1) * rows])
    got = _whole(out, "scores", lambda r: r["cell"]["scores"])
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def multipod(tmp_path_factory):
    emb = _case(CASES["plain"], seed=7)
    rng = np.random.default_rng(8)
    ce = {"logits": rng.standard_normal((8, 16, 64)).astype(np.float32),
          "targets": rng.integers(0, 64, (8, 16)).astype(np.int64)}
    out = spawn(ranks.multipod_rank, 8, backend="gloo",
                init_file=tmp_path_factory.mktemp("pod") / "init",
                device="cpu", args=(emb, ce))
    return emb, ce, out


def test_multipod_2x2x2_matches_local(multipod):
    """The reference's tests/test_distributed.py multi-pod case: batch over
    ("pod", "data"), the table over "model", the vocabulary over "model"."""
    emb, ce, out = multipod
    jcfg = j_emb.EmbeddingConfig(**emb["cfg"])
    want = np.asarray(j_emb.embedding_bag_local(
        {"table": jnp.asarray(emb["table"])}, jnp.asarray(emb["ids"]), jcfg))
    by = {}
    for r in out:
        c = r["coords"]
        blk = 2 * c["pod"] + c["data"]
        if blk in by:
            np.testing.assert_array_equal(r["pooled"], by[blk])
        by[blk] = r["pooled"]
    got = np.concatenate([by[b] for b in sorted(by)])
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    ref_ce = float(j_loss.ce_loss(jnp.asarray(ce["logits"]),
                                  jnp.asarray(ce["targets"])))
    for r in out:
        assert abs(r["loss"] - ref_ce) < TOL
