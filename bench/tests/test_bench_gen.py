"""The traffic generator: deterministic by seed, and the marginals of the
port's click log (``repro_torch/data/clicklog.py``)."""
import math

import numpy as np
import pytest
import torch

from bench import gen, harness
from bench.tests.util import sizes_of

TRAFFIC = {"zipf_alpha": 1.05, "pooling_share": 0.6, "pooling_sigma": 0.6}


def _sizes(vocab, pooling, n_dense=13):
    return {"vocab_sizes": vocab, "pooling": pooling, "n_dense": n_dense}


def _draw(seed, rows=512, sizes=None):
    sizes = sizes or _sizes([5000, 70000], [64, 1])
    return gen.draw_batch(sizes, TRAFFIC, rows,
                          gen.generator(seed, torch.device("cpu")),
                          torch.device("cpu"))


def test_same_seed_same_batch():
    a, b = _draw(7), _draw(7)
    for k in a:
        assert torch.equal(a[k], b[k])
    c = _draw(8)
    assert not torch.equal(a["sparse_ids"], c["sparse_ids"])


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 2**40, -3])
def test_subseed_takes_any_whole_number(seed):
    s = gen.subseed(seed, 2, 1)
    assert 0 <= s < 2**63 and s == gen.subseed(seed, 2, 1)
    assert s != gen.subseed(seed, 2, 2)


def test_pool_batches_differ_and_repeat():
    sizes = _sizes([4000], [8])
    tr = dict(TRAFFIC, batch=64, pool=3)
    p1 = gen.draw_pool(sizes, tr, 11, torch.device("cpu"))
    p2 = gen.draw_pool(sizes, tr, 11, torch.device("cpu"))
    assert len(p1) == 3
    assert all(torch.equal(x["sparse_ids"], y["sparse_ids"])
               for x, y in zip(p1, p2))
    assert not torch.equal(p1[0]["sparse_ids"], p1[1]["sparse_ids"])


def test_layout():
    b = _draw(3)
    ids = b["sparse_ids"]
    assert ids.dtype == torch.int32 and ids.shape == (512, 2, 64)
    assert b["dense"].dtype == torch.float32 and b["dense"].shape == (512, 13)
    live = ids >= 0
    # live slots first in every bag, -1 after
    counts = live.sum(-1)
    assert torch.equal(live, torch.arange(64)[None, None, :]
                       < counts[..., None])
    assert counts.min() >= 1 and counts[:, 0].max() <= 64
    assert torch.all(counts[:, 1] == 1)          # nominal pooling 1
    assert ids[..., 0].max() < 70000 and ids[:, 0].max() < 5000


def test_marginals_match_the_click_log():
    """Pooling counts, id ranks and dense features against the port's
    ClickLogGenerator on the same sizes: means and quantiles within a few
    standard errors."""
    from repro_torch.data.clicklog import ClickLogGenerator
    from repro_torch.models.embedding import EmbeddingConfig
    from repro_torch.models.recsys_base import RecsysConfig

    cfg = RecsysConfig(name="m", embedding=EmbeddingConfig(
        vocab_sizes=(2_000_000, 3000), dim=4, pooling=(64, 20)), n_dense=13,
        bottom_mlp=(4,), top_mlp=(4,))
    rows = 20000
    ref = ClickLogGenerator(cfg, seed=5).batch(rows, with_labels=False)
    ours = _draw(5, rows, _sizes([2_000_000, 3000], [64, 20]))
    ref_ids = ref["sparse_ids"]
    our_ids = ours["sparse_ids"].numpy()
    for f in range(2):
        rc = (ref_ids[:, f] >= 0).sum(-1)
        oc = (our_ids[:, f] >= 0).sum(-1)
        assert abs(rc.mean() - oc.mean()) < 4 * rc.std() / math.sqrt(rows)
        rl = np.log1p(ref_ids[:, f][ref_ids[:, f] >= 0].astype(np.float64))
        ol = np.log1p(our_ids[:, f][our_ids[:, f] >= 0].astype(np.float64))
        for q in (0.1, 0.25, 0.5, 0.75, 0.9, 0.99):
            assert abs(np.quantile(rl, q) - np.quantile(ol, q)) < 0.05 * (
                1 + np.quantile(rl, q))
        assert abs(rl.mean() - ol.mean()) < 0.02 * rl.mean()
    d = ours["dense"].numpy()
    assert abs(d.mean()) < 0.01 and abs(d.std() - 1) < 0.01


def test_rm2_sizes_hold_the_coldest_rows_reachable():
    """Drawn in float64: ids near the top of a 5,000,000-row table are not
    rounded onto a coarse grid."""
    b = _draw(9, 4096, _sizes([5_000_000], [64]))
    ids = b["sparse_ids"][b["sparse_ids"] >= 0]
    top = ids[ids > 4_000_000]
    assert top.numel() > 100
    assert (top % 2 == 1).any() and (top % 2 == 0).any()
    assert len(torch.unique(top)) > 0.9 * top.numel()


def test_sizes_of_matches_config_files():
    from repro_torch.configs import dlrm_rm2

    file = harness.load_cell("rm2.bulk").sizes
    mine = sizes_of(dlrm_rm2.FULL, "dlrm")
    for k, v in mine.items():
        assert file[k] == v, k
