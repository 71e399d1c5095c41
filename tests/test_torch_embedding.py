"""The port's embedding substrate against the reference's functions on a
copied table: pooled lookup (sum, mean, quotient-remainder), the ragged
bag, and the hot/cold split with its two partial sums.

Tolerances: f32 1e-5 and bf16 3e-2 (tests/test_kernels.py); the hot/cold
re-layout moves rows and is compared bitwise."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import embedding as jemb
from repro_torch.models import embedding as temb
from repro_torch.models.dlrm import params_from_reference

CPU = torch.device("cpu")
TOL = {"f32": 1e-5, "bf16": 3e-2}
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(dtype="f32", **kw):
    jdt, tdt = DT[dtype]
    base = dict(vocab_sizes=(1000, 500, 2000), dim=16, pooling=(8, 4, 12))
    base.update(kw)
    return (jemb.EmbeddingConfig(dtype=jdt, **base),
            temb.EmbeddingConfig(dtype=tdt, **base))


def _table(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.uniform(-1, 1, (jcfg.total_rows, jcfg.dim)).astype(np.float32)
    jt = jnp.asarray(t, jcfg.dtype)
    return jt, params_from_reference(np.asarray(jt), device=CPU)


def _ids(cfg, B=24, seed=1):
    rng = np.random.default_rng(seed)
    F, P = cfg.num_features, cfg.max_pooling
    ids = np.full((B, F, P), -1, np.int32)
    for f in range(F):
        counts = rng.integers(0, cfg.pooling[f] + 1, B)  # 0: an empty bag
        for b in range(B):
            ids[b, f, :counts[b]] = rng.integers(0, cfg.vocab_sizes[f], counts[b])
    return ids


def test_config_layout_matches_reference():
    for kw in ({}, {"qr_features": (1,), "qr_buckets": 64}, {"row_pad": 7}):
        jc, tc = _cfgs(**kw)
        np.testing.assert_array_equal(tc.row_offsets, jc.row_offsets)
        assert tc.total_rows == jc.total_rows
        assert tc.bytes(2) == jc.bytes(2)
        assert [tc.storage_rows(f) for f in range(3)] == \
            [jc.storage_rows(f) for f in range(3)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("combine", ["sum", "mean"])
@pytest.mark.parametrize("qr", [False, True])
def test_embedding_bag_local_matches_reference(combine, qr, dtype):
    kw = {"combine": combine}
    if qr:
        kw.update(vocab_sizes=(1000, 5000, 300), qr_features=(1,), qr_buckets=64)
    jc, tc = _cfgs(dtype, **kw)
    jt, tt = _table(jc)
    ids = _ids(tc)
    want = jemb.embedding_bag_local({"table": jt}, jnp.asarray(ids), jc)
    got = temb.embedding_bag_local({"table": tt}, torch.from_numpy(ids), tc)
    assert got.dtype == tt.dtype and got.shape == tuple(want.shape)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_embedding_bag_local_rejects_wrong_feature_count():
    jc, tc = _cfgs()
    _, tt = _table(jc)
    with pytest.raises(ValueError):
        temb.embedding_bag_local({"table": tt}, torch.zeros((2, 2, 12), dtype=torch.int32), tc)


@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_embedding_bag_ragged_matches_reference(combine):
    rng = np.random.default_rng(3)
    table = rng.standard_normal((300, 8)).astype(np.float32)
    ids = rng.integers(0, 300, 50).astype(np.int32)
    seg = np.sort(rng.integers(0, 12, 50)).astype(np.int32)  # some empty
    want = jemb.embedding_bag_ragged(jnp.asarray(table), jnp.asarray(ids),
                                     jnp.asarray(seg), 12, combine)
    got = temb.embedding_bag_ragged(torch.from_numpy(table), torch.from_numpy(ids),
                                    torch.from_numpy(seg), 12, combine)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("capacity", [0, 300, 1200, 10_000])
def test_hot_cold_split_and_psums_match_reference(capacity):
    jc, tc = _cfgs()
    jt, tt = _table(jc)
    freq = [np.arange(v, 0, -1, dtype=np.float64) for v in tc.vocab_sizes]
    for access in (None, freq):
        jl = jemb.make_hot_cold_layout(jc, capacity, access)
        tl = temb.make_hot_cold_layout(tc, capacity, access)
        assert tl.hot_rows == jl.hot_rows
        assert tl.total_hot == jl.total_hot and tl.total_cold == jl.total_cold
    jsplit = jemb.split_hot_cold({"table": jt}, jl)
    tsplit = temb.split_hot_cold({"table": tt}, tl)
    for k in ("hot", "cold"):
        np.testing.assert_array_equal(tsplit[k].numpy(), np.asarray(jsplit[k]))
    ids = _ids(tc)
    jh, jco = jemb.embedding_bag_hot_cold(jsplit, jnp.asarray(ids), jl)
    th, tco = temb.embedding_bag_hot_cold(tsplit, torch.from_numpy(ids), tl)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tco.numpy(), np.asarray(jco), rtol=1e-5, atol=1e-5)
    # the two partial sums add up to the plain pooled lookup
    full = temb.embedding_bag_local({"table": tt}, torch.from_numpy(ids), tc)
    np.testing.assert_allclose((th + tco).numpy(), full.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_init_embedding_scales_and_generator(dtype):
    _, tc = _cfgs(dtype)
    a = temb.init_embedding(tc, generator=torch.Generator().manual_seed(0), device=CPU)
    b = temb.init_embedding(tc, generator=torch.Generator().manual_seed(0), device=CPU)
    t = a["table"]
    assert t.shape == (tc.total_rows, tc.dim) and t.dtype == tc.dtype
    assert torch.equal(t, b["table"])
    off = tc.row_offsets
    for f, v in enumerate(tc.vocab_sizes):
        part = t[int(off[f]):int(off[f + 1])].float()
        assert part.abs().max() <= 1.0 / np.sqrt(v) * (1 + 1e-2)
        assert part.abs().max() > 0.5 / np.sqrt(v)


@pytest.mark.parametrize("n", [2, 4, 7])
def test_init_embedding_row_shards_tile_the_table(monkeypatch, n):
    """The blocks ``row_shard=(i, n)`` are bitwise the rows of the whole
    table from the same seed, with chunk edges inside and between blocks,
    and leave the generator in the same state."""
    monkeypatch.setattr(temb, "INIT_CHUNK_ROWS", 300)
    _, tc = _cfgs(row_pad=7 * 4)
    g = torch.Generator().manual_seed(3)
    whole = temb.init_embedding(tc, generator=g, device=CPU)["table"]
    after = torch.rand(4, generator=g)
    for i in range(n):
        gi = torch.Generator().manual_seed(3)
        block = temb.init_embedding(tc, generator=gi, device=CPU,
                                    row_shard=(i, n))["table"]
        lo, hi = i * tc.total_rows // n, (i + 1) * tc.total_rows // n
        assert torch.equal(block, whole[lo:hi])
        assert torch.equal(torch.rand(4, generator=gi), after)


@pytest.mark.parametrize("qr", [False, True])
def test_routed_offsets_built_once(qr):
    """K1's per-feature offsets: one int64 tensor per (config, device), the
    feature start rows with -1 for a QR feature."""
    kw = {"vocab_sizes": (1000, 5000, 300), "qr_features": (1,),
          "qr_buckets": 64} if qr else {}
    _, tc = _cfgs(**kw)
    off = temb.routed_offsets(tc, CPU)
    assert off is temb.routed_offsets(tc, CPU)
    assert off.dtype == torch.int64 and off.device == CPU
    want = tc.row_offsets[:-1].copy()
    want[list(tc.qr_features)] = -1
    np.testing.assert_array_equal(off.numpy(), want)


def test_embedding_bag_local_pools_in_one_features_call(monkeypatch):
    """embedding_bag_local hands the per-feature ids and the cached offsets
    to K1's per-feature entry once, unshifted."""
    _, tc = _cfgs()
    jc, _ = _cfgs()
    _, tt = _table(jc)
    ids = torch.from_numpy(_ids(tc))
    calls = []
    real = temb.embedding_bag_features

    def spy(table, i, off):
        calls.append((i, off))
        return real(table, i, off)

    monkeypatch.setattr(temb, "embedding_bag_features", spy)
    temb.embedding_bag_local({"table": tt}, ids, tc)
    assert len(calls) == 1
    assert torch.equal(calls[0][0], ids)
    assert calls[0][1] is temb.routed_offsets(tc, CPU)
