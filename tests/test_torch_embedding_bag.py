"""Kernel K1 (hot embedding bag): the port's plain version against the
reference's Pallas kernel (interpret mode on CPU) and its jnp oracle, the
per-feature entry's plain version against the reference's
``embedding_bag_local``, and the CUDA kernel against the plain version where
a card is present.

Tolerances are those of tests/test_kernels.py: f32 1e-5, bf16 3e-2."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import hot_embedding_bag as jax_hot_embedding_bag
from repro.kernels.embedding_bag import hot_embedding_bag_ref as jax_hot_embedding_bag_ref
from repro.models import embedding as jemb
from repro_torch.kernels import _build
from repro_torch.kernels.embedding_bag import (
    embedding_bag_features,
    hot_embedding_bag,
    hot_embedding_bag_ref,
    ops,
)
from repro_torch.kernels.embedding_bag.ref import shift_feature_ids
from repro_torch.models.dlrm import params_from_reference

TOL = {"f32": 1e-5, "bf16": 3e-2}
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _case(B, P, D, seed, H=1000):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((H, D)).astype(np.float32)
    ids = rng.integers(-1, H, (B, P)).astype(np.int32)
    ids[3] = -1  # a bag that is all padding
    return table, ids


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("D", [16, 32, 64])
@pytest.mark.parametrize("P", [1, 8, 80])
@pytest.mark.parametrize("B", [37, 64])
def test_plain_matches_reference_kernel(B, P, D, dtype):
    table, ids = _case(B, P, D, seed=B * 1000 + P * 10 + D)
    jt = jnp.asarray(table, JNP[dtype])
    want_kernel = np.asarray(jax_hot_embedding_bag(jt, jnp.asarray(ids)),
                             np.float32)
    want_ref = np.asarray(jax_hot_embedding_bag_ref(jt, jnp.asarray(ids)),
                          np.float32)
    before = ops.launches
    t = params_from_reference(np.asarray(jt), device=CPU)
    got = hot_embedding_bag(t, torch.from_numpy(ids))
    assert ops.launches == before  # CPU tensors never launch the kernel
    assert got.dtype == t.dtype and got.shape == (B, D)
    got = got.float().numpy()
    tol = TOL[dtype]
    np.testing.assert_allclose(got, want_kernel, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, want_ref, rtol=tol, atol=tol)
    assert not got[3].any()


def test_weighted_ref_matches_reference_oracle():
    table, ids = _case(16, 8, 16, seed=5)
    w = np.random.default_rng(6).random(ids.shape).astype(np.float32)
    want = jax_hot_embedding_bag_ref(jnp.asarray(table), jnp.asarray(ids),
                                     jnp.asarray(w))
    got = hot_embedding_bag_ref(torch.from_numpy(table), torch.from_numpy(ids),
                                torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_empty_batch_and_rejected_inputs():
    table, ids = _case(8, 4, 16, seed=1)
    t = torch.from_numpy(table)
    assert hot_embedding_bag(t, torch.from_numpy(ids[:0])).shape == (0, 16)
    with pytest.raises(TypeError):
        hot_embedding_bag(t, torch.from_numpy(ids.astype(np.int64)))
    with pytest.raises(ValueError):
        hot_embedding_bag(t, torch.from_numpy(ids[0]))


def test_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()
    assert "embedding_bag" in _build.sources()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_kernel_matches_plain(cuda_device, dtype):
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    for B, P, D in [(37, 80, 32), (64, 8, 64), (37, 1, 16), (5, 33, 48)]:
        table, ids = _case(B, P, D, seed=B + P + D)
        t = torch.from_numpy(table).to(cuda_device, tdt)
        i = torch.from_numpy(ids).to(cuda_device)
        before = ops.launches
        got = hot_embedding_bag(t, i)
        torch.cuda.synchronize()
        assert ops.launches == before + 1
        want = hot_embedding_bag_ref(t, i)
        tol = TOL[dtype]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
        assert not got[3].any()


def _features_case(dtype, qr, combine, B=24, seed=1):
    """A reference EmbeddingConfig, its table, per-feature ids [B, F, P]
    (some bags empty, -1 also inside bags) and the routed offsets (-1 for
    the QR feature)."""
    kw = dict(vocab_sizes=(1000, 5000, 300), qr_features=(1,),
              qr_buckets=64) if qr else dict(vocab_sizes=(1000, 500, 2000))
    cfg = jemb.EmbeddingConfig(dim=16, pooling=(8, 4, 12), combine=combine,
                               dtype=JNP[dtype], **kw)
    rng = np.random.default_rng(seed)
    t = rng.uniform(-1, 1, (cfg.total_rows, cfg.dim)).astype(np.float32)
    jt = jnp.asarray(t, cfg.dtype)
    F, P = cfg.num_features, cfg.max_pooling
    ids = np.full((B, F, P), -1, np.int32)
    for f in range(F):
        counts = rng.integers(0, cfg.pooling[f] + 1, B)
        for b in range(B):
            ids[b, f, :counts[b]] = rng.integers(0, cfg.vocab_sizes[f],
                                                 counts[b])
    ids[rng.random(ids.shape) < 0.2] = -1
    off = cfg.row_offsets[:-1].astype(np.int64)
    off[list(cfg.qr_features)] = -1
    return cfg, jt, ids, off


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("combine", ["sum", "mean"])
@pytest.mark.parametrize("qr", [False, True])
def test_features_entry_matches_reference_local(qr, combine, dtype):
    """The per-feature entry on CPU tensors against the reference's
    embedding_bag_local on the table copied from it: every routed feature
    agrees (divided by its bag sizes for "mean"), the QR feature (offset
    -1) pools to exactly zero."""
    cfg, jt, ids, off = _features_case(dtype, qr, combine)
    want = np.asarray(jemb.embedding_bag_local({"table": jt}, jnp.asarray(ids),
                                               cfg), np.float32)
    t = params_from_reference(np.asarray(jt), device=CPU)
    before = ops.launches
    got = embedding_bag_features(t, torch.from_numpy(ids), torch.from_numpy(off))
    assert ops.launches == before
    assert got.dtype == t.dtype and got.shape == want.shape
    got = got.float().numpy()
    if combine == "mean":
        got = got / np.maximum((ids >= 0).sum(axis=2, keepdims=True), 1)
    routed = [f for f in range(cfg.num_features) if f not in cfg.qr_features]
    tol = TOL[dtype]
    np.testing.assert_allclose(got[:, routed], want[:, routed], rtol=tol,
                               atol=tol)
    assert not got[:, list(cfg.qr_features)].any()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_features_entry_matches_reference_kernel(dtype):
    """The per-feature entry against the reference's Pallas kernel
    (interpret mode) on the ids shifted by each feature's offset, and
    bitwise against the port's 2-D entry on the same shifted ids."""
    cfg, jt, ids, off = _features_case(dtype, True, "sum", B=20)
    B, F, P = ids.shape
    shifted = shift_feature_ids(torch.from_numpy(ids), torch.from_numpy(off))
    flat = shifted.to(torch.int32).reshape(B * F, P)
    want = np.asarray(jax_hot_embedding_bag(jt, jnp.asarray(flat.numpy())),
                      np.float32).reshape(B, F, -1)
    t = params_from_reference(np.asarray(jt), device=CPU)
    got = embedding_bag_features(t, torch.from_numpy(ids), torch.from_numpy(off))
    assert torch.equal(got, hot_embedding_bag(t, flat).reshape(got.shape))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_features_entry_rejected_inputs():
    cfg, jt, ids, off = _features_case("f32", False, "sum", B=4)
    t = params_from_reference(np.asarray(jt), device=CPU)
    i, o = torch.from_numpy(ids), torch.from_numpy(off)
    with pytest.raises(ValueError):
        embedding_bag_features(t, i[:, 0], o)            # ids not [B, F, P]
    with pytest.raises(ValueError):
        embedding_bag_features(t, i, o.to(torch.int32))  # offsets not int64
    with pytest.raises(ValueError):
        embedding_bag_features(t, i, o[:2])              # one per feature
    with pytest.raises(TypeError):
        embedding_bag_features(t, i.long(), o)
    assert embedding_bag_features(t, i[:0], o).shape == (0, 3, cfg.dim)
