"""Kernel K1 (hot embedding bag): the port's plain version against the
reference's Pallas kernel (interpret mode on CPU) and its jnp oracle, and
the CUDA kernel against the plain version where a card is present.

Tolerances are those of tests/test_kernels.py: f32 1e-5, bf16 3e-2."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import hot_embedding_bag as jax_hot_embedding_bag
from repro.kernels.embedding_bag import hot_embedding_bag_ref as jax_hot_embedding_bag_ref
from repro_torch.kernels import _build
from repro_torch.kernels.embedding_bag import hot_embedding_bag, hot_embedding_bag_ref, ops
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
