"""Kernel K1 (hot embedding bag): the port's plain version against the
reference's Pallas kernel (interpret mode on CPU) and its jnp oracle, the
per-feature entry's plain version against the reference's
``embedding_bag_local``, and the CUDA kernel against the plain version where
a card is present.  The table gradient through the autograd entries (K1's
backward; its plain version on the CPU) against ``jax.grad`` of the
reference's ``embedding_bag_local``, ``gradcheck`` of the plain path, the
plain version of the backward's pairs and sort stages against numpy, and
the gradient entries' limits.

Tolerances are those of tests/test_kernels.py: f32 1e-5, bf16 3e-2."""
import jax
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
    embedding_bag_features_grad,
    hot_embedding_bag,
    hot_embedding_bag_grad,
    hot_embedding_bag_ref,
    ops,
)
from repro_torch.models import embedding as temb
from repro_torch.kernels.embedding_bag.ref import (
    grad_sorted_pairs_ref,
    shift_feature_ids,
)
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


@pytest.mark.parametrize("window", [False, True])
def test_table_major_count_on_meta_path(window):
    """The shape-only path (meta tensors) launches nothing: at an rm2
    serve_bulk launch, whose card launch walks one table at a time, no
    launch count moves, ``table_major_launches`` included; on CPU tensors
    neither does the plain version."""
    B, F, P, D = 262_144, 26, 64, 64
    table = torch.empty((F * 5_000_000, D), dtype=torch.bfloat16,
                        device="meta")
    ids = torch.empty((B, F, P), dtype=torch.int32, device="meta")
    off = torch.empty((F,), dtype=torch.int64, device="meta")
    kw = dict(row_window=(0, table.shape[0]),
              out_dtype=torch.float32) if window else {}
    counts = ("launches", "window_launches", "table_major_launches")
    before = [getattr(ops, c) for c in counts]
    out = embedding_bag_features(table, ids, off, **kw)
    assert out.device.type == "meta" and out.shape == (B, F, D)
    cfg, jt, cids, coff = _features_case("bf16", False, "sum", B=4)
    t = params_from_reference(np.asarray(jt), device=CPU)
    embedding_bag_features(t, torch.from_numpy(cids), torch.from_numpy(coff),
                           **({} if not window else dict(
                               row_window=(0, t.shape[0]),
                               out_dtype=torch.float32)))
    assert [getattr(ops, c) for c in counts] == before


# ---------------------------------------------------------------------------
# the table gradient (K1's backward)
# ---------------------------------------------------------------------------


def _with_duplicates(ids):
    """Slot 1 of every bag repeats slot 0 where slot 0 is an id: a row
    read twice in one bag."""
    ids = ids.copy()
    ids[:, :, 1] = np.where(ids[:, :, 0] >= 0, ids[:, :, 0], ids[:, :, 1])
    return ids


@pytest.mark.parametrize("combine", ["sum", "mean"])
@pytest.mark.parametrize("qr", [False, True])
def test_table_grad_matches_reference_local(qr, combine):
    """``embedding_bag_local``'s table gradient (autograd through the
    per-feature entry, its QR feature through plain gathers) against
    ``jax.grad`` of the reference's ``embedding_bag_local``, on padding,
    empty bags and ids read twice in a bag."""
    cfg, jt, ids, _ = _features_case("f32", qr, combine)
    ids = _with_duplicates(ids)
    tcfg = temb.EmbeddingConfig(
        vocab_sizes=cfg.vocab_sizes, dim=cfg.dim, pooling=cfg.pooling,
        combine=combine, qr_features=cfg.qr_features,
        qr_buckets=cfg.qr_buckets)
    w = np.random.default_rng(5).standard_normal(
        (ids.shape[0], cfg.num_features, cfg.dim)).astype(np.float32)
    want = np.asarray(jax.grad(lambda t: jnp.sum(jemb.embedding_bag_local(
        {"table": t}, jnp.asarray(ids), cfg) * w))(jt))
    t = params_from_reference(np.asarray(jt), device=CPU).requires_grad_()
    pooled = temb.embedding_bag_local({"table": t}, torch.from_numpy(ids),
                                      tcfg)
    got, = torch.autograd.grad((pooled * torch.from_numpy(w)).sum(), t)
    assert got.dtype == t.dtype and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_plain_path_gradcheck():
    """``gradcheck`` in float64 of both autograd entries on the CPU:
    padding, an empty bag, duplicates and an unrouted feature."""
    _, jt, ids, off = _features_case("f32", True, "sum", B=5)
    ids = _with_duplicates(ids)[:, :, :6]
    ids[2] = -1
    table = torch.from_numpy(np.asarray(jt, np.float64)).requires_grad_()
    i, o = torch.from_numpy(np.ascontiguousarray(ids)), torch.from_numpy(off)
    assert torch.autograd.gradcheck(
        lambda t: embedding_bag_features(t, i, o), (table,))
    flat = shift_feature_ids(i, o).to(torch.int32).reshape(-1, 6)
    assert torch.autograd.gradcheck(lambda t: hot_embedding_bag(t, flat),
                                    (table,))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_grad_entries_agree_and_reject(dtype):
    """The 2-D entry's gradient on the shifted ids equals the per-feature
    entry's, bitwise, in the gradient's dtype; no CPU call launches; an
    unrouted feature adds nothing; bad shapes raise."""
    cfg, jt, ids, off = _features_case(dtype, True, "sum", B=12)
    B, F, P = ids.shape
    H = cfg.total_rows
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, F, cfg.dim)).astype(np.float32)).to(
        {"f32": torch.float32, "bf16": torch.bfloat16}[dtype])
    i, o = torch.from_numpy(ids), torch.from_numpy(off)
    before = ops.grad_launches
    got = embedding_bag_features_grad(g, i, o, H)
    flat = shift_feature_ids(i, o).to(torch.int32).reshape(B * F, P)
    assert torch.equal(got, hot_embedding_bag_grad(g.reshape(B * F, -1),
                                                   flat, H))
    assert ops.grad_launches == before and got.dtype == g.dtype
    q0, q1 = cfg.row_offsets[1], cfg.row_offsets[2]
    touched = np.zeros(H, bool)
    touched[flat[flat >= 0].numpy()] = True
    assert not touched[q0:q1].any() and not got[~torch.from_numpy(
        touched)].any()
    with pytest.raises(ValueError):
        embedding_bag_features_grad(g[:, :2], i, o, H)
    with pytest.raises(ValueError):
        hot_embedding_bag_grad(g, flat, H)
    with pytest.raises(TypeError):
        embedding_bag_features_grad(g, i.long(), o, H)


def test_table_grad_after_serving_in_inference_mode():
    """The per-feature offsets cached while a model served (inference
    mode) serve its training too: the backward saves them."""
    cfg, jt, ids, _ = _features_case("f32", False, "sum", B=6)
    tcfg = temb.EmbeddingConfig(vocab_sizes=cfg.vocab_sizes, dim=cfg.dim,
                                pooling=(9, 4, 12))
    t = params_from_reference(np.asarray(jt), device=CPU).requires_grad_()
    i = torch.from_numpy(ids)
    with torch.inference_mode():
        served = temb.embedding_bag_local({"table": t}, i, tcfg)
    pooled = temb.embedding_bag_local({"table": t}, i, tcfg)
    assert torch.equal(pooled.detach(), served)
    got, = torch.autograd.grad(pooled.sum(), t)
    assert got.shape == t.shape and got.any()


def _pairs_numpy(ids, n_rows, off=None):
    """The pairs K1's backward sums, by numpy: (rows, flat indices) of the
    slots that read a row, in a stable argsort by row."""
    rows = ids.astype(np.int64)
    ok = ids >= 0
    if off is not None:
        o = off[None, :, None]
        rows = rows + o
        ok &= o >= 0
    rows, ok = rows.reshape(-1), ok.reshape(-1) & (rows.reshape(-1) < n_rows)
    flat = np.flatnonzero(ok)
    order = np.argsort(rows[flat], kind="stable")
    return rows[flat][order], flat[order]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("layout", ["features", "flat"])
def test_grad_sorted_pairs_plain_matches_numpy(layout, seed):
    """``grad_sorted_pairs_ref`` (the plain version of the backward's pairs
    and sort stages) against numpy on ids with padding, an unrouted
    feature, ids at H - 1 and ids past the table, in both entries' index
    layouts (b * F * P + f * P + p, and b * P + p)."""
    rng = np.random.default_rng(seed)
    sizes = np.array([50, 7, 300, 20])
    B, F, P = 33, len(sizes), 9
    ids = rng.integers(-1, sizes[None, :, None] + 3, (B, F, P)).astype(
        np.int32)
    ids[rng.random(ids.shape) < 0.2] = -1
    ids[0, :, 0] = sizes - 1          # the last row of each feature
    off = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    off[1] = -1                       # an unrouted feature
    H = int(sizes.sum())
    if layout == "features":
        got = grad_sorted_pairs_ref(torch.from_numpy(ids), H,
                                    torch.from_numpy(off))
        want = _pairs_numpy(ids, H, off)
        assert H - 1 in want[0]       # the table's last row is read
    else:
        flat = ids.reshape(B * F, P)
        got = grad_sorted_pairs_ref(torch.from_numpy(flat), 280)
        want = _pairs_numpy(flat, 280)
    assert all(g.dtype == torch.int32 for g in got)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])


def test_grad_entries_limits_raise():
    """The gradient kernel's check refuses ids of 2**31 slots or more (its
    pair index is 32-bit; the card's entries run it before any work, the
    plain version has no such limit), and the entries refuse offsets of
    the wrong shape, dtype or device (the ids here are views of one
    element)."""
    one = torch.zeros((1, 1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        ops._check_kernel_slots(one.expand(2**16, 2**10, 2**5))
    with pytest.raises(ValueError, match="2\\*\\*31"):
        ops._check_kernel_slots(one[0].expand(2**26, 2**5))
    ops._check_kernel_slots(one.expand(1, 1, 2**31 - 1))
    g, i = torch.zeros((2, 3, 4)), torch.zeros((2, 3, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="row_offsets"):
        embedding_bag_features_grad(g, i, torch.zeros(2, dtype=torch.int64),
                                    10)
    with pytest.raises(ValueError, match="row_offsets"):
        embedding_bag_features_grad(g, i, torch.zeros(3, dtype=torch.int32),
                                    10)
    with pytest.raises(ValueError, match="row_offsets"):
        embedding_bag_features_grad(g, i, torch.zeros((3, 1),
                                                      dtype=torch.int64), 10)
    assert embedding_bag_features_grad(
        g, i, torch.zeros(3, dtype=torch.int64), 10).shape == (10, 4)


def test_grad_entries_bags_of_no_slot():
    """Bags of P = 0 slots (and an empty batch) read no row: both gradient
    entries give zeros of the table's shape, in the gradient's dtype."""
    g = torch.ones((5, 3, 4), dtype=torch.bfloat16)
    off = torch.zeros(3, dtype=torch.int64)
    zeros = torch.zeros((10, 4), dtype=torch.bfloat16)
    for got in (embedding_bag_features_grad(
                    g, torch.zeros((5, 3, 0), dtype=torch.int32), off, 10),
                embedding_bag_features_grad(
                    g[:0], torch.zeros((0, 3, 2), dtype=torch.int32), off, 10),
                hot_embedding_bag_grad(
                    g[:, 0], torch.zeros((5, 0), dtype=torch.int32), 10)):
        assert torch.equal(got, zeros)
