"""The hand-written kernels on the card, against their plain versions.

K1 (the embedding bag) at every row geometry its CUDA source instantiates:
D in {16, ..., 256} and P in {1, ..., 200}, in f32 and bf16, with -1 inside
bags and bags that are all padding (exactly zero), an unaligned table view
(the scalar path), two launches bitwise equal, the per-feature entry bitwise
equal to the 2-D entry on the shifted ids, and the hot/cold pooling and
``embedding_bag_local`` on the card against their CPU results.

The redesigned attention kernels: K3's int8 entry (within the bf16/f32 tolerance of its plain
version, and bitwise equal to the entry in q's dtype on the cache
dequantised eagerly), K3's bf16 entry at the head sizes its CUDA-core
variant takes, and K2's tensor-core variant at ragged Tq/Tk, with
q_offset, at head sizes 64 and 128.

K4 (the fleet FIFO solver) bitwise against its plain version and against
``engine._sweep``: every register bucket and the generic instance (k in
{1, 2, 3, 5, 8, 16, 17, 20, 33, 40}), empty streams, ``free0`` given and
not, streams of very different lengths, several k-groups in one launch,
8 streams of 150,000 jobs (a full-width day's shape), a launch repeated,
``fleet_fifo_finish(device="cuda")``, and a missing library raising.

Imports neither jax nor the reference, so it runs where the card is:
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``.  Without
a card every test skips.  Tolerances are those of tests/test_kernels.py:
K1 f32 1e-5, attention f32 2e-4, bf16 3e-2."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (
    attention_ref,
    flash_attention,
    flash_decode,
    flash_decode_int8,
    flash_decode_int8_ref,
    flash_decode_ref,
)
from repro_torch.kernels.embedding_bag import (
    embedding_bag_features,
    embedding_bag_features_ref,
    hot_embedding_bag,
    hot_embedding_bag_ref,
    ops as k1_ops,
)
from repro_torch.kernels.embedding_bag.ref import shift_feature_ids
from repro_torch.kernels.flash_attention.ref import dequantize_kv
from repro_torch.kernels.fleet_fifo import fleet_fifo, fleet_fifo_ref
from repro_torch.kernels.fleet_fifo import ops as k4_ops
from repro_torch.models import embedding as emb
from repro_torch.serving import event_core
from repro_torch.serving.engine import _sweep

pytestmark = pytest.mark.cuda

TOL = {"f32": 2e-4, "bf16": 3e-2}
K1_TOL = {"f32": 1e-5, "bf16": 3e-2}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
EMPTY_BAGS = [3, 17]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _int8_cache(seed, B, S, KVH, hd, device):
    """An int8 cache and f32 scales in [0.005, 0.02] on ``device``."""
    rng = np.random.default_rng(seed)
    kq, vq = (rng.integers(-127, 128, (B, S, KVH, hd), dtype=np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.005, 0.02, (B, S, KVH, 1)).astype(np.float32)
              for _ in range(2))
    return [torch.from_numpy(a).to(device) for a in (kq, ks, vq, vs)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kv_len,kv_offset", [(700, 0), (333, 0), (900, 300)])
def test_int8_decode_matches_plain(cuda_device, dtype, kv_len, kv_offset):
    tdt = TDT[dtype]
    B, S, H, KVH, hd = 2, 700, 6, 2, 128
    q = (torch.from_numpy(_normal(3, (B, 1, H, hd))[0]) * 8).to(cuda_device,
                                                               tdt)
    kq, ks, vq, vs = _int8_cache(4, B, S, KVH, hd, cuda_device)
    got = flash_decode_int8(q, kq, ks, vq, vs, kv_len=kv_len,
                            kv_offset=kv_offset)
    want = flash_decode_int8_ref(q, kq, ks, vq, vs, kv_len=kv_len,
                                 kv_offset=kv_offset)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    same = flash_decode(q, dequantize_kv(kq, ks, tdt),
                        dequantize_kv(vq, vs, tdt), kv_len=kv_len,
                        kv_offset=kv_offset)
    assert torch.equal(got, same)
    torch.cuda.synchronize()


@pytest.mark.parametrize("hd", [8, 16, 32])
def test_bf16_decode_small_heads(cuda_device, hd):
    """bf16 head sizes off the tensor-core variant take the CUDA-core one;
    the int8 entry keeps to the tensor-core sizes."""
    B, S, H, KVH = 2, 700, 6, 2
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
               for a in _normal(hd, (B, 1, H, hd), (B, S, KVH, hd),
                                (B, S, KVH, hd)))
    got = flash_decode(q, k, v, kv_len=650, kv_offset=0)
    want = flash_decode_ref(q.float(), k.float(), v.float(), kv_len=650)
    torch.testing.assert_close(got.float(), want, rtol=TOL["bf16"],
                               atol=TOL["bf16"])
    kq, ks, vq, vs = _int8_cache(5, B, S, KVH, hd, cuda_device)
    with pytest.raises(ValueError):
        flash_decode_int8(q, kq, ks, vq, vs, kv_len=650)
    torch.cuda.synchronize()


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal,q_offset,tq", [(True, 133, 200),
                                                (False, 0, 200),
                                                (True, 0, 129)])
def test_flash_attention_ragged_and_offset(cuda_device, hd, causal, q_offset,
                                           tq):
    """Tq and Tk not multiples of the kernel's 128-row tiles."""
    qn, kn, vn = _normal(hd, (2, tq, 6, hd), (2, 333, 2, hd), (2, 333, 2, hd))
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
               for a in (qn * 8, kn, vn))
    got = flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    want = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                         q_offset=q_offset)
    torch.testing.assert_close(got.float(), want, rtol=TOL["bf16"],
                               atol=TOL["bf16"])
    torch.cuda.synchronize()


def _k1_ids(rng, shape, H, pad=0.3):
    """ids in [0, H) with a share ``pad`` of -1 anywhere in a bag."""
    ids = rng.integers(0, H, shape).astype(np.int32)
    ids[rng.random(shape) < pad] = -1
    return ids


def _k1_table(rng, H, D, dtype, device):
    t = rng.standard_normal((H, D)).astype(np.float32)
    return torch.from_numpy(t).to(device, TDT[dtype])


def _k1_check(table, ids, dtype):
    """K1 against its plain version, twice (bitwise equal), one launch each;
    the bags of EMPTY_BAGS are all padding and must pool to exactly 0."""
    before = k1_ops.launches
    got = hot_embedding_bag(table, ids)
    again = hot_embedding_bag(table, ids)
    torch.cuda.synchronize()
    assert k1_ops.launches == before + 2
    want = hot_embedding_bag_ref(table, ids)
    assert got.dtype == table.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=K1_TOL[dtype],
                               atol=K1_TOL[dtype])
    assert torch.equal(got, again)
    assert not got[EMPTY_BAGS].any()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("P", [1, 30, 33, 80, 200])
@pytest.mark.parametrize("D", [16, 32, 48, 64, 128, 256])
def test_k1_matches_plain(cuda_device, D, P, dtype):
    rng = np.random.default_rng(D * 1000 + P)
    H, B = 5000, 37
    ids = _k1_ids(rng, (B, P), H)
    ids[EMPTY_BAGS] = -1
    _k1_check(_k1_table(rng, H, D, dtype, cuda_device),
              torch.from_numpy(ids).to(cuda_device), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("D", [4, 8, 12, 24, 40, 96, 520, 1024])
def test_k1_other_row_geometries(cuda_device, D, dtype):
    """Rows of 1-2 vectors (one or two lanes a bag), widths that leave
    lanes idle, and rows past 128 vectors (column blocks)."""
    rng = np.random.default_rng(D)
    H, B, P = 3000, 300, 40
    ids = _k1_ids(rng, (B, P), H)
    ids[EMPTY_BAGS] = -1
    _k1_check(_k1_table(rng, H, D, dtype, cuda_device),
              torch.from_numpy(ids).to(cuda_device), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("D", [16, 32, 48, 64])
def test_k1_unaligned_table_scalar_path(cuda_device, D, dtype):
    """A table view at storage offset 1 is not 16-byte aligned: the
    kernel's scalar path."""
    rng = np.random.default_rng(D + 7)
    H, B, P = 2000, 37, 80
    dense = _k1_table(rng, H, D, dtype, cuda_device)
    buf = torch.empty(H * D + 1, dtype=dense.dtype, device=cuda_device)
    buf[1:] = dense.flatten()
    table = buf[1:].view(H, D)
    assert table.storage_offset() == 1 and table.is_contiguous()
    ids = _k1_ids(rng, (B, P), H)
    ids[EMPTY_BAGS] = -1
    _k1_check(table, torch.from_numpy(ids).to(cuda_device), dtype)


def test_k1_many_bags_take_several_rounds(cuda_device):
    """More bags than the resident lane groups: groups take a second bag."""
    rng = np.random.default_rng(11)
    H, B, P, D = 100_000, 60_000, 20, 32
    ids = _k1_ids(rng, (B, P), H)
    ids[EMPTY_BAGS] = -1
    _k1_check(_k1_table(rng, H, D, "f32", cuda_device),
              torch.from_numpy(ids).to(cuda_device), "f32")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("P", [30, 80])
def test_k1_features_entry_equals_2d_entry(cuda_device, P, dtype):
    """ids [B, F, P] with per-feature offsets: bitwise the 2-D entry on the
    shifted ids; feature 3's negative offset pools it to exactly zero."""
    rng = np.random.default_rng(P)
    B, D = 37, 32
    sizes = [700, 300, 900, 400, 500]
    off = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    off[3] = -1
    ids = np.stack([_k1_ids(rng, (B, P), v) for v in sizes], axis=1)
    table = _k1_table(rng, sum(sizes), D, dtype, cuda_device)
    ids_t = torch.from_numpy(ids).to(cuda_device)
    off_t = torch.from_numpy(off).to(cuda_device)
    before = k1_ops.launches
    got = embedding_bag_features(table, ids_t, off_t)
    torch.cuda.synchronize()
    assert k1_ops.launches == before + 1
    assert got.shape == (B, len(sizes), D)
    flat = shift_feature_ids(ids_t, off_t).to(torch.int32).reshape(-1, P)
    assert torch.equal(got, hot_embedding_bag(table, flat).reshape(got.shape))
    assert not got[:, 3].any()
    want = embedding_bag_features_ref(table, ids_t, off_t)
    torch.testing.assert_close(got.float(), want.float(), rtol=K1_TOL[dtype],
                               atol=K1_TOL[dtype])


def _emb_case(seed=1, B=24, **kw):
    base = dict(vocab_sizes=(1000, 500, 2000), dim=16, pooling=(8, 4, 12))
    base.update(kw)
    cfg = emb.EmbeddingConfig(**base)
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(
        rng.uniform(-1, 1, (cfg.total_rows, cfg.dim)).astype(np.float32))
    ids = np.full((B, cfg.num_features, cfg.max_pooling), -1, np.int32)
    for f in range(cfg.num_features):
        counts = rng.integers(0, cfg.pooling[f] + 1, B)
        for b in range(B):
            ids[b, f, :counts[b]] = rng.integers(0, cfg.vocab_sizes[f],
                                                 counts[b])
    return cfg, table, torch.from_numpy(ids)


@pytest.mark.parametrize("qr", [False, True])
def test_embedding_bag_local_on_card(cuda_device, qr):
    """One K1 launch a call, its offsets built once per (config, device);
    the result is the CPU path's."""
    kw = dict(vocab_sizes=(1000, 5000, 300), qr_features=(1,),
              qr_buckets=64, combine="mean") if qr else {}
    cfg, table, ids = _emb_case(**kw)
    want = emb.embedding_bag_local({"table": table}, ids, cfg)
    params = {"table": table.to(cuda_device)}
    before = k1_ops.launches
    got = emb.embedding_bag_local(params, ids.to(cuda_device), cfg)
    torch.cuda.synchronize()
    assert k1_ops.launches == before + 1
    off = emb.routed_offsets(cfg, got.device)
    assert off.device == got.device and off is emb.routed_offsets(cfg, got.device)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


def test_k1_hot_cold_on_card(cuda_device):
    cfg, table, ids = _emb_case()
    layout = emb.make_hot_cold_layout(cfg, 1200)
    cpu = emb.embedding_bag_hot_cold(
        emb.split_hot_cold({"table": table}, layout), ids, layout)
    split = emb.split_hot_cold({"table": table.to(cuda_device)}, layout)
    before = k1_ops.launches
    card = emb.embedding_bag_hot_cold(split, ids.to(cuda_device), layout)
    torch.cuda.synchronize()
    assert k1_ops.launches == before + 2
    for got, want in zip(card, cpu):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# K4: the fleet FIFO solver
# ---------------------------------------------------------------------------

def _k4_streams(seed, spec):
    """``spec``: (k, n, with_free0) per stream -> (ready, dur, k, free0)."""
    rng = np.random.default_rng(seed)
    out = []
    for k, n, with_f0 in spec:
        r = rng.exponential(0.2 / k, n).cumsum()
        d = rng.choice(rng.uniform(0.01, 0.8, 4), n)
        f0 = rng.uniform(0.0, 3.0, k) if with_f0 else None
        out.append((r, d, k, f0))
    return out


def _k4_pack(streams, device, pad=2):
    ks = [s[2] for s in streams]
    offsets = np.concatenate([[0], np.cumsum([len(s[0]) for s in streams])])
    free0 = np.full((len(streams), max(ks) + pad), 5.0)
    for j, s in enumerate(streams):
        free0[j, :ks[j]] = 0.0 if s[3] is None else s[3]
    cat = [np.concatenate([s[i] for s in streams]) for i in (0, 1)]
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (cat[0], cat[1], offsets.astype(np.int64))], ks, \
        torch.from_numpy(free0).to(device)


def _k4_check(streams, device, plain=True):
    (ready, dur, offsets), ks, free0 = _k4_pack(streams, device)
    before = k4_ops.launches
    ends, state = fleet_fifo(ready, dur, offsets, ks, free0)
    torch.cuda.synchronize()
    assert k4_ops.launches == before + 1
    ends, state = ends.cpu().numpy(), state.cpu().numpy()
    off = offsets.cpu().numpy()
    for j, s in enumerate(streams):
        we, ws = _sweep(s[0], s[1], s[2], s[3], return_state=True)
        assert np.array_equal(ends[off[j]:off[j + 1]], we), j
        assert np.array_equal(np.sort(state[j, :ks[j]]), ws), j
    if plain:
        (r, d, o), _, f = _k4_pack(streams, "cpu")
        pe, ps = fleet_fifo_ref(r, d, o, ks, f)
        # the same slot wins every tie (the first), so even the unsorted
        # state and its +inf columns past k agree
        assert np.array_equal(pe.numpy(), ends)
        assert np.array_equal(ps.numpy(), state)
    return ends, state


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 16, 17, 20, 33, 40])
def test_k4_every_bucket(cuda_device, k):
    spec = [(k, n, i % 2 == 0) for i, n in
            enumerate([0, 1, 7, 64, 300, 1000, 2500, 33, 5, 129])]
    _k4_check(_k4_streams(k, spec), cuda_device)


def test_k4_several_groups_one_launch(cuda_device):
    ks = [1, 2, 3, 4, 5, 8, 9, 16, 17, 20, 32, 33, 40]
    rng = np.random.default_rng(1)
    spec = [(int(rng.choice(ks)), int(rng.integers(0, 800)), i % 3 == 0)
            for i in range(150)]
    _k4_check(_k4_streams(2, spec), cuda_device)


def test_k4_lengths_far_apart_and_empty(cuda_device):
    spec = [(3, 0, True), (3, 20000, False), (3, 1, False), (5, 0, False),
            (5, 3, True), (17, 12000, True), (17, 0, True), (2, 40000, False)]
    _k4_check(_k4_streams(3, spec), cuda_device)


def test_k4_full_width_day_shape(cuda_device):
    """8 streams of 150,000 jobs at k = 17 (the longest chain of a
    full-width day), held to the sweep only: the plain version's time-step
    loop is too slow at this length."""
    _k4_check(_k4_streams(4, [(17, 150_000, i % 2 == 0) for i in range(8)]),
              cuda_device, plain=False)


def test_k4_repeat_launch_bitwise(cuda_device):
    streams = _k4_streams(5, [(k, 500, True) for k in (2, 5, 17, 40)] * 8)
    (ready, dur, offsets), ks, free0 = _k4_pack(streams, cuda_device)
    a = fleet_fifo(ready, dur, offsets, ks, free0)
    b = fleet_fifo(ready, dur, offsets, ks, free0)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _engine_test_streams(seed, n_streams=24):
    """The streams of tests/test_engine.py::TestEventCoreFleet."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_streams):
        n = int(rng.integers(1, 120))
        r = rng.exponential(0.2, n).cumsum()
        d = rng.choice(rng.uniform(0.01, 0.8, 4), n)
        k = int(rng.choice([2, 2, 4, 8]))
        f0 = rng.uniform(0.0, 3.0, k) if i % 3 == 0 else None
        out.append((r, d, k, f0) if f0 is not None else (r, d, k))
    return out


@pytest.mark.parametrize("seed", [0, 7, 23])
def test_k4_fleet_fifo_finish_on_card(cuda_device, seed, monkeypatch):
    monkeypatch.setattr(event_core, "_MIN_FLEET_WIDTH", 1)
    streams = _engine_test_streams(seed)
    before = k4_ops.launches
    got = event_core.fleet_fifo_finish(streams, device="cuda")
    assert k4_ops.launches == before + 1  # every wide group in one launch
    cpu = event_core.fleet_fifo_finish(streams, device="cpu")
    for s, (e, st), (ce, cs) in zip(streams, got, cpu):
        we, ws = _sweep(s[0], s[1], s[2], s[3] if len(s) > 3 else None,
                        return_state=True)
        assert np.array_equal(e, we) and np.array_equal(st, ws)
        assert np.array_equal(ce, we) and np.array_equal(cs, ws)


def test_k4_missing_library_raises(cuda_device, monkeypatch):
    def missing(name):
        raise OSError(f"no library for {name}")

    monkeypatch.setattr(k4_ops, "_fn", None)
    monkeypatch.setattr(k4_ops._build, "load", missing)
    (ready, dur, offsets), ks, free0 = _k4_pack(
        _k4_streams(6, [(3, 10, False)] * 4), cuda_device)
    with pytest.raises(OSError, match="no library"):
        fleet_fifo(ready, dur, offsets, ks, free0)
