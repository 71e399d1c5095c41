"""The hand-written kernels on the card, against their plain versions.

K1 (the embedding bag) at every row geometry its CUDA source instantiates:
D in {16, ..., 256} and P in {1, ..., 200}, in f32 and bf16, with -1 inside
bags and bags that are all padding (exactly zero), an unaligned table view
(the scalar path), two launches bitwise equal, the per-feature entry bitwise
equal to the 2-D entry on the shifted ids, its feature-major walk at
launches of several waves (rm2's rows, MT-WnD's deep and wide one-id bags,
f32 rows at P = 8, through a row window, and rmc1's one-wave launch)
bitwise equal to the item order with the launches it counts as
table-major, and the hot/cold pooling and ``embedding_bag_local`` on the
card against their CPU results.  The recsys
slice's rows: D = 1 (MT-WnD's wide table) and 18 (DIN) at P = 1 and 3
through both entries; MT-WnD's SparseNet (two launches) and DIN / DIEN
logits on the card against the CPU.

K1's backward (the dense table gradient) against its plain version at
D = 1, 18, 32, 64 and P = 1, 3, 64 in f32 and bf16, with padding, empty
bags, ids read twice in a bag and a feature left unrouted (untouched rows
exactly zero, two launches bitwise equal), at every row geometry of its
sums pass (D = 1, 8, 32, 64, 100, 128, 256, 300), at H = 1, at an H that
is not a multiple of the zero sweep's 32 rows and with the last row read,
a run of one row across many of the kernel's chunks, its pairs and sort
stages bitwise against their plain version (0, 2 and 4 radix passes; ids
past the table), a table of 2**27 - 3 rows, no valid pair, an empty
batch and bags of no slot (zeros), ids of 2**31 slots refused (and 2**30
bags refused by the forward, 2**30 - 1 launched), dirty memory
under the output (every row written), the 2-D entry and autograd through
both entries;
one recsys (wide-deep) and one GNN (full_graph_sm) train step against a
CPU copy; one LM train step (a small f32 LM, dense with the chunked
attention and MoE) against a CPU copy; a ``CheckpointManager`` roundtrip
of CUDA tensors, bf16 included.

K1's row window (a rank's shard of a row-sharded table): windows at the
table's start, middle and end and one holding no id, a shard of no rows,
the float32 store against the table-dtype store, the windows' float32
partials summing to the whole pool, and the window (0, H) bitwise the
unwindowed entry.  K1's backward through a row window: windows cutting a
feature, holding a hot row's run, the last rows, one past every id and
one of no rows, against the plain version and against the unwindowed
backward's rows; autograd through the window's float32 partial into the
bf16 window backward.  K3's int8 partials: a shard wholly past kv_len is
exactly (-1e30, 0, 0), and the two halves' partials merged by
``lse_combine`` equal the whole-cache int8 entry.

The redesigned attention kernels: K3's int8 entry (within the bf16/f32 tolerance of its plain
version, and bitwise equal to the entry in q's dtype on the cache
dequantised eagerly), both K3 entries at the LM configs' KV groups 1, 7
and 8, K3's bf16 entry at the head sizes its CUDA-core variant takes, and K2's tensor-core variant at ragged Tq/Tk, with
q_offset, at head sizes 64 and 128.

K3's partials entry from a cache in q's dtype: two halves' partials
merged to the whole-cache entry.

K4 (the fleet FIFO solver) bitwise against its plain version and against
``engine._sweep``, its state rows sorted: every register instance (k = 1
.. 33 and 40, the generic one past 32), streams of the shared-memory
chunk's edge lengths (C - 1, C, C + 1, 2C + 1) starting at odd indices of
the ragged layout, empty streams, ``free0`` given and not and with
repeated values, lanes of one warp 100x apart in length, several k-groups
in one launch, 8 streams of 150,000 jobs (a full-width day's shape), a
launch repeated, ``fleet_fifo_finish(device="cuda")``, the bare
``launch`` and the event core's ``fleet_fifo_streams`` by name, and a
missing library raising.

The dry run's shape-only path (``repro_torch.kernels.fake``) leaves the
card's alone: each K1, K1-backward and K3 entry on CUDA tensors still
launches its kernel (its count moves by one, nothing is reported), and the
host copy of K1's backward scratch plan (``grad_scratch_bytes``) equals the
kernel's own layout at five shapes.

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
    flash_decode_int8_partials,
    flash_decode_int8_partials_ref,
    flash_decode_int8_ref,
    flash_decode_partials_ref,
    flash_decode_ref,
    lse_combine,
)
from repro_torch.kernels.flash_attention import ops as k3_ops
from repro_torch.kernels.embedding_bag import (
    embedding_bag_features,
    embedding_bag_features_grad,
    embedding_bag_features_grad_ref,
    embedding_bag_features_ref,
    embedding_bag_window_ref,
    hot_embedding_bag,
    hot_embedding_bag_grad,
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
from torch_recsys_util import cut_vocab

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


def _window_case(dtype, device, D=64, B=300, P=40):
    """A combined table of three features and per-feature ids on ``device``
    with their int64 offsets."""
    rng = np.random.default_rng(D + P)
    sizes = (3000, 700, 1300)
    off = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    ids = np.stack([_k1_ids(rng, (B, P), v) for v in sizes], axis=1)
    ids[EMPTY_BAGS] = -1
    table = _k1_table(rng, int(sum(sizes)), D, dtype, device)
    return (table, torch.from_numpy(ids).to(device),
            torch.from_numpy(off).to(device))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("where", ["start", "middle", "end", "no_ids",
                                   "no_rows"])
def test_k1_row_window_matches_plain(cuda_device, where, dtype):
    """One rank's rows [lo, hi) of the table: its window against the plain
    version, in float32 and in the table's dtype (the float32 store
    rounded is the table-dtype store, bitwise), one launch each."""
    table, ids, off = _window_case(dtype, cuda_device)
    H = table.shape[0]
    lo, hi = {"start": (0, 1700), "middle": (1700, 3400),
              "end": (3400, H), "no_ids": (H, H + 64),
              "no_rows": (2000, 2000)}[where]
    shard = table[lo:hi].contiguous() if where != "no_ids" else \
        torch.randn((64, table.shape[1]), device=cuda_device).to(table.dtype)
    before = k1_ops.window_launches
    f32 = embedding_bag_features(shard, ids, off, row_window=(lo, hi),
                                 out_dtype=torch.float32)
    own = embedding_bag_features(shard, ids, off, row_window=(lo, hi))
    torch.cuda.synchronize()
    assert k1_ops.window_launches == before + (0 if where == "no_rows"
                                               else 2)
    want = embedding_bag_window_ref(shard, ids, off, (lo, hi),
                                    torch.float32)
    assert f32.dtype == torch.float32 and own.dtype == table.dtype
    torch.testing.assert_close(f32, want, rtol=K1_TOL["f32"],
                               atol=K1_TOL["f32"])
    assert torch.equal(f32.to(table.dtype), own)
    if where in ("no_ids", "no_rows"):
        assert not f32.any()
    assert not f32[EMPTY_BAGS].any()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_k1_row_windows_sum_to_the_pool(cuda_device, dtype):
    """The float32 partials of three windows that tile the table sum to
    the unwindowed pool; the window (0, H) is the unwindowed entry,
    bitwise."""
    table, ids, off = _window_case(dtype, cuda_device)
    H = table.shape[0]
    whole = embedding_bag_features(table, ids, off)
    full = embedding_bag_features(table, ids, off, row_window=(0, H))
    assert torch.equal(full, whole)
    cuts = (0, 1111, 3001, H)
    parts = sum(embedding_bag_features(table[a:b].contiguous(), ids, off,
                                       row_window=(a, b),
                                       out_dtype=torch.float32)
                for a, b in zip(cuts, cuts[1:]))
    want = embedding_bag_features(table, ids, off, out_dtype=torch.float32)
    torch.testing.assert_close(parts, want, rtol=K1_TOL["f32"],
                               atol=K1_TOL["f32"])
    torch.testing.assert_close(parts.to(table.dtype).float(), whole.float(),
                               rtol=K1_TOL[dtype], atol=K1_TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_int8_partials_shard_past_kv_len(cuda_device, dtype):
    """A shard wholly past kv_len contributes exactly the empty partial."""
    B, S, H, KVH, hd = 2, 512, 8, 2, 128
    q = torch.from_numpy(_normal(6, (B, 1, H, hd))[0]).to(cuda_device,
                                                          TDT[dtype])
    kq, ks, vq, vs = _int8_cache(7, B, S, KVH, hd, cuda_device)
    before = k3_ops.launches["flash_decode_int8_partials"]
    m, l, o = flash_decode_int8_partials(q, kq, ks, vq, vs, kv_len=600,
                                         kv_offset=600)
    torch.cuda.synchronize()
    assert k3_ops.launches["flash_decode_int8_partials"] == before + 1
    assert m.shape == (B, KVH, H // KVH, 1) and o.shape == (B, KVH, H // KVH,
                                                             hd)
    assert bool((m == -1e30).all()) and not l.any() and not o.any()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kv_len", [1000, 700, 300])
def test_int8_partials_halves_merge_to_whole(cuda_device, dtype, kv_len):
    """The partials of the cache's two halves (kv_offset 0 and S / 2),
    each against its plain version, merged with ``lse_combine``: the
    whole-cache int8 entry."""
    B, S, H, KVH, hd = 2, 1000, 8, 2, 128
    tdt = TDT[dtype]
    q = (torch.from_numpy(_normal(8, (B, 1, H, hd))[0]) * 8).to(cuda_device,
                                                               tdt)
    kq, ks, vq, vs = _int8_cache(9, B, S, KVH, hd, cuda_device)
    parts = []
    for lo in (0, S // 2):
        sl = [t[:, lo:lo + S // 2].contiguous() for t in (kq, ks, vq, vs)]
        got = flash_decode_int8_partials(q, *sl, kv_len=kv_len, kv_offset=lo)
        want = flash_decode_int8_partials_ref(q, *sl, kv_len=kv_len,
                                              kv_offset=lo)
        for g, w in zip(got[1:], want[1:]):
            torch.testing.assert_close(g, w, rtol=TOL[dtype], atol=TOL[dtype])
        parts.append(got)
    m, l, o = (torch.stack(t) for t in zip(*parts))
    _, l_c, o_c = lse_combine(m, l, o, axis=0)
    merged = (o_c / l_c.clamp_min(1e-30)).to(tdt).reshape(B, 1, H, hd)
    whole = flash_decode_int8(q, kq, ks, vq, vs, kv_len=kv_len)
    torch.cuda.synchronize()
    torch.testing.assert_close(merged.float(), whole.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kv_len", [1000, 700, 300])
def test_partials_halves_merge_to_whole(cuda_device, dtype, kv_len):
    """K3's partials entry from a cache in q's dtype (what a shard of the
    sequence-sharded decode runs): the two halves' partials (kv_offset 0
    and S / 2; at kv_len 300 the second is wholly past it), each against
    its plain version, one launch each, merged with ``lse_combine``: K3
    over the whole cache."""
    B, S, H, KVH, hd = 2, 1000, 8, 2, 128
    tdt = TDT[dtype]
    q = (torch.from_numpy(_normal(10, (B, 1, H, hd))[0]) * 8).to(cuda_device,
                                                                tdt)
    k, v = (torch.from_numpy(a).to(cuda_device, tdt)
            for a in _normal(11, (B, S, KVH, hd), (B, S, KVH, hd)))
    parts = []
    before = k3_ops.launches["flash_decode"]
    for lo in (0, S // 2):
        ks, vs = (t[:, lo:lo + S // 2].contiguous() for t in (k, v))
        got = k3_ops.flash_decode_partials(q, ks, vs, kv_len=kv_len,
                                           kv_offset=lo)
        want = flash_decode_partials_ref(q, ks, vs, kv_len=kv_len,
                                         kv_offset=lo)
        for g, w in zip(got[1:], want[1:]):
            torch.testing.assert_close(g, w, rtol=TOL[dtype], atol=TOL[dtype])
        parts.append(got)
    torch.cuda.synchronize()
    assert k3_ops.launches["flash_decode"] == before + 2
    m, l, o = (torch.stack(t) for t in zip(*parts))
    _, l_c, o_c = lse_combine(m, l, o, axis=0)
    merged = (o_c / l_c.clamp_min(1e-30)).to(tdt).reshape(B, 1, H, hd)
    whole = flash_decode(q, k, v, kv_len=kv_len)
    torch.testing.assert_close(merged.float(), whole.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


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


def _zipf_ids(g, B, F, P, V, device):
    """ids [B, F, P] int32 drawn by the benchmark's traffic generator
    (``bench/gen.py``) at its traffics' parameters: Zipf over V rows a
    table (alpha 1.05, id 0 hottest), lognormal bag counts around 0.6 x P,
    -1 past them."""
    from bench import gen

    traffic = {"zipf_alpha": 1.05, "pooling_share": 0.6,
               "pooling_sigma": 0.6}
    sizes = {"vocab_sizes": [V] * F, "pooling": [P] * F}
    return gen.draw_batch(sizes, traffic, B, g, device)["sparse_ids"]


# (dtype, D, P, items, rows a table, row window, table-major launches): the
# rm2 cells' rows (bf16, 128 bytes, multi-hot), f32 rows of 128 bytes at
# P = 8, MT-WnD's deep (f32, 128 bytes) and wide (D = 1) one-id bags, at 26
# tables of 32,768 items, more than the resident teams; the rm2 rows
# through a row window; rmc1's 1,024-item launch, whose bags all fit one
# wave.  One-id bags and D = 1 keep the item order.
TABLE_MAJOR = {
    "rm2": ("bf16", 64, 64, 32_768, 200_000, None, 1),
    "f32_p8": ("f32", 32, 8, 32_768, 200_000, None, 1),
    "mtwnd_deep": ("f32", 32, 1, 32_768, 200_000, None, 0),
    "mtwnd_wide": ("f32", 1, 1, 32_768, 200_000, None, 0),
    "rm2_window": ("bf16", 64, 64, 32_768, 200_000, (1_300_000, 3_900_000),
                   1),
    "rmc1_1024": ("f32", 32, 80, 1_024, 200_000, None, 0),
}


@pytest.mark.parametrize("case", list(TABLE_MAJOR))
def test_k1_table_major_walk_equals_item_order(cuda_device, case):
    """The per-feature entry at launches of several waves (26 features of
    32,768 items; rmc1's 10 of 1,024) walks its bags feature by feature
    where a bag's row and its ids each fill a 32-byte sector: bitwise the
    item order's output
    (the same launch of ids [B * F, 1, P] on the shifted ids, one feature,
    which keeps the item order), through a row window too, and near the
    plain version on the first items.  ``table_major_launches`` moves by
    one only where a feature's bags outnumber the resident teams and the
    walk applies."""
    dtype, D, P, B, V, window, counted = TABLE_MAJOR[case]
    F = 10 if case == "rmc1_1024" else 26
    g = torch.Generator(cuda_device).manual_seed(D * 100 + P)
    ids = _zipf_ids(g, B, F, P, V, cuda_device)
    off = torch.arange(F, dtype=torch.int64, device=cuda_device) * V
    table = torch.empty((F * V, D), device=cuda_device).uniform_(
        -1, 1, generator=g).to(TDT[dtype])
    kw, ref = {}, embedding_bag_features_ref
    if window is not None:
        lo, hi = window
        table = table[lo:hi].contiguous()
        kw = dict(row_window=window, out_dtype=torch.float32)

        def ref(t, i, o):
            return embedding_bag_window_ref(t, i, o, window, torch.float32)
    before = (k1_ops.launches + k1_ops.window_launches,
              k1_ops.table_major_launches)
    got = embedding_bag_features(table, ids, off, **kw)
    torch.cuda.synchronize()
    assert (k1_ops.launches + k1_ops.window_launches,
            k1_ops.table_major_launches) == (before[0] + 1,
                                             before[1] + counted)
    flat = shift_feature_ids(ids, off).to(torch.int32).reshape(B * F, 1, P)
    zero = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    items = embedding_bag_features(table, flat, zero, **kw)
    torch.cuda.synchronize()
    assert k1_ops.table_major_launches == before[1] + counted
    assert torch.equal(got, items.reshape(got.shape))
    tol = K1_TOL["f32" if window else dtype]
    torch.testing.assert_close(got[:256].float(),
                               ref(table, ids[:256], off).float(),
                               rtol=tol, atol=tol)


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


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("D", [1, 18])
def test_k1_recsys_rows_both_entries(cuda_device, D, P, dtype):
    """The rows of the recsys slice: MT-WnD's wide table (D = 1) and DIN's
    dim 18, neither a whole 16-byte vector (the scalar path), one-hot and
    short bags (P = 1 and 3, unvectorised ids), through the 2-D entry and
    the per-feature entry (bitwise the 2-D entry on the shifted ids)."""
    rng = np.random.default_rng(D * 10 + P)
    B, sizes = 37, [3000, 700, 1200]
    ids2 = _k1_ids(rng, (B, P), sum(sizes), pad=0.2)
    ids2[EMPTY_BAGS] = -1
    table = _k1_table(rng, sum(sizes), D, dtype, cuda_device)
    _k1_check(table, torch.from_numpy(ids2).to(cuda_device), dtype)
    off = torch.tensor([0, 3000, 3700], dtype=torch.int64, device=cuda_device)
    ids3 = torch.from_numpy(np.stack(
        [_k1_ids(rng, (B, P), v, pad=0.2) for v in sizes], axis=1)
    ).to(cuda_device)
    before = k1_ops.launches
    got = embedding_bag_features(table, ids3, off)
    torch.cuda.synchronize()
    assert k1_ops.launches == before + 1 and got.shape == (B, 3, D)
    flat = shift_feature_ids(ids3, off).to(torch.int32).reshape(-1, P)
    assert torch.equal(got, hot_embedding_bag(table, flat).reshape(got.shape))
    torch.testing.assert_close(
        got.float(), embedding_bag_features_ref(table, ids3, off).float(),
        rtol=K1_TOL[dtype], atol=K1_TOL[dtype])


def _recsys_batch(cfg, n, seed):
    from repro_torch.data.clicklog import ClickLogGenerator
    from repro_torch.models.recsys_base import batch_to_tensors

    batch = ClickLogGenerator(cfg, seed=seed).batch(n, with_labels=False)
    return batch_to_tensors(batch, torch.device("cpu"))


def _on(tree, device):
    return {k: _on(v, device) for k, v in tree.items()} if isinstance(
        tree, dict) else [_on(v, device) for v in tree] if isinstance(
        tree, list) else tree.to(device)


def test_widedeep_sparse_on_card(cuda_device):
    """MT-WnD's SparseNet on the card: two K1 launches (deep and wide
    tables), each the CPU result at K1's f32 tolerance; the logits within
    1e-4 of the CPU's."""
    from repro_torch.configs.paper_models import mt_wnd
    from repro_torch.models import widedeep

    cfg = cut_vocab(mt_wnd(True))
    cpu = widedeep.init(cfg, generator=torch.Generator().manual_seed(0),
                        device=torch.device("cpu"))
    tree = {"embedding": {"table": cpu.table}, "wide": {"table": cpu.wide},
            "wide_dense": cpu.wide_dense + 0.1,
            "deep_mlp": cpu.deep_mlp.layers(),
            "towers": [t.layers() for t in cpu.towers]}
    cpu = widedeep.WideDeep(cfg, tree)
    card = widedeep.WideDeep(cfg, _on(tree, cuda_device))
    batch = _recsys_batch(cfg, 300, 1)
    with torch.inference_mode():
        want_deep, want_wide = cpu.apply_sparse(batch)
        want = cpu(batch)
        on_card = _on(batch, cuda_device)
        before = k1_ops.launches
        deep, wide = card.apply_sparse(on_card)
        torch.cuda.synchronize()
        assert k1_ops.launches == before + 2
        got = card(on_card)
    torch.testing.assert_close(deep.cpu(), want_deep, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(wide.cpu(), want_wide, rtol=1e-5, atol=1e-5)
    assert got.shape == (300, 5)
    scale = float(want.abs().max())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("use_gru", [False, True])
def test_din_dien_logits_on_card(cuda_device, use_gru):
    """DIN / DIEN at their widths (dim 18, 200-step history) on a QR item
    table (3,000 ids in 47 + 64 rows), the logits within 1e-4 of the CPU's
    (scaled by the largest logit): f32 sums in other orders through 200
    GRU and 200 AUGRU steps."""
    import dataclasses

    from repro_torch.configs.paper_models import din as din_cfg
    from repro_torch.models import din

    cfg = dataclasses.replace(cut_vocab(din_cfg(False), qr_features=(0,),
                                     qr_buckets=64), use_gru=use_gru)
    cpu = din.init(cfg, generator=torch.Generator().manual_seed(0),
                   device=torch.device("cpu"))
    card = din.DIN(cfg, _on(cpu.tree(), cuda_device))
    batch = _recsys_batch(cfg, 256, 2)
    with torch.inference_mode():
        want = cpu(batch)
        got = card(_on(batch, cuda_device))
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    scale = float(want.abs().max())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4 * scale)


# ---------------------------------------------------------------------------
# K1's backward: the dense table gradient
# ---------------------------------------------------------------------------


def _k1_grad_case(rng, B, D, P, dtype, device, sizes=(3000, 700, 1200),
                  hot=0.0):
    """ids [B, 3, P] with padding, all-padding bags, duplicate ids in a
    bag and feature 1 unrouted; a share ``hot`` of the ids on row 7 of
    feature 0 (one run across many of the kernel's chunks)."""
    ids = np.stack([_k1_ids(rng, (B, P), v, pad=0.2) for v in sizes], axis=1)
    ids[EMPTY_BAGS[0] % B] = -1
    if P > 1:
        ids[:, 2, 1] = np.where(ids[:, 2, 0] >= 0, ids[:, 2, 0], ids[:, 2, 1])
    if hot:
        ids[:, 0][rng.random((B, P)) < hot] = 7
    off = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    off[1] = -1
    grad = rng.standard_normal((B, len(sizes), D)).astype(np.float32)
    return (torch.from_numpy(grad).to(device, TDT[dtype]),
            torch.from_numpy(ids).to(device), torch.from_numpy(off).to(device),
            sum(sizes))


def _k1_grad_check(grad, ids, off, H, dtype):
    """The kernel against its plain version (CPU, in float64: a hot row
    sums ~10^4 pairs, whose float32 rounding in either order reaches the
    f32 tolerance), twice bitwise, one launch each, every untouched row
    exactly zero."""
    before = k1_ops.grad_launches
    got = embedding_bag_features_grad(grad, ids, off, H)
    again = embedding_bag_features_grad(grad, ids, off, H)
    torch.cuda.synchronize()
    assert k1_ops.grad_launches == before + 2
    assert torch.equal(got, again)
    return _k1_grad_against_plain(got, grad, ids, off, H, dtype)


def _k1_grad_against_plain(got, grad, ids, off, H, dtype):
    assert got.dtype == grad.dtype and got.shape == (H, grad.shape[2])
    want = embedding_bag_features_grad_ref(grad.cpu().double(), ids.cpu(),
                                           off.cpu(), H)
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.cpu().float(), want.float(),
                               rtol=K1_TOL[dtype],
                               atol=K1_TOL[dtype] * max(scale, 1.0))
    touched = torch.zeros(H, dtype=torch.bool)
    rows = shift_feature_ids(ids.cpu(), off.cpu())
    touched[rows[rows >= 0]] = True
    assert not got.cpu()[~touched].any()
    return got


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("P", [1, 3, 64])
@pytest.mark.parametrize("D", [1, 18, 32, 64])
def test_k1_grad_matches_plain(cuda_device, D, P, dtype):
    rng = np.random.default_rng(D * 100 + P)
    _k1_grad_check(*_k1_grad_case(rng, 300, D, P, dtype, cuda_device), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("D", [1, 64, 300])
def test_k1_grad_long_run_across_chunks(cuda_device, D, dtype):
    """Half the ids of feature 0 on one row: a run of ~12,000 pairs over
    a dozen of the kernel's chunks (the join pass); D = 300 spans two
    column blocks."""
    rng = np.random.default_rng(D + 5)
    _k1_grad_check(*_k1_grad_case(rng, 400, D, 64, dtype, cuda_device,
                                  hot=0.5), dtype)


def test_k1_grad_2d_entry_and_autograd(cuda_device):
    """hot_embedding_bag's gradient (the 2-D entry) equals the per-feature
    entry's on the shifted ids, bitwise; autograd through both entries
    reaches the kernel once a backward."""
    rng = np.random.default_rng(3)
    grad, ids, off, H = _k1_grad_case(rng, 200, 32, 30, "f32", cuda_device)
    want = _k1_grad_check(grad, ids, off, H, "f32")
    flat = shift_feature_ids(ids, off).to(torch.int32).reshape(-1, 30)
    got = hot_embedding_bag_grad(grad.reshape(-1, 32), flat, H)
    assert torch.equal(got, want)
    table = torch.from_numpy(rng.standard_normal((H, 32)).astype(
        np.float32)).to(cuda_device).requires_grad_()
    before = (k1_ops.launches, k1_ops.grad_launches)
    g3, = torch.autograd.grad(embedding_bag_features(table, ids, off), table,
                              grad)
    g2, = torch.autograd.grad(hot_embedding_bag(table, flat), table,
                              grad.reshape(-1, 32))
    torch.cuda.synchronize()
    assert (k1_ops.launches, k1_ops.grad_launches) == (before[0] + 2,
                                                       before[1] + 2)
    assert torch.equal(g3, want) and torch.equal(g2, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("D", [1, 8, 32, 64, 100, 128, 256, 300])
def test_k1_grad_row_widths(cuda_device, D, dtype):
    """Every row geometry of the sums pass: rows of 1 to 8 whole 16-byte
    vectors through the cp.async sums (1, 2, 4 and 8 lanes a row), one
    element a lane elsewhere: a lane a chunk at D = 1, 32 lanes over the
    columns at D = 64 and wider in f32 and D = 100 and wider in bf16, with
    column blocks of 32 (up to 10 at D = 300)."""
    rng = np.random.default_rng(D * 7 + len(dtype))
    _k1_grad_check(*_k1_grad_case(rng, 200, D, 12, dtype, cuda_device),
                   dtype)


@pytest.mark.parametrize("case", ["one_row", "ragged_rows", "last_row"])
def test_k1_grad_table_edges(cuda_device, case):
    """H = 1 (no sort pass: every pair on row 0); H = 1,033, not a
    multiple of the 32 rows a warp of the zero sweep takes; the table's
    last row read by many pairs."""
    rng = np.random.default_rng(11)
    B, P, D = 150, 7, 32
    H = 1 if case == "one_row" else 1033
    ids = _k1_ids(rng, (B, 1, P), H)
    if case == "last_row":
        ids[rng.random(ids.shape) < 0.3] = H - 1
    grad = torch.from_numpy(rng.standard_normal((B, 1, D)).astype(
        np.float32)).to(cuda_device)
    off = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    got = _k1_grad_check(grad, torch.from_numpy(ids).to(cuda_device), off, H,
                         "f32")
    if case != "ragged_rows":
        assert got[H - 1].any()


def _k1_pairs_case(rng, H, layout, device):
    """ids with padding, an unrouted feature (features layout), the last
    row and ids past the table: (ids, offsets or None) on ``device``."""
    B, F, P = 300, 4, 20
    span = max(H // 3, 1)
    ids = rng.integers(-1, span + 40, (B, F, P)).astype(np.int32)
    ids[rng.random(ids.shape) < 0.2] = -1
    if layout == "flat":
        ids = ids.reshape(B * F, P)
        ids[:, 0] = H - 1
        ids[::3, 1] = H + 7  # past the table
        return torch.from_numpy(ids).to(device), None
    off = np.array([0, span, -1, H - span], np.int64)
    ids[:, 3, 0] = span - 1  # the table's last row
    return (torch.from_numpy(ids).to(device),
            torch.from_numpy(off).to(device))


@pytest.mark.parametrize("H", [1, 4900, 2**27 + 5])
@pytest.mark.parametrize("layout", ["features", "flat"])
def test_k1_grad_sorted_pairs_bitwise(cuda_device, layout, H):
    """The backward's pairs stage (its valid pairs in flat-index order) and
    its radix sort (no pass at H = 1, 2 at 13 bits, 4 at 28) bitwise
    against the plain version."""
    from repro_torch.kernels.embedding_bag.embedding_bag import GradLaunch
    from repro_torch.kernels.embedding_bag.ref import grad_sorted_pairs_ref

    rng = np.random.default_rng(H % 1000)
    ids, off = _k1_pairs_case(rng, H, layout, cuda_device)
    want_rows, want_flat = grad_sorted_pairs_ref(
        ids.cpu(), H, None if off is None else off.cpu())
    grad = torch.zeros((ids.numel() // ids.shape[-1], 1), device=cuda_device)
    call = GradLaunch(grad, ids, off, H)
    call.run(call.PAIRS)
    rows, flat = (t.cpu() for t in call.pairs())
    in_order = torch.argsort(want_flat)
    assert torch.equal(flat, want_flat[in_order])
    assert torch.equal(rows, want_rows[in_order])
    call.run(call.SORT)
    rows, flat = (t.cpu() for t in call.sorted_pairs())
    assert torch.equal(rows, want_rows) and torch.equal(flat, want_flat)


def test_k1_grad_three_sort_passes(cuda_device):
    """The gradient over a table of 2**27 - 3 rows (27 bits, as dlrm-rm2's:
    3 radix passes, the top row bits set) at D = 1, held to the plain
    version in float64 on the touched rows, every other row exactly 0."""
    from repro_torch.kernels.embedding_bag.ref import grad_sorted_pairs_ref

    H = 2**27 - 3
    rng = np.random.default_rng(5)
    ids, off = _k1_pairs_case(rng, H, "features", cuda_device)
    grad = torch.from_numpy(rng.standard_normal(
        (*ids.shape[:2], 1)).astype(np.float32)).to(cuda_device)
    got = embedding_bag_features_grad(grad, ids, off, H).cpu()[:, 0]
    rows, flat = grad_sorted_pairs_ref(ids.cpu(), H, off.cpu())
    u, inv = np.unique(rows.numpy(), return_inverse=True)
    want = np.zeros(u.size)
    np.add.at(want, inv, grad.cpu().double().reshape(-1).numpy()[
        flat.numpy() // ids.shape[2]])
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got[u].numpy(), want, rtol=K1_TOL["f32"],
                               atol=K1_TOL["f32"] * scale)
    got[torch.from_numpy(u)] = 0
    assert not got.any()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_k1_grad_no_valid_pairs(cuda_device, dtype):
    """No pair reads a row (padding, an unrouted feature, ids past the
    table), an empty batch and bags of no slot (P = 0), through both
    entries: zeros, written by the kernel, one call counted each."""
    H, D = 700, 16
    ids = np.full((40, 2, 6), -1, np.int32)
    ids[:, 1] = 3         # feature 1 is unrouted
    ids[:, 0, 0] = 5000   # past the table
    ids = torch.from_numpy(ids).to(cuda_device)
    off = torch.tensor([0, -1], dtype=torch.int64, device=cuda_device)
    grad = torch.ones((40, 2, D), dtype=TDT[dtype], device=cuda_device)
    before = k1_ops.grad_launches
    got = [embedding_bag_features_grad(grad, ids, off, H),
           embedding_bag_features_grad(grad[:0], ids[:0], off, H),
           hot_embedding_bag_grad(grad[:0, 0], ids[:0, 0], H),
           embedding_bag_features_grad(grad, ids[..., :0], off, H),
           hot_embedding_bag_grad(grad[:, 0], ids[:, 0, :0], H)]
    torch.cuda.synchronize()
    assert k1_ops.grad_launches == before + 5
    zeros = torch.zeros((H, D), dtype=TDT[dtype], device=cuda_device)
    for g in got:
        assert g.dtype == zeros.dtype and torch.equal(g, zeros)


def test_k1_forward_bag_limit(cuda_device):
    """The forward kernel's bag index is 32-bit: 2**30 - 1 bags launch
    through both entries (all padding but the last bag, which reads row
    3: exactly one nonzero output), and 2**30 bags are refused by both
    entries and the float32 store before any launch."""
    table = torch.arange(1, 5, dtype=torch.float32,
                         device=cuda_device).reshape(4, 1)
    off = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    n = 2**30 - 1
    ids = torch.full((n, 1), -1, dtype=torch.int32, device=cuda_device)
    ids[-1, 0] = 3
    before = k1_ops.launches
    for out in (hot_embedding_bag(table, ids),
                embedding_bag_features(table, ids.view(n, 1, 1), off)):
        assert out.shape[0] == n and float(out[-1].sum()) == 4.0
        assert int(torch.count_nonzero(out)) == 1
        del out
    assert k1_ops.launches == before + 2
    del ids
    big = torch.full((n + 1, 1), -1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="2\\*\\*30"):
        hot_embedding_bag(table, big)
    with pytest.raises(ValueError, match="2\\*\\*30"):
        embedding_bag_features(table, big.view(n + 1, 1, 1), off)
    with pytest.raises(ValueError, match="2\\*\\*30"):
        embedding_bag_features(table, big.view(n + 1, 1, 1), off,
                               out_dtype=torch.float32)
    assert k1_ops.launches == before + 2


def test_k1_grad_refuses_2_31_slots(cuda_device):
    """ids of 2**31 slots or more (the kernel's pair index is 32-bit) are
    refused by both entries before any work or launch (views of one
    element)."""
    one = torch.zeros((1, 1, 1), dtype=torch.int32, device=cuda_device)
    ids = one.expand(2**16, 2**10, 2**5)
    grad = torch.zeros((1, 1, 4), device=cuda_device).expand(
        2**16, 2**10, 4)
    off = torch.zeros(2**10, dtype=torch.int64, device=cuda_device)
    before = k1_ops.grad_launches
    with pytest.raises(ValueError, match="2\\*\\*31"):
        embedding_bag_features_grad(grad, ids, off, 10)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        hot_embedding_bag_grad(grad.reshape(2**26, 4),
                               ids.reshape(2**26, 2**5), 10)
    assert k1_ops.grad_launches == before


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_k1_grad_writes_every_row(cuda_device, dtype):
    """Every row is written by the kernel: a block of the output's size is
    filled with NaN and freed first, so PyTorch's caching allocator hands
    the kernel dirty memory; and a launch whose output is filled with NaN
    before it runs.  No untouched row is anything but 0."""
    from repro_torch.kernels.embedding_bag.embedding_bag import GradLaunch

    rng = np.random.default_rng(21)
    grad, ids, off, H = _k1_grad_case(rng, 300, 32, 8, dtype, cuda_device,
                                      sizes=(20000, 700, 9300))
    dirty = torch.full((H, 32), float("nan"), dtype=TDT[dtype],
                       device=cuda_device)
    del dirty
    _k1_grad_against_plain(embedding_bag_features_grad(grad, ids, off, H),
                           grad, ids, off, H, dtype)
    call = GradLaunch(grad.reshape(-1, 32), ids, off, H)
    call.out.fill_(float("nan"))
    _k1_grad_against_plain(call.run(), grad, ids, off, H, dtype)


# the row windows of K1's backward on _k1_grad_case's 4,900 rows (feature
# 0: rows 0-2999, feature 1 unrouted, feature 2: rows 3700-4899): one
# cutting feature 0, one holding the hot row 7, the last rows, one past
# every id's row, and a window of no rows
GRAD_WINDOWS = {"cut_feature": (1234, 3800), "hot_row": (5, 911),
                "last_rows": (4100, 4900), "no_ids": (4900, 5500),
                "no_rows": (2000, 2000)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("where", list(GRAD_WINDOWS))
def test_k1_grad_row_window_matches_plain(cuda_device, where, dtype):
    """K1's backward through a row window: against its plain version (in
    float64), twice bitwise, one launch counted as a window launch, every
    row of the window without a pair exactly zero; and against the
    unwindowed launch's rows [lo, hi) -- bitwise where no row's pairs
    cross one of the sums pass's chunks in either launch (the window's
    sorted pairs are a slice of the whole launch's, so the chunks fall
    elsewhere and a run that crosses one is joined in another grouping),
    else at K1's tolerance."""
    rng = np.random.default_rng(len(where) * 11 + len(dtype))
    grad, ids, off, H = _k1_grad_case(rng, 400, 64, 64, dtype, cuda_device,
                                      hot=0.3)
    lo, hi = GRAD_WINDOWS[where]
    before = (k1_ops.grad_launches, k1_ops.grad_window_launches)
    got = embedding_bag_features_grad(grad, ids, off, hi - lo,
                                      row_window=(lo, hi))
    again = embedding_bag_features_grad(grad, ids, off, hi - lo,
                                        row_window=(lo, hi))
    torch.cuda.synchronize()
    n = 0 if where == "no_rows" else 2
    assert (k1_ops.grad_launches, k1_ops.grad_window_launches) == (
        before[0] + n, before[1] + n)
    assert torch.equal(got, again)
    assert got.dtype == grad.dtype and got.shape == (hi - lo, 64)
    want = embedding_bag_features_grad_ref(grad.cpu().double(), ids.cpu(),
                                           off.cpu(), hi - lo,
                                           row_window=(lo, hi))
    scale = max(float(want.abs().max()) if want.numel() else 0.0, 1.0)
    torch.testing.assert_close(got.cpu().float(), want.float(),
                               rtol=K1_TOL[dtype], atol=K1_TOL[dtype] * scale)
    rows = shift_feature_ids(ids.cpu(), off.cpu())
    rows = rows[(rows >= lo) & (rows < hi)] - lo
    touched = torch.zeros(hi - lo, dtype=torch.bool)
    touched[rows] = True
    assert not got.cpu()[~touched].any()
    if where == "no_ids":
        assert not got.any()
    whole = embedding_bag_features_grad(grad, ids, off, H)[lo:min(hi, H)]
    part = got[:whole.shape[0]]
    if not torch.equal(part, whole):
        torch.testing.assert_close(part.float(), whole.float(),
                                   rtol=K1_TOL[dtype],
                                   atol=K1_TOL[dtype] * scale)


def test_k1_grad_row_window_autograd(cuda_device):
    """Autograd through the forward's row window into a float32 partial:
    the cotangent (float32 holding bf16 values, as the sharded embedding
    hands it back) is cast to the bf16 table exactly and the window's
    backward runs in bf16, equal to the backward called on the bf16
    cotangent, bitwise; an unwindowed float32 out_dtype takes the
    unwindowed backward."""
    rng = np.random.default_rng(8)
    grad, ids, off, H = _k1_grad_case(rng, 200, 64, 30, "bf16", cuda_device)
    lo, hi = 1000, 4000
    table = torch.from_numpy(rng.standard_normal((hi - lo, 64)).astype(
        np.float32)).to(cuda_device, torch.bfloat16).requires_grad_()
    part = embedding_bag_features(table, ids, off, row_window=(lo, hi),
                                  out_dtype=torch.float32)
    assert part.dtype == torch.float32
    before = k1_ops.grad_window_launches
    g, = torch.autograd.grad(part, table, grad.float())
    torch.cuda.synchronize()
    assert k1_ops.grad_window_launches == before + 1
    assert g.dtype == torch.bfloat16
    assert torch.equal(grad.float().to(torch.bfloat16), grad)
    assert torch.equal(g, embedding_bag_features_grad(
        grad, ids, off, hi - lo, row_window=(lo, hi)))
    whole = torch.zeros((H, 64), device=cuda_device,
                        dtype=torch.bfloat16).requires_grad_()
    gw, = torch.autograd.grad(embedding_bag_features(
        whole, ids, off, out_dtype=torch.float32), whole, grad.float())
    assert torch.equal(gw, embedding_bag_features_grad(grad, ids, off, H))


def test_row_parallel_float32_product(cuda_device):
    """The tensor-parallel LM's row-parallel partial on the card: bf16
    x @ w returned in float32 (``torch.mm(out_dtype=)``), within float32
    rounding of the product of the bf16 values in float32; its backward
    (the same bf16 matmuls, whose cuBLAS layouts may differ) within one
    bf16 rounding of the bf16 product's."""
    from repro_torch.models import transformer as tf

    g = torch.Generator(cuda_device).manual_seed(4)
    x = torch.randn((2, 64, 512), generator=g, device=cuda_device).to(
        torch.bfloat16).requires_grad_()
    w = torch.randn((512, 256), generator=g, device=cuda_device).to(
        torch.bfloat16).requires_grad_()
    out = tf._Float32Product.apply(x, w)
    assert out.dtype == torch.float32 and out.shape == (2, 64, 256)
    want = x.detach().double() @ w.detach().double()
    torch.testing.assert_close(out.double(), want, rtol=1e-5, atol=1e-4)
    cot = torch.randn(out.shape, generator=g, device=cuda_device).to(
        torch.bfloat16)
    dx, dw = torch.autograd.grad(out, (x, w), cot.float())
    ex, ew = torch.autograd.grad(x @ w, (x, w), cot)
    for got, want in ((dx, ex), (dw, ew)):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=2 ** -7 * float(want.abs().max()))


def _train_on_card_and_cpu(cell, cfg, batch_np, dims=None):
    """One train cell's model on the card and its CPU copy; the card's
    loss and gradients (with the K1 launches they made), the CPU's."""
    import dataclasses

    from repro_torch.common.tree import tree_map

    cell = dataclasses.replace(cell, cfg=cfg, dims=dims)
    state = cell.init_state(torch.Generator(cell.device).manual_seed(0))
    model = state["model"]
    cpu = type(model)(cfg, tree_map(lambda t: t.detach().cpu(), model.tree()))
    cpu_cell = dataclasses.replace(cell, device=torch.device("cpu"))
    cpu_state = {"model": cpu, "opt": cpu_cell.opt.init(cpu.tree())}
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    before = (k1_ops.launches, k1_ops.grad_launches)
    loss, grads = cell.value_and_grad(state, _on(batch, cell.device))
    torch.cuda.synchronize()
    launches = (k1_ops.launches - before[0], k1_ops.grad_launches - before[1])
    want_loss, want = cpu_cell.value_and_grad(cpu_state, batch)
    return (cell, state, loss, grads), (cpu_cell, cpu_state, want_loss,
                                        want), launches


def _check_train(card, cpu, tol):
    """Loss and gradients of the card within ``tol`` of the CPU's (scaled
    by the largest), then one optimizer step on each, given the CPU's
    gradients, within 1e-5."""
    from repro_torch.common.tree import tree_leaves, tree_map

    cell, state, loss, grads = card
    cpu_cell, cpu_state, want_loss, want = cpu
    torch.testing.assert_close(loss.cpu(), want_loss, rtol=tol, atol=tol)
    for g, w in zip(tree_leaves(grads), tree_leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        scale = float(w.abs().max())
        torch.testing.assert_close(g.cpu(), w, rtol=tol,
                                   atol=tol * max(scale, 1e-30))
    cell.opt.update(state["model"].tree(), _on(want, cell.device),
                    state["opt"])
    cpu_cell.opt.update(cpu_state["model"].tree(), want, cpu_state["opt"])
    for p, q in zip(tree_leaves(state["model"].tree()),
                    tree_leaves(cpu_state["model"].tree())):
        torch.testing.assert_close(p.detach().cpu(), q.detach(), rtol=1e-5,
                                   atol=1e-5)


def test_recsys_train_step_on_card(cuda_device):
    """wide-deep's train step at its FULL widths (vocabularies cut to
    3,000 rows, batch 512): K1 forward and backward on the deep (D = 32)
    and the wide (D = 1) table, the gradients within 1e-4 of the CPU's
    (f32 sums in other orders), then rowwise AdaGrad on each."""
    from repro_torch.data.clicklog import cell_batch
    from repro_torch.launch.steps import build_cell

    cell = build_cell("wide-deep", "train_batch", cuda_device, batch=512)
    cfg = cut_vocab(cell.cfg)
    card, cpu, launches = _train_on_card_and_cpu(
        cell, cfg, cell_batch(cfg, cell.batch_specs, seed=2))
    assert launches == (2, 2)
    _check_train(card, cpu, 1e-4)


def test_gnn_train_step_on_card(cuda_device):
    """graphsage-reddit's full_graph_sm cell at its sizes (2,708 nodes,
    10,832 edges, 1,433 features): the gradients within 1e-4 of the CPU's
    (``index_add`` sums in no fixed order on the card), then AdamW on
    each."""
    from repro_torch.data.graph import cell_batch
    from repro_torch.launch.steps import build_cell

    cell = build_cell("graphsage-reddit", "full_graph_sm", cuda_device)
    card, cpu, launches = _train_on_card_and_cpu(
        cell, cell.cfg, cell_batch(cell.cfg, cell.dims, seed=2), cell.dims)
    assert launches == (0, 0)
    _check_train(card, cpu, 1e-4)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("H,KVH", [(16, 16), (28, 4), (64, 8)])
def test_decode_lm_group_sizes(cuda_device, dtype, H, KVH):
    """K3's entries at the KV-group sizes of the other LM configs (1:
    qwen2-moe-a2.7b and olmoe-1b-7b; 7: qwen2-7b; 8: deepseek-67b), head
    size 128, a kv_len inside a split: the entry in q's dtype and the int8
    entry against their plain versions, the int8 entry bitwise the other
    on the cache dequantised eagerly."""
    tdt = TDT[dtype]
    B, S, hd, kv_len = 2, 1100, 128, 1037
    qn, kn, vn = _normal(H, (B, 1, H, hd), (B, S, KVH, hd), (B, S, KVH, hd))
    q = (torch.from_numpy(qn) * 8).to(cuda_device, tdt)
    k, v = (torch.from_numpy(a).to(cuda_device, tdt) for a in (kn, vn))
    torch.testing.assert_close(
        flash_decode(q, k, v, kv_len=kv_len).float(),
        flash_decode_ref(q, k, v, kv_len=kv_len).float(), rtol=TOL[dtype],
        atol=TOL[dtype])
    kq, ks, vq, vs = _int8_cache(KVH, B, S, KVH, hd, cuda_device)
    got = flash_decode_int8(q, kq, ks, vq, vs, kv_len=kv_len)
    want = flash_decode_int8_ref(q, kq, ks, vq, vs, kv_len=kv_len)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    assert torch.equal(got, flash_decode(q, dequantize_kv(kq, ks, tdt),
                                         dequantize_kv(vq, vs, tdt),
                                         kv_len=kv_len))
    torch.cuda.synchronize()


@pytest.mark.parametrize("arch_id", ["llama3.2-3b", "olmoe-1b-7b"])
def test_lm_train_step_on_card(cuda_device, arch_id):
    """The train_4k cell's step of a small f32 LM (the arch's SMOKE config,
    llama's with the chunked attention, olmoe's MoE blocks; B 4, S 32) on
    the card against its CPU copy: the loss and every gradient within 1e-4
    (scaled by the largest), then one AdamW step on each from the CPU's
    gradients, the parameters and moments within 1e-5."""
    import dataclasses

    from repro_torch.common.tree import tree_leaves, tree_map
    from repro_torch.data.lm import TokenStream
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.transformer import lm_loss

    cpu_cell = build_cell(arch_id, "train_4k", "cpu")
    if arch_id == "llama3.2-3b":
        cfg = dataclasses.replace(cpu_cell.cfg, attn_impl="chunked",
                                  attn_chunk=8)
        cpu_cell = dataclasses.replace(
            cpu_cell, cfg=cfg, loss_fn=lambda p, b: lm_loss(p, b, cfg))
    cell = dataclasses.replace(cpu_cell, device=cuda_device)
    state = cell.init_state(torch.Generator(cuda_device).manual_seed(0))
    params = tree_map(lambda t: t.detach().cpu().requires_grad_(True),
                      state["params"])
    cpu_state = {"params": params, "opt": cpu_cell.opt.init(params)}
    tokens = torch.from_numpy(TokenStream(cell.cfg.vocab, seed=3).batch(
        4, 32)["tokens"])
    loss, grads = cell.value_and_grad(state, {"tokens": tokens.to(
        cuda_device)})
    want_loss, want = cpu_cell.value_and_grad(cpu_state, {"tokens": tokens})
    torch.testing.assert_close(loss.cpu(), want_loss, rtol=1e-4, atol=1e-4)
    for g, w in zip(tree_leaves(grads), tree_leaves(want)):
        assert g.device.type == cuda_device.type and g.shape == w.shape
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4,
                                   atol=1e-4 * max(float(w.abs().max()),
                                                   1e-30))
    cell.opt.update(state["params"], _on(want, cuda_device), state["opt"])
    cpu_cell.opt.update(cpu_state["params"], want, cpu_state["opt"])
    for a, b in zip(tree_leaves(state), tree_leaves(cpu_state)):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=1e-5,
                                   atol=1e-5)


def test_checkpoint_roundtrip_on_card(cuda_device, tmp_path):
    """CUDA tensors (f32, bf16, an int32 step) saved, the state then
    changed in place, restored bitwise onto the card in their dtypes."""
    from repro_torch.common.tree import tree_leaves, tree_map
    from repro_torch.train.checkpoint import CheckpointManager

    g = torch.Generator(cuda_device).manual_seed(1)
    state = {"w": torch.randn((300, 70), generator=g, device=cuda_device),
             "h": torch.randn((5, 9), generator=g, device=cuda_device).to(
                 torch.bfloat16),
             "opt": {"step": torch.tensor(7, dtype=torch.int32,
                                          device=cuda_device)}}
    want = tree_map(torch.clone, state)
    mgr = CheckpointManager(str(tmp_path))
    fut = mgr.save(3, state)
    for t in tree_leaves(state):
        t.add_(1)
    fut.result()
    out = mgr.restore(3, state)
    for a, b in zip(tree_leaves(out), tree_leaves(want)):
        assert a.device == b.device and a.dtype == b.dtype
        assert torch.equal(a, b)


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
    # the kernel writes each row sorted, +inf past k
    assert np.array_equal(state, np.sort(state, axis=1))
    assert all(np.isinf(state[j, k:]).all() for j, k in enumerate(ks))
    if plain:
        (r, d, o), _, f = _k4_pack(streams, "cpu")
        pe, ps = fleet_fifo_ref(r, d, o, ks, f)
        assert np.array_equal(pe.numpy(), ends)
        # rows compared sorted, +inf columns included: the function's
        # contract (the sweep's state is a sorted heap)
        assert np.array_equal(np.sort(ps.numpy(), axis=1),
                              np.sort(state, axis=1))
    return ends, state


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 16, 17, 20, 33, 40])
def test_k4_every_bucket(cuda_device, k):
    spec = [(k, n, i % 2 == 0) for i, n in
            enumerate([0, 1, 7, 64, 300, 1000, 2500, 33, 5, 129])]
    _k4_check(_k4_streams(k, spec), cuda_device)


C = k4_ops.CHUNK


@pytest.mark.parametrize("k", list(range(1, 34)) + [40])
def test_k4_every_instance(cuda_device, k):
    """Every register instance and the generic one, at lengths around the
    shared-memory chunk, each stream starting at an odd index of the ragged
    layout where the one before it has odd length."""
    lens = [C - 1, C, C + 1, 2 * C + 1, 1, 3 * C, 0, 5]
    spec = [(k, n, i % 2 == 0) for i, n in enumerate(lens)]
    _k4_check(_k4_streams(100 + k, spec), cuda_device)


@pytest.mark.parametrize("n", [C - 1, C, C + 1, 2 * C + 1])
def test_k4_chunk_edges_odd_starts(cuda_device, n):
    """A stream of each chunk-edge length after streams of odd length, so
    it starts at an odd job index (its jobs are not 16-byte aligned)."""
    spec, at = [], 0
    for k in (4, 17, 2, 33):
        filler = 1 if at % 2 == 0 else 2  # the next stream starts odd
        spec += [(k, filler, True), (k, n, k % 2 == 0)]
        at += filler + n
    streams = _k4_streams(200 + n, spec)
    (_, _, offsets), _, _ = _k4_pack(streams, "cpu")
    assert all(offsets[j] % 2 == 1 for j in (1, 3, 5, 7))
    _k4_check(streams, cuda_device)


def test_k4_lanes_100x_apart(cuda_device):
    """Warps whose lanes differ in length by 100x: 31 short streams and one
    long one a warp, for two instances."""
    spec = [(k, 100 * 50 if i % 32 == 0 else 50, i % 3 == 0)
            for k in (6, 17) for i in range(64)]
    _k4_check(_k4_streams(7, spec), cuda_device)


def test_k4_repeated_free_times(cuda_device):
    """free0 rows with repeated values (ties everywhere in the sorted
    insertion), and durations that make ends equal to free times."""
    rng = np.random.default_rng(8)
    streams = []
    for k in (2, 3, 8, 17, 32, 40):
        f0 = rng.choice([0.0, 0.5, 1.0], k)
        r = np.repeat(np.arange(200) * 0.25, 2)
        d = rng.choice([0.25, 0.5], len(r))
        streams.append((r, d, k, f0))
        streams.append((r, d, k, np.full(k, 1.0)))
    _k4_check(streams, cuda_device)


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


def test_k4_launch_alone(cuda_device):
    """``ops.launch``, the kernel alone on checked tensors and
    ``warp_lanes``' thread layout (what ``fleet_fifo`` calls), one launch,
    bitwise its plain version's ends and sorted end states."""
    streams = _k4_streams(10, [(k, 400, True) for k in (3, 17, 33)] * 4)
    (ready, dur, offsets), ks, free0 = _k4_pack(streams, cuda_device)
    lanes = torch.from_numpy(k4_ops.warp_lanes(
        ks, np.diff(offsets.cpu().numpy()))).to(cuda_device)
    before = k4_ops.launches
    ends, state = k4_ops.launch(ready, dur, offsets, lanes, free0)
    torch.cuda.synchronize()
    assert k4_ops.launches == before + 1
    (r, d, o), _, f = _k4_pack(streams, "cpu")
    pe, ps = fleet_fifo_ref(r, d, o, ks, f)
    assert np.array_equal(pe.numpy(), ends.cpu().numpy())
    assert np.array_equal(np.sort(ps.numpy(), axis=1),
                          np.sort(state.cpu().numpy(), axis=1))


def test_k4_streams_entry_on_card(cuda_device):
    """``fleet_fifo_streams``, the event core's entry (host arrays packed
    into one pinned buffer, one launch, ends and states copied back), on
    the card: bitwise the same call on the CPU (its plain version) and
    ``_sweep`` on every stream, an empty stream and streams without
    ``free0`` among them."""
    spec = [(2, 300, True), (17, 129, False), (40, 0, True), (5, 1000, False),
            (1, 7, True), (33, 2 * C + 1, True)]
    streams = _k4_streams(11, spec)
    args = [[s[i] for s in streams] for i in range(4)]
    before = k4_ops.launches
    ends, state, offsets = k4_ops.fleet_fifo_streams(*args,
                                                     device=cuda_device)
    assert k4_ops.launches == before + 1
    pe, ps, po = k4_ops.fleet_fifo_streams(*args, device="cpu")
    assert np.array_equal(offsets, po) and np.array_equal(ends, pe)
    assert np.array_equal(state, ps)
    for j, s in enumerate(streams):
        we, ws = _sweep(s[0], s[1], s[2], s[3], return_state=True)
        assert np.array_equal(ends[offsets[j]:offsets[j + 1]], we), j
        assert np.array_equal(state[j, :s[2]], ws), j


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


# ---------------------------------------------------------------------------
# the shape-only path leaves the card's path alone
# ---------------------------------------------------------------------------


def _entry_calls(device):
    g = torch.Generator().manual_seed(0)
    table = torch.randn(40, 16, generator=g).to(device)
    ids = torch.randint(-1, 10, (5, 3, 4), generator=g,
                        dtype=torch.int32).to(device)
    off = torch.tensor([0, 10, 20], dtype=torch.int64, device=device)
    grad = torch.randn(5, 3, 16, generator=g).to(device)
    q = torch.randn(2, 1, 4, 128, generator=g).to(device, torch.bfloat16)
    k = torch.randn(2, 64, 2, 128, generator=g).to(device, torch.bfloat16)
    kq, ks, vq, vs = _int8_cache(3, 2, 64, 2, 128, device)
    return {
        "hot_embedding_bag": (k1_ops, "launches", lambda: hot_embedding_bag(
            table, ids[:, 0].contiguous())),
        "embedding_bag_features": (k1_ops, "launches",
                                   lambda: embedding_bag_features(
                                       table, ids, off)),
        "embedding_bag_features window": (
            k1_ops, "window_launches", lambda: embedding_bag_features(
                table[10:30], ids, off, row_window=(10, 30),
                out_dtype=torch.float32)),
        "hot_embedding_bag_grad": (
            k1_ops, "grad_launches", lambda: hot_embedding_bag_grad(
                grad[:, 0].contiguous(), ids[:, 0].contiguous(), 40)),
        "embedding_bag_features_grad window": (
            k1_ops, "grad_window_launches",
            lambda: embedding_bag_features_grad(grad, ids, off, 20,
                                                row_window=(10, 30))),
        "flash_decode": (k3_ops, "flash_decode", lambda: flash_decode(
            q, k, k, kv_len=50)),
        "flash_decode_int8": (k3_ops, "flash_decode_int8",
                              lambda: flash_decode_int8(
                                  q, kq, ks, vq, vs, kv_len=50)),
        "flash_decode_int8_partials": (
            k3_ops, "flash_decode_int8_partials",
            lambda: flash_decode_int8_partials(q, kq, ks, vq, vs, kv_len=50,
                                               kv_offset=10)),
    }


@pytest.mark.parametrize("name", ["hot_embedding_bag",
                                  "embedding_bag_features",
                                  "embedding_bag_features window",
                                  "hot_embedding_bag_grad",
                                  "embedding_bag_features_grad window",
                                  "flash_decode", "flash_decode_int8",
                                  "flash_decode_int8_partials"])
def test_cuda_tensor_still_launches(cuda_device, name):
    """Each entry with a shape-only path for the dry run's meta tensors
    still launches its kernel on CUDA tensors (its count moves by one) and
    reports nothing to the dry run's recorders."""
    from repro_torch.kernels import fake

    module, counter, call = _entry_calls(cuda_device)[name]

    def count():
        if module is k3_ops:
            return k3_ops.launches[counter]
        return getattr(k1_ops, counter)

    before = count()
    seen = []
    with fake.recording(lambda *r: seen.append(r)):
        out = call()
    torch.cuda.synchronize()
    assert count() == before + 1 and not seen
    for t in out if isinstance(out, tuple) else (out,):
        assert t.is_cuda


@pytest.mark.parametrize("n,H,D,dtype", [
    (1, 1, 1, 0), (4096 * 3 + 5, 1000, 18, 0), (65536 * 26 * 64, 130_000_384,
                                                 64, 1),
    ((1 << 25) + 7, 80_000_000, 32, 0), (777, 2**27 - 3, 300, 1)])
def test_k1_grad_scratch_bytes_match_the_kernel_plan(cuda_device, n, H, D,
                                                     dtype):
    """``grad_scratch_bytes`` (the dry run's host copy of the backward's
    scratch plan) equals the kernel's own layout."""
    import ctypes

    from repro_torch.kernels.embedding_bag.embedding_bag import (
        _grad_kernel, grad_scratch_bytes)

    _, layout_fn, _ = _grad_kernel()
    layout = (ctypes.c_int64 * 4)()
    assert layout_fn(n, H, D, dtype, layout) == 0
    assert grad_scratch_bytes(n, H, D, 4 if dtype == 0 else 2) == layout[0]
