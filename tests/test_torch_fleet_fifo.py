"""The fleet FIFO solver (K4) on the CPU: its plain version and the port's
``fleet_fifo_finish(device="cpu")`` are bitwise ``engine._sweep`` per
stream, and equal to the reference's ``fleet_fifo_finish`` on its
sequential branch (``use_jax=False``), with the same ``stats`` counts."""
import numpy as np
import pytest
import torch

from repro.serving import engine as j_engine
from repro.serving import event_core as j_ec
from repro_torch.kernels.fleet_fifo import fleet_fifo, fleet_fifo_ref
from repro_torch.kernels.fleet_fifo import ops as k4
from repro_torch.serving import engine as t_engine
from repro_torch.serving import event_core as t_ec


def _streams(seed, n_streams, ks=(2, 2, 4, 8), ragged=True):
    """The streams of ``tests/test_engine.py::TestEventCoreFleet`` (k drawn
    from ``ks``)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_streams):
        n = int(rng.integers(50, 80)) if not ragged else \
            int(rng.integers(1, 120))
        r = rng.exponential(0.2, n).cumsum()
        d = rng.choice(rng.uniform(0.01, 0.8, 4), n)
        k = int(rng.choice(list(ks)))
        f0 = rng.uniform(0.0, 3.0, k) if i % 3 == 0 else None
        out.append((r, d, k, f0) if f0 is not None else (r, d, k))
    return out


def _sweep(s):
    return t_engine._sweep(s[0], s[1], s[2], s[3] if len(s) > 3 else None,
                           return_state=True)


def _same(got, want):
    for (e, st), (we, ws) in zip(got, want, strict=True):
        assert e.dtype == we.dtype and np.array_equal(e, we)
        assert np.array_equal(st, ws)


@pytest.fixture(autouse=True)
def port_stats_reset():
    t_ec.stats_reset()
    yield
    t_ec.stats_reset()


CASES = [(seed, (2, 2, 4, 8)) for seed in (0, 7, 23)] + [
    (3, (1,)), (4, (20,)), (5, (1, 20, 3)), (6, (33, 40, 2))]


@pytest.mark.parametrize("seed,ks", CASES)
@pytest.mark.parametrize("width", [None, 1])
def test_fleet_fifo_finish_cpu_vs_sweep_and_reference(seed, ks, width,
                                                      monkeypatch):
    streams = _streams(seed, 24, ks)
    if width is not None:
        monkeypatch.setattr(t_ec, "_MIN_FLEET_WIDTH", width)
    got = t_ec.fleet_fifo_finish(streams, device="cpu")
    _same(got, [_sweep(s) for s in streams])
    j_ec.stats_reset()
    _same(got, j_ec.fleet_fifo_finish(streams, use_jax=False))
    js, ts = j_ec.stats, t_ec.stats
    assert ts["fleet_calls"] == js["fleet_calls"] == 1
    assert ts["fleet_jobs"] == js["fleet_jobs"]
    assert ts["fleet_seq"] + ts["fleet_kernel"] == js["fleet_seq"] == 24
    if width == 1:
        assert ts["fleet_kernel"] == 24
        assert ts["fleet_groups"] == len(set(s[2] for s in streams))


@pytest.mark.parametrize("seed,ks", CASES)
def test_plain_version_vs_sweep(seed, ks):
    """``fleet_fifo_ref`` on the ragged layout, every stream in one call."""
    streams = _streams(seed, 24, ks, ragged=seed % 2 == 0)
    kk = [s[2] for s in streams]
    ns = [len(s[0]) for s in streams]
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(ns)]),
                           dtype=torch.int64)
    free0 = torch.full((len(streams), max(kk) + 2), 7.0, dtype=torch.float64)
    for j, s in enumerate(streams):
        free0[j, :kk[j]] = torch.from_numpy(s[3]) if len(s) > 3 else 0.0
    ready = torch.from_numpy(np.concatenate([s[0] for s in streams]))
    dur = torch.from_numpy(np.concatenate([s[1] for s in streams]))
    ends, state = fleet_fifo_ref(ready, dur, offsets, kk, free0)
    assert torch.isinf(state[torch.arange(free0.shape[1])[None, :]
                             >= torch.tensor(kk)[:, None]]).all()
    got = [(ends[offsets[j]:offsets[j + 1]].numpy(),
            np.sort(state[j, :kk[j]].numpy())) for j in range(len(streams))]
    _same(got, [_sweep(s) for s in streams])
    assert ops_equal(ready, dur, offsets, kk, free0, ends, state)


def ops_equal(ready, dur, offsets, kk, free0, ends, state):
    """The wrapper on CPU tensors is the plain version and never launches."""
    k4.launches = 0
    e2, s2 = fleet_fifo(ready, dur, offsets, kk, free0)
    return torch.equal(e2, ends) and torch.equal(s2, state) \
        and k4.launches == 0


def test_empty_and_narrow(monkeypatch):
    assert t_ec.fleet_fifo_finish([], device="cpu") == []
    assert t_ec.stats["fleet_calls"] == 0
    r = np.array([0.0, 0.1, 0.2, 0.3])
    d = np.array([1.0, 1.0, 1.0, 1.0])
    (e, s), = t_ec.fleet_fifo_finish([(r, d, 2)], device="cpu")
    _same([(e, s)], [t_engine._sweep(r, d, 2, return_state=True)])
    assert t_ec.stats["fleet_seq"] == 1 and t_ec.stats["fleet_kernel"] == 0
    # empty streams in a wide group: no ends, the sorted initial state
    monkeypatch.setattr(t_ec, "_MIN_FLEET_WIDTH", 1)
    t_ec.stats_reset()
    f0 = np.array([3.0, 1.0, 2.0])
    got = t_ec.fleet_fifo_finish(
        [(np.zeros(0), np.zeros(0), 3, f0), (r, d, 3),
         (np.zeros(0), np.zeros(0), 2)], device="cpu")
    assert got[0][0].shape == (0,) and np.array_equal(got[0][1], np.sort(f0))
    _same(got[1:2], [t_engine._sweep(r, d, 3, return_state=True)])
    assert got[2][0].shape == (0,) and np.array_equal(got[2][1], np.zeros(2))
    assert t_ec.stats["fleet_kernel"] == 2  # the all-empty k = 2 group is narrow
    assert t_ec.stats["fleet_seq"] == 1


def test_stats_reset_through_engine():
    t_ec.fleet_fifo_finish(_streams(0, 8), device="cpu")
    assert t_ec.stats["fleet_calls"] == 1
    t_engine.stats_reset()
    assert all(v == 0 for v in t_ec.stats.values())
    assert set(t_ec.stats) == (set(j_ec.stats) - {"fleet_jax"}) | {
        "fleet_kernel"}


def test_warp_lanes_layout():
    ks = [3, 1, 17, 5, 40, 3, 2, 33, 8, 16, 32, 4] * 5
    lanes = k4.warp_lanes(ks)
    assert lanes.dtype == np.int32 and lanes.shape[1] % 32 == 0
    streams, kk = lanes
    assert sorted(streams[streams >= 0].tolist()) == list(range(len(ks)))
    bucket = np.searchsorted(k4._BUCKETS, kk)
    for w in range(lanes.shape[1] // 32):
        real = streams[w * 32:(w + 1) * 32] >= 0
        assert len(set(bucket[w * 32:(w + 1) * 32][real])) == 1
    assert all(kk[i] == ks[s] for i, s in enumerate(streams) if s >= 0)


def test_wrapper_checks():
    f64 = torch.float64
    ready = torch.zeros(4, dtype=f64)
    off = torch.tensor([0, 4], dtype=torch.int64)
    free0 = torch.zeros(1, 2, dtype=f64)
    with pytest.raises(TypeError):
        fleet_fifo(ready.float(), ready, off, [2], free0)
    with pytest.raises(ValueError):
        fleet_fifo(ready, ready, off.int(), [2], free0)
    with pytest.raises(ValueError):
        fleet_fifo(ready, ready, off, [3], free0)
    with pytest.raises(ValueError):
        fleet_fifo(ready, ready, off, [0], free0)
    with pytest.raises(ValueError):
        fleet_fifo(ready, ready[:3], off, [2], free0)


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the kernel runs instead")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_ec.fleet_fifo_finish(_streams(0, 8))


def test_reference_sweep_is_the_ports():
    """The oracle is the same on both sides."""
    for s in _streams(1, 6):
        a = j_engine._sweep(s[0], s[1], s[2], s[3] if len(s) > 3 else None,
                            return_state=True)
        _same([_sweep(s)], [a])
