"""The port's numpy scheduler and simulator copies are bitwise equal to
the reference: model profiles, click-log data, the k-server FIFO engine
(including the blocked event core), the simulator, the router and the
gradient search."""
import dataclasses

import numpy as np
import pytest

from repro.configs import dlrm_rm2 as j_rm2
from repro.configs import paper_models as j_pm
from repro.core import devices as j_dev
from repro.core import gradient_search as j_gs
from repro.core import partition as j_part
from repro.data import clicklog as j_log
from repro.serving import engine as j_engine
from repro.serving import event_core as j_ec
from repro.serving import router as j_router
from repro.serving import simulator as j_sim
from repro_torch.configs import dlrm_rm2 as t_rm2
from repro_torch.configs import paper_models as t_pm
from repro_torch.core import devices as t_dev
from repro_torch.core import gradient_search as t_gs
from repro_torch.core import partition as t_part
from repro_torch.data import clicklog as t_log
from repro_torch.serving import engine as t_engine
from repro_torch.serving import event_core as t_ec
from repro_torch.serving import router as t_router
from repro_torch.serving import simulator as t_sim


@pytest.fixture(autouse=True)
def _port_engine_stats_reset():
    """The port's engine path-mix counters are module globals like the
    reference's; reset them around every test of this file."""
    t_engine.stats_reset()
    yield
    t_engine.stats_reset()


def _asdict(x):
    return dataclasses.asdict(x)


@pytest.mark.parametrize("prod", [True, False])
@pytest.mark.parametrize("name", sorted(j_pm.PAPER_MODELS))
def test_model_profiles_equal(name, prod):
    assert _asdict(t_pm.paper_profile(name, prod)) == \
        _asdict(j_pm.paper_profile(name, prod))
    assert t_pm.SLA_MS[name] == j_pm.SLA_MS[name]


def test_server_types_equal():
    assert sorted(t_dev.SERVER_TYPES) == sorted(j_dev.SERVER_TYPES)
    for k in j_dev.SERVER_TYPES:
        assert _asdict(t_dev.SERVER_TYPES[k]) == _asdict(j_dev.SERVER_TYPES[k])
    assert t_dev.DEFAULT_AVAILABILITY == j_dev.DEFAULT_AVAILABILITY


@pytest.mark.parametrize("name", sorted(j_pm.PAPER_MODELS))
def test_clicklog_batches_bitwise(name):
    jg = j_log.ClickLogGenerator(j_pm.PAPER_MODELS[name](False), seed=11)
    tg = t_log.ClickLogGenerator(t_pm.PAPER_MODELS[name](False), seed=11)
    np.testing.assert_array_equal(tg.query_sizes(300), jg.query_sizes(300))
    for _ in range(2):
        jb, tb = jg.batch(32), tg.batch(32)
        assert sorted(tb) == sorted(jb)
        for k in jb:
            assert tb[k].dtype == jb[k].dtype
            np.testing.assert_array_equal(tb[k], jb[k])


def test_clicklog_access_frequencies_bitwise():
    jf = j_log.ClickLogGenerator(j_rm2.SMOKE, seed=3).access_frequencies(64)
    tf = t_log.ClickLogGenerator(t_rm2.SMOKE, seed=3).access_frequencies(64)
    for a, b in zip(tf, jf):
        np.testing.assert_array_equal(a, b)


def _stream(n, seed, load):
    rng = np.random.default_rng(seed)
    ready = np.cumsum(rng.exponential(1.0 / load, n))
    dur = rng.lognormal(0.0, 0.5, n)
    return ready, dur


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [1, 50, 5000])
def test_fifo_finish_bitwise(k, n):
    for seed, load in ((0, 0.5 * k), (1, 1.2 * k)):
        ready, dur = _stream(n, seed, load)
        free0 = np.random.default_rng(seed + 9).random(k) * 3
        for f0 in (None, free0):
            np.testing.assert_array_equal(
                t_engine.fifo_finish(ready, dur, k, free0=f0),
                j_engine.fifo_finish(ready, dur, k, free0=f0))
            te, ts = t_engine.fifo_finish_state(ready, dur, k, free0=f0)
            je, js = j_engine.fifo_finish_state(ready, dur, k, free0=f0)
            np.testing.assert_array_equal(te, je)
            np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(
            t_engine.fifo_finish(ready, dur, k, slow=True),
            j_engine.fifo_finish(ready, dur, k, slow=True))


def test_blocked_event_core_bitwise():
    """k > 1 and n >= 4096 dispatch to the blocked kernel on both sides."""
    for seed, load, k in ((2, 3.0, 4), (3, 9.0, 8), (4, 0.5, 2)):
        ready, dur = _stream(9000, seed, load)
        before = t_engine.stats["blocked"]
        got = t_engine.fifo_finish(ready, dur, k)
        assert t_engine.stats["blocked"] == before + 1
        np.testing.assert_array_equal(got, j_engine.fifo_finish(ready, dur, k))
        ge, gs = t_ec.blocked_fifo_finish(ready, dur, k, block=1024,
                                          return_state=True)
        je, js = j_ec.blocked_fifo_finish(ready, dur, k, block=1024,
                                          return_state=True)
        np.testing.assert_array_equal(ge, je)
        np.testing.assert_array_equal(gs, js)
    const = np.full(6000, 0.25)
    np.testing.assert_array_equal(
        t_ec.blocked_fifo_finish(np.zeros(6000), const, 3),
        j_ec.blocked_fifo_finish(np.zeros(6000), const, 3))
    a, b = np.array([0.0, 1.0, 1.0]), np.array([1.0, 0.5])
    for x, y in zip(t_ec.merge_event_streams(a, b), j_ec.merge_event_streams(a, b)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("server", ["T2", "T7"])
def test_simulator_bitwise(server):
    name = "dlrm-rmc1"
    jp, tp = j_pm.paper_profile(name), t_pm.paper_profile(name)
    jd, td = j_dev.SERVER_TYPES[server], t_dev.SERVER_TYPES[server]
    sizes = j_log.ClickLogGenerator(j_pm.rmc1(True), seed=5).query_sizes(300)
    jpls = j_part.enumerate_placements(jp, jd)
    tpls = t_part.enumerate_placements(tp, td)
    assert [_asdict(p) for p in tpls] == [_asdict(p) for p in jpls]
    for jpl, tpl in zip(jpls, tpls):
        sd = 2 if jpl.plan == "cpu_sd" else 0
        for engine in ("fast", "reference"):
            kw = dict(batch=64, m=2, o=2, sd_sparse=sd)
            jr = j_sim.simulate(jpl, jd, j_sim.SchedConfig(**kw), 150.0, sizes,
                                seed=1, engine=engine)
            tr = t_sim.simulate(tpl, td, t_sim.SchedConfig(**kw), 150.0, sizes,
                                seed=1, engine=engine)
            assert _asdict(tr) == _asdict(jr), (jpl.plan, engine)


@pytest.mark.parametrize("name,server", [("dlrm-rmc1", "T2"), ("dlrm-rmc3", "T7")])
def test_gradient_search_bitwise(name, server):
    sizes = j_log.ClickLogGenerator(j_pm.PAPER_MODELS[name](True),
                                    seed=1).query_sizes(300)
    jr = j_gs.gradient_search(j_pm.paper_profile(name), j_dev.SERVER_TYPES[server],
                              sizes, o_grid=(1, 2))
    tr = t_gs.gradient_search(t_pm.paper_profile(name), t_dev.SERVER_TYPES[server],
                              sizes, o_grid=(1, 2))
    assert _asdict(tr.placement) == _asdict(jr.placement)
    assert _asdict(tr.sched) == _asdict(jr.sched)
    assert (tr.qps, tr.p95_ms, tr.power_w) == (jr.qps, jr.p95_ms, jr.power_w)
    assert (tr.evals, tr.space_size) == (jr.evals, jr.space_size)
    assert tr.trajectory == jr.trajectory


def test_router_bitwise():
    def slots(mod):
        return [mod.ServerSlot("T2", 100.0), mod.ServerSlot("T7", 250.0, ready_at=0.5),
                mod.ServerSlot("T3", 60.0, retire_at=1.5)]

    arrivals = np.cumsum(np.random.default_rng(8).exponential(0.004, 600))
    jr, tr = j_router.QueryRouter(slots(j_router), seed=3), \
        t_router.QueryRouter(slots(t_router), seed=3)
    ja, ta = jr.assign_stream(arrivals), tr.assign_stream(arrivals)
    np.testing.assert_array_equal(ta, ja)
    lat = np.random.default_rng(9).lognormal(-4, 1, 600)
    for j, t in zip(jr.hedge_events(ja, arrivals, lat, 0.05),
                    tr.hedge_events(ta, arrivals, lat, 0.05)):
        np.testing.assert_array_equal(t, j)
    for x in lat[:100]:
        jr.observe_latency(float(x))
        tr.observe_latency(float(x))
    assert tr.hedge_threshold() == jr.hedge_threshold()
    shares = np.array([0.2, 0.5, 0.3])
    np.testing.assert_array_equal(t_router.split_stream_by_share(101, shares, 4),
                                  j_router.split_stream_by_share(101, shares, 4))
