"""The port's numpy cluster core is bitwise the reference: diurnal traces,
the provisioning LP and its repair, the geo spill LP, the provisioning
policies over a day, the efficiency table, the DeepRecSys/Baymax baselines,
the co-location table and the profile cache.

Both packages profile into empty temporary directories (the port's
records never land in the reference's ``artifacts/profiles/``), and each
efficiency table is built once per file."""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from repro.configs import paper_models as j_pm
from repro.core import baselines as j_base
from repro.core import cluster as j_cluster
from repro.core import colocation as j_coloc
from repro.core import devices as j_dev
from repro.core import efficiency as j_eff
from repro.core import lp as j_lp
from repro.core import profile_cache as j_pc
from repro.serving import diurnal as j_di
from repro.serving import scenarios as j_sc
from repro_torch.configs import paper_models as t_pm
from repro_torch.core import baselines as t_base
from repro_torch.core import cluster as t_cluster
from repro_torch.core import colocation as t_coloc
from repro_torch.core import devices as t_dev
from repro_torch.core import efficiency as t_eff
from repro_torch.core import lp as t_lp
from repro_torch.core import profile_cache as t_pc
from repro_torch.serving import diurnal as t_di

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _assert_same(a, b, path="$"):
    """Recursive bitwise equality: NaN equals NaN, arrays by dtype, shape
    and value, dataclasses field by field."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b, equal_nan=a.dtype.kind in "fc"), path
    elif isinstance(a, (float, np.floating)) and np.isnan(a):
        assert isinstance(b, (float, np.floating)) and np.isnan(b), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _qsizes(n=120, seed=0):
    r = np.random.default_rng(seed)
    return np.clip(r.lognormal(np.log(64), 1.1, n).astype(np.int64), 1, 1024)


@pytest.fixture(scope="module")
def profile_dirs(tmp_path_factory):
    """Both packages' profile caches on empty temporary directories for the
    whole file."""
    j_dir = tmp_path_factory.mktemp("profiles_ref")
    t_dir = tmp_path_factory.mktemp("profiles_port")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_pc, "PROFILE_DIR", j_dir)
        mp.setattr(t_pc, "PROFILE_DIR", t_dir)
        yield j_dir, t_dir


@pytest.fixture(scope="module")
def tables(profile_dirs):
    """``build_table`` at ``baseline_day``'s topology in both packages."""
    spec = j_sc.get_scenario("baseline_day")
    names = spec.workload_names()
    servers = list(spec.servers)
    j_out = j_eff.build_table({n: j_pm.paper_profile(n) for n in names},
                              {s: j_dev.SERVER_TYPES[s] for s in servers})
    t_out = t_eff.build_table({n: t_pm.paper_profile(n) for n in names},
                              {s: t_dev.SERVER_TYPES[s] for s in servers})
    return j_out, t_out


# ---------------------------------------------------------------------------
# diurnal traces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"n_steps": 24, "seed": 3},
    {"n_steps": 96, "valley_frac": 0.3, "peak_hour": 14.0, "jitter": 0.05,
     "seed": 11},
    {"n_steps": 48, "shoulder_hour": 9.5, "jitter": 0.0},
])
def test_diurnal_trace_and_increment_rate(kw):
    a = j_di.diurnal_trace(1234.5, **kw)
    b = t_di.diurnal_trace(1234.5, **kw)
    _assert_same(a, b)
    _assert_same(j_di.load_increment_rate(a), t_di.load_increment_rate(b))


# ---------------------------------------------------------------------------
# LP
# ---------------------------------------------------------------------------

def _lp_case(seed, H=5, M=3):
    rng = np.random.default_rng(seed)
    qps = rng.uniform(50.0, 500.0, (H, M))
    qps[rng.random((H, M)) < 0.2] = 0.0
    power = rng.uniform(100.0, 900.0, (H, M))
    avail = rng.integers(2, 12, H)
    load = rng.uniform(100.0, 1500.0, M)
    return qps, power, load, avail


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("over", [0.0, 0.05])
def test_solve_relaxation_and_round_and_repair(seed, over):
    qps, power, load, avail = _lp_case(seed)
    xa = j_lp.solve_relaxation(qps, power, load, avail, over)
    xb = t_lp.solve_relaxation(qps, power, load, avail, over)
    _assert_same(xa, xb)
    if xa is not None:
        _assert_same(j_lp.round_and_repair(xa, qps, power, load, avail, over),
                     t_lp.round_and_repair(xb, qps, power, load, avail, over))


def test_solve_relaxation_infeasible_is_none():
    qps, power, load, avail = _lp_case(0)
    load = load * 1e6
    assert j_lp.solve_relaxation(qps, power, load, avail) is None
    assert t_lp.solve_relaxation(qps, power, load, avail) is None


@pytest.mark.parametrize("seed", [0, 5, 9])
def test_solve_geo_spill(seed):
    rng = np.random.default_rng(seed)
    R, M = 3, 2
    loads = rng.uniform(100.0, 900.0, (R, M))
    qps = [rng.uniform(80.0, 400.0, (int(rng.integers(2, 4)), M))
           for _ in range(R)]
    power = [rng.uniform(200.0, 800.0, q.shape) for q in qps]
    avail = [rng.integers(1, 6, q.shape[0]) for q in qps]
    pairs = [(i, j) for i in range(R) for j in range(R) if i != j]
    allowed = {p: rng.random(M) < 0.8 for p in pairs}
    cap = {p: float(rng.uniform(50.0, 400.0)) for p in pairs}
    rtt = {p: float(rng.uniform(5.0, 80.0)) for p in pairs}
    must = np.zeros((R, M))
    must[0] = loads[0] * 0.1
    args = (loads, qps, power, avail, allowed, cap, rtt)
    kw = {"must_spill": must, "overprovision": np.array([0.05, 0.1, 0.0])}
    _assert_same(j_lp.solve_geo_spill(*args, **kw),
                 t_lp.solve_geo_spill(*args, **kw))


# ---------------------------------------------------------------------------
# provisioning policies over a day
# ---------------------------------------------------------------------------

def _small_tables(seed=0, H=4, M=3):
    qps, power, _, avail = _lp_case(seed, H, M)
    kw = {"servers": tuple(f"S{h}" for h in range(H)),
          "workloads": tuple(f"w{m}" for m in range(M)),
          "qps": qps, "power": power, "avail": avail.astype(np.int64)}
    return j_cluster.EfficiencyTable(**kw), t_cluster.EfficiencyTable(**kw)


@pytest.mark.parametrize("policy", ["nh", "greedy", "hercules"])
def test_provision_day(policy):
    jt, tt = _small_tables()
    traces = np.stack([j_di.diurnal_trace(p, n_steps=24, seed=s)
                       for s, p in enumerate((900.0, 600.0, 400.0))])
    _assert_same(j_cluster.provision_day(jt, traces, policy, seed=4),
                 t_cluster.provision_day(tt, traces, policy, seed=4))


@pytest.mark.parametrize("policy", ["nh", "greedy", "hercules"])
def test_stateful_provisioner_steps(policy):
    jt, tt = _small_tables(seed=1)
    traces = np.stack([j_di.diurnal_trace(p, n_steps=24, seed=s)
                       for s, p in enumerate((800.0, 500.0, 450.0))])
    jp = j_cluster.StatefulProvisioner(jt, policy)
    tp = t_cluster.StatefulProvisioner(tt, policy)
    for t in range(traces.shape[1]):
        if t == 7:
            _assert_same(jp.fail(1), tp.fail(1))
        _assert_same(jp.step(traces[:, t], tail_ok=t % 5 != 3),
                     tp.step(traces[:, t], tail_ok=t % 5 != 3))


# ---------------------------------------------------------------------------
# efficiency table, baselines, co-location
# ---------------------------------------------------------------------------

def test_build_table_every_record(tables):
    (jt, jr), (tt, tr) = tables
    _assert_same(jr, tr)
    _assert_same(jt, tt)
    assert len(tr) == len(tt.servers) * len(tt.workloads)


def test_build_table_writes_only_the_port_directory(tables, profile_dirs):
    j_dir, t_dir = profile_dirs
    (_, jr), _ = tables
    t_files = sorted(p.name for p in t_dir.glob("*.json"))
    assert len(t_files) == len(jr)
    assert t_files == sorted(p.name for p in j_dir.glob("*.json"))
    assert t_pc.PROFILE_DIR == t_dir


def test_profile_dirs_are_apart():
    """The port's default profile directory is its own (read in a fresh
    process: this file's fixture patches both packages' directories)."""
    code = ("import repro.core.profile_cache as j, "
            "repro_torch.core.profile_cache as t; "
            "print(j.PROFILE_DIR); print(t.PROFILE_DIR)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    j_dir, t_dir = out.stdout.split()
    assert pathlib.Path(t_dir) == ROOT / "artifacts" / "profiles_torch"
    assert pathlib.Path(j_dir) == ROOT / "artifacts" / "profiles"


@pytest.mark.parametrize("server", ["T2", "T7"])
def test_baselines(profile_dirs, server):
    sizes = _qsizes(60)
    for fn in ("deeprecsys_qps", "baymax_qps"):
        a = getattr(j_base, fn)(j_pm.paper_profile("dlrm-rmc3"),
                                j_dev.SERVER_TYPES[server], sizes,
                                use_cache=True)
        b = getattr(t_base, fn)(t_pm.paper_profile("dlrm-rmc3"),
                                t_dev.SERVER_TYPES[server], sizes,
                                use_cache=True)
        assert a[0] == b[0], fn
        _assert_same(a[1], b[1])
        assert (a[2] is None) == (b[2] is None)
        if a[2] is not None:
            _assert_same(a[2], b[2])
        # the second call replays the port's cached record
        assert getattr(t_base, fn)(t_pm.paper_profile("dlrm-rmc3"),
                                   t_dev.SERVER_TYPES[server], sizes,
                                   use_cache=True)[0] == b[0]


def test_colocation_table(profile_dirs):
    names = ("dlrm-rmc3", "llama3.2-3b-decode")
    sizes = _qsizes(60, seed=3)
    servers = ("T2", "T7")
    a = j_coloc.build_colocation_table(
        {n: j_pm.paper_profile(n) for n in names},
        {s: j_dev.SERVER_TYPES[s] for s in servers}, sizes)
    b = t_coloc.build_colocation_table(
        {n: t_pm.paper_profile(n) for n in names},
        {s: t_dev.SERVER_TYPES[s] for s in servers}, sizes)
    _assert_same(a, b)
    assert b.cells or b.rejected


# ---------------------------------------------------------------------------
# profile cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"seed": 1}, {"o_grid": (1, 2)}, {"qps_tol": 0.01},
    {"engine": "reference"}, {"coloc": ("dlrm-rmc1",)},
    {"power_budget_w": 450.0, "batch_grid": (64, 128)},
])
def test_profile_cache_keys_equal(kw):
    a = j_pc.pair_key("hercules", j_pm.paper_profile("dlrm-rmc1"),
                      j_dev.SERVER_TYPES["T2"], _qsizes(), **kw)
    b = t_pc.pair_key("hercules", t_pm.paper_profile("dlrm-rmc1"),
                      t_dev.SERVER_TYPES["T2"], _qsizes(), **kw)
    assert a == b


def test_profile_cache_round_trip_and_invalidate(tmp_path):
    key = "k" * 40
    p = t_pc.store("hercules", "w1", "s1", key, {"qps": 1.5}, root=tmp_path)
    assert p.parent == tmp_path
    assert t_pc.load("hercules", "w1", "s1", key, root=tmp_path) == \
        {"qps": 1.5}
    assert t_pc.load("hercules", "w1", "s1", "k" * 39 + "x",
                     root=tmp_path) is None
    t_pc.store("hercules", "w2", "s1", "b" * 40, {}, root=tmp_path)
    t_pc.store("baymax", "w2", "s2", "c" * 40, {}, root=tmp_path)
    assert t_pc.invalidate(workload="w1", root=tmp_path) == 1
    assert t_pc.invalidate(server="s2", root=tmp_path) == 1
    assert t_pc.invalidate(root=tmp_path) == 1
    assert t_pc.invalidate(root=tmp_path / "missing") == 0
    p.parent.mkdir(exist_ok=True)
    p.write_text("{not json")
    assert t_pc.load("hercules", "w1", "s1", key, root=tmp_path) is None
