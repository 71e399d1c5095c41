"""The port's cluster-day runtime is bitwise the reference's on the CPU:
``DayResult.to_dict()`` of the single-DC days under every provisioning
policy, the deprecated loose-argument call, and an ``event_core=True`` day
whose fleet runs through the plain version of the fleet FIFO kernel (K4)
against the reference's sequential fleet branch (``engine._sweep`` per
stream, which the JAX scan is held to)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import profile_cache as j_pc
from repro.core.cluster import POLICIES as J_POLICIES
from repro.serving import cluster_runtime as j_rt
from repro.serving import event_core as j_ec
from repro.serving import scenarios as j_sc
from repro_torch.core import profile_cache as t_pc
from repro_torch.core.cluster import POLICIES as T_POLICIES
from repro_torch.kernels.fleet_fifo import ops as k4
from repro_torch.serving import cluster_runtime as t_rt
from repro_torch.serving import event_core as t_ec
from repro_torch.serving import scenarios as t_sc

from test_torch_cluster import _assert_same

DAYS = ("baseline_day", "failure_day", "hedge_storm")
EVENT_CORE_CAP = 3000


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    """The three days compiled once in each package, the port profiling
    into an empty directory."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_pc, "PROFILE_DIR", tmp_path_factory.mktemp("profiles"))
        yield {n: (j_sc.compile_scenario(j_sc.get_scenario(n)),
                   t_sc.compile_scenario(t_sc.get_scenario(n)))
               for n in DAYS}


@pytest.fixture
def reference_sequential_fleet(monkeypatch):
    """The reference's fleet on its sequential branch: ``_load_jax``
    returns True whenever the scan is already built, so both are reset."""
    monkeypatch.setattr(j_ec, "_fleet_scan", None)
    monkeypatch.setattr(j_ec, "_jax", False)
    t_ec.stats_reset()
    yield
    t_ec.stats_reset()


def test_policies_equal():
    assert list(J_POLICIES) == list(T_POLICIES)


@pytest.mark.parametrize("policy", sorted(J_POLICIES))
@pytest.mark.parametrize("day", DAYS)
def test_day_result_equal(compiled, day, policy):
    j_comp, t_comp = compiled[day]
    a = j_comp.run(policy=policy)
    b = t_comp.run(policy=policy, device="cpu")
    assert type(b) is t_rt.DayResult
    _assert_same(a.to_dict(), b.to_dict())


def test_deprecated_loose_call_warns_and_equals(compiled):
    j_comp, t_comp = compiled["failure_day"]
    inp = t_comp.inputs
    with pytest.warns(DeprecationWarning, match="DayInputs"):
        old = t_rt.simulate_cluster_day(
            inp.table, inp.records, inp.profiles, inp.traces,
            policy="hercules", servers=inp.servers,
            overprovision=inp.overprovision, transitions=inp.transitions,
            failures=inp.failures, seed=inp.seed, device="cpu")
    new = t_rt.simulate_cluster_day(inp, policy="hercules", device="cpu")
    _assert_same(old.to_dict(), new.to_dict())
    _assert_same(j_comp.run(policy="hercules").to_dict(), new.to_dict())


def test_cuda_device_without_a_card_raises(compiled):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA path runs instead")
    _, t_comp = compiled["baseline_day"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_comp.run()


@pytest.mark.parametrize("width", [None, 1])
@pytest.mark.parametrize("day", ["baseline_day", "hedge_storm"])
def test_event_core_day_equal(compiled, reference_sequential_fleet,
                              monkeypatch, day, width):
    """As it is (smoke-scale days have no wide group, so every stream takes
    the sweep) and with ``_MIN_FLEET_WIDTH`` = 1, which sends every group
    through K4's plain version inside the day."""
    rt = {"event_core": True, "event_core_queries": EVENT_CORE_CAP}
    j_comp, t_comp = compiled[day]
    j_comp = dataclasses.replace(j_comp, config=j_rt.RuntimeConfig(**rt))
    t_comp = dataclasses.replace(t_comp, config=t_rt.RuntimeConfig(**rt))
    j_ec.stats_reset()
    a = j_comp.run()
    if width is not None:
        monkeypatch.setattr(t_ec, "_MIN_FLEET_WIDTH", width)
    k4.launches = 0
    b = t_comp.run(device="cpu")
    _assert_same(a.to_dict(), b.to_dict())
    js, ts = j_ec.stats, t_ec.stats
    assert js["fleet_jax"] == 0
    assert ts["fleet_calls"] == js["fleet_calls"] > 0
    assert ts["fleet_jobs"] == js["fleet_jobs"] > 0
    assert ts["fleet_seq"] + ts["fleet_kernel"] == js["fleet_seq"]
    if width is None:
        assert ts["fleet_kernel"] == 0
    else:
        assert ts["fleet_seq"] == 0 and ts["fleet_kernel"] > 0
        assert ts["fleet_groups"] >= ts["fleet_calls"]
    assert k4.launches == 0  # the CPU path never launches the kernel


def test_launch_cluster_day_equals_example(compiled, capsys):
    """``repro_torch.launch.cluster_day`` (smoke) returns the reference
    example's day."""
    import importlib.util
    import pathlib

    from repro_torch.launch import cluster_day

    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
        "cluster_day.py"
    spec = importlib.util.spec_from_file_location("_ref_cluster_day", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    a = example.main(smoke=True)
    b = cluster_day.main(smoke=True, device="cpu")
    _assert_same(a.to_dict(), b.to_dict())
    assert "day feasible=True" in capsys.readouterr().out
