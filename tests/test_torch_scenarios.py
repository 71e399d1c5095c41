"""The port's scenario zoo is the reference's: the same registry, the same
spec round trips, and every registered scenario's day (``DayResult``, or
``GeoDayResult`` for the geo days) bitwise equal on the CPU."""
import pytest

from repro.core import profile_cache as j_pc
from repro.serving import geo as j_geo
from repro.serving import scenarios as j_sc
from repro_torch.core import profile_cache as t_pc
from repro_torch.serving import geo as t_geo
from repro_torch.serving import scenarios as t_sc

from test_torch_cluster import _assert_same

NAMES = j_sc.registry()


@pytest.fixture(scope="module", autouse=True)
def port_profile_dir(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_pc, "PROFILE_DIR", tmp_path_factory.mktemp("profiles"))
        yield


@pytest.fixture(autouse=True)
def registries_restored():
    """No test leaves either registry changed."""
    j_before, t_before = dict(j_sc._REGISTRY), dict(t_sc._REGISTRY)
    yield
    assert j_sc._REGISTRY == j_before
    assert t_sc._REGISTRY == t_before


def test_registry_names_equal():
    assert t_sc.registry() == NAMES
    assert len(NAMES) >= 12


@pytest.mark.parametrize("name", NAMES)
def test_spec_round_trip(name):
    j_spec, t_spec = j_sc.get_scenario(name), t_sc.get_scenario(name)
    d = t_spec.to_dict()
    assert d == j_spec.to_dict()
    assert t_sc.ScenarioSpec.from_dict(d) == t_spec
    full = t_sc.full_scale(t_spec, n_steps=24)
    assert full.to_dict() == j_sc.full_scale(j_spec, n_steps=24).to_dict()
    assert t_sc.ScenarioSpec.from_dict(full.to_dict()) == full


def test_register_is_restored(monkeypatch):
    monkeypatch.setattr(t_sc, "_REGISTRY", dict(t_sc._REGISTRY))
    spec = t_sc.get_scenario("baseline_day")
    with pytest.raises(t_sc.ScenarioError, match="already registered"):
        t_sc.register(spec)
    extra = t_sc.ScenarioSpec.from_dict({**spec.to_dict(), "name": "extra"})
    t_sc.register(extra)
    assert "extra" in t_sc.registry()
    assert "extra" not in j_sc.registry()


@pytest.mark.parametrize("name", NAMES)
def test_scenario_day_equal(name):
    a = j_sc.run_scenario(j_sc.get_scenario(name))
    b = t_sc.run_scenario(t_sc.get_scenario(name), device="cpu")
    assert type(b).__name__ == type(a).__name__
    assert type(b).__module__.startswith("repro_torch.")
    _assert_same(a.to_dict(), b.to_dict())


def test_geo_isolated_mode_equal():
    a = j_sc.compile_scenario(j_sc.get_scenario("geo_3region"))
    b = t_sc.compile_scenario(t_sc.get_scenario("geo_3region"))
    assert isinstance(b, t_geo.CompiledGeoScenario)
    _assert_same(j_geo.simulate_geo_day(a, mode="isolated").to_dict(),
                 t_geo.simulate_geo_day(b, mode="isolated",
                                        device="cpu").to_dict())
