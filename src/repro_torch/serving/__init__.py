"""Serving substrate of the port (numpy copies of ``repro.serving``): the
k-server FIFO engine, the blocked event core and its fleet path (the K4
kernel on a card), the discrete-event simulator, diurnal load traces, the
query router, the fleet-scale cluster serving runtime with its typed day
API (:class:`DayInputs` in, :class:`DayResult` out), the declarative
scenario zoo (`repro_torch.serving.scenarios`), and geo-distributed
multi-region serving with follow-the-sun spill (`repro_torch.serving.geo`).
"""
from repro_torch.serving.cluster_runtime import (  # noqa: F401
    DayInputs,
    DayResult,
    PairService,
    RuntimeConfig,
    failure_schedule,
    simulate_cluster_day,
)
from repro_torch.serving.geo import (  # noqa: F401
    CompiledGeoScenario,
    GeoConfig,
    GeoDayResult,
    GeoNetwork,
    compile_geo_scenario,
    plan_spill,
    simulate_geo_day,
)
from repro_torch.serving.scenarios import (  # noqa: F401
    Event,
    LinkSpec,
    RegionSpec,
    ScenarioError,
    ScenarioSpec,
    WorkloadSpec,
    compile_scenario,
    full_scale,
    get_scenario,
    register,
    registry,
    run_scenario,
)
from repro_torch.serving.simulator import (  # noqa: F401
    SchedConfig,
    SimCache,
    SimResult,
    max_sustainable_qps,
    simulate,
    simulate_rates,
)

__all__ = [
    "CompiledGeoScenario",
    "DayInputs",
    "DayResult",
    "Event",
    "GeoConfig",
    "GeoDayResult",
    "GeoNetwork",
    "LinkSpec",
    "PairService",
    "RegionSpec",
    "RuntimeConfig",
    "ScenarioError",
    "ScenarioSpec",
    "SchedConfig",
    "SimCache",
    "SimResult",
    "WorkloadSpec",
    "compile_geo_scenario",
    "compile_scenario",
    "failure_schedule",
    "full_scale",
    "get_scenario",
    "max_sustainable_qps",
    "plan_spill",
    "register",
    "registry",
    "run_scenario",
    "simulate",
    "simulate_cluster_day",
    "simulate_geo_day",
    "simulate_rates",
]
