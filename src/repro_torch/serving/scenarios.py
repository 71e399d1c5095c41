"""Declarative serving scenarios: the whole scenario zoo as data.

Every serving scenario the repo evaluates — diurnal baseline days, days
with mid-peak machine failures, flash crowds, phase-shifted regions,
model pushes, hedge storms — used to be hand-wired imperatively in
``benchmarks/bench_cluster.py`` and ``examples/cluster_day.py``.  This
module turns each one into a declaration:

- :class:`WorkloadSpec` — one workload's arrival curve, layered on
  :func:`repro_torch.serving.diurnal.diurnal_trace`: a load fraction of the
  fleet's best-case capacity (:meth:`EfficiencyTable.fleet_capacity`),
  a CRN trace seed, and the curve-shape knobs (peak/shoulder hours for
  phase-shifted regions, valley fraction, jitter);
- :class:`Event` — one typed timeline event, validated against the
  :data:`EVENT_TYPES` registry (machine failures, seeded failure
  schedules, load surges, model pushes/drains, hedge storms);
- :class:`ScenarioSpec` — topology (workloads, server types,
  availability), day length, provisioning policy/headroom, transition
  and runtime-config overrides, and the event timeline.  Specs are
  frozen, validate on construction, and round-trip through
  ``to_dict``/``from_dict`` (strict: unknown keys and malformed event
  timelines are rejected with actionable errors).

:func:`compile_scenario` resolves a spec into the exact inputs of
:func:`repro_torch.serving.cluster_runtime.simulate_cluster_day` — the
profiled :class:`EfficiencyTable` (per-pair records via the persistent
profile cache), the per-workload diurnal traces with events applied, a
``failure_schedule``-style event list, :class:`TransitionConfig` and
:class:`RuntimeConfig` — so a :class:`CompiledScenario` runs the day
with any provisioning policy.  The registry (:func:`register` /
:func:`get_scenario` / :func:`registry`) holds the scenario zoo at
smoke scale; :func:`full_scale` lifts a spec to the full paper zoo
(all six workloads, all eleven server types, the 96-interval day).

Bit-exactness: the registered ``baseline_day`` and ``failure_day``
scenarios re-declare the previously hand-wired benchmark/example days
and reproduce them bit-for-bit (pinned by ``tests/test_scenarios.py``);
the scenario-matrix suite there runs *every* registered scenario as a
smoke day, so a new scenario is covered the moment it is registered.
Everything here is deterministic: all randomness flows through seeds
declared in the spec (the reference's copy of this file is in
``repro.analysis``'s determinism-lint scope).

This is the port's numpy copy of ``repro.serving.scenarios`` with its own
registry.  The entry points take a ``device`` keyword: where an
``event_core`` day's fleet groups run (``"cuda"`` by default, the fleet
FIFO kernel; ``"cpu"`` for its plain version).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.paper_models import (PAPER_MODELS, SERVING_MODELS,
                                              paper_profile)
from repro_torch.core.cluster import POLICIES, EfficiencyTable, TransitionConfig
from repro_torch.core.devices import SERVER_TYPES
from repro_torch.serving.cluster_runtime import (
    DayInputs,
    DayResult,
    RuntimeConfig,
    failure_schedule,
    simulate_cluster_day,
)
from repro_torch.serving.diurnal import diurnal_trace, load_increment_rate


class ScenarioError(ValueError):
    """A scenario spec, event, or serialized dict failed validation."""


# ---------------------------------------------------------------------------
# field validation helpers
# ---------------------------------------------------------------------------

_REQUIRED = object()


def _coerce(where: str, name: str, value, types):
    """Type-check ``value`` against ``types`` (a type or tuple); ints are
    accepted for float fields (and coerced), bools are never ints."""
    tt = types if isinstance(types, tuple) else (types,)
    if float in tt and isinstance(value, int) and not isinstance(value, bool):
        return float(value)
    if isinstance(value, bool) and bool not in tt:
        raise ScenarioError(
            f"{where}: field '{name}' must be "
            f"{'/'.join(t.__name__ for t in tt)}, got bool {value!r}")
    if not isinstance(value, tt):
        raise ScenarioError(
            f"{where}: field '{name}' must be "
            f"{'/'.join(t.__name__ for t in tt)}, "
            f"got {type(value).__name__} {value!r}")
    return value


def _check_keys(where: str, got: dict, known) -> None:
    unknown = [k for k in got if k not in known]
    if unknown:
        raise ScenarioError(
            f"{where}: unknown key(s) {', '.join(map(repr, unknown))}; "
            f"expected one of: {', '.join(sorted(known))}")


def _config_overrides(where: str, overrides: dict, config_cls) -> dict:
    """Validate a dict of dataclass-field overrides (TransitionConfig /
    RuntimeConfig) by name and type."""
    fields = {f.name: f.type for f in dataclasses.fields(config_cls)}
    _check_keys(where, overrides, fields)
    out = {}
    for k, v in overrides.items():
        ftype = fields[k]
        tname = ftype if isinstance(ftype, str) else ftype.__name__
        types: tuple = (bool,) if tname == "bool" else \
            (int,) if tname == "int" else (float,)
        out[k] = _coerce(where, k, v, types)
    return out


# ---------------------------------------------------------------------------
# workload arrival curves
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """One workload's arrival curve, layered on ``diurnal_trace``.

    ``load_frac`` scales the curve's peak to that fraction of the fleet's
    best-case capacity for this workload (``table.fleet_capacity()[m]``),
    so a spec stays meaningful across topologies.  The shape knobs default
    to the synchronized-peak day of the paper (Fig. 2d); ``peak_hour`` /
    ``shoulder_hour`` shifts declare phase-shifted (geo-style) regions.
    """

    name: str
    load_frac: float = 0.09
    trace_seed: int = 0
    peak_hour: float = 20.0
    shoulder_hour: float = 11.0
    valley_frac: float = 0.45
    jitter: float = 0.02

    def __post_init__(self):
        where = f"workload {self.name!r}" if isinstance(self.name, str) \
            else "workload"
        _coerce(where, "name", self.name, str)
        if self.name not in SERVING_MODELS:
            raise ScenarioError(
                f"{where}: unknown workload; known workloads: "
                f"{', '.join(sorted(SERVING_MODELS))}")
        for f in dataclasses.fields(self):
            if f.name == "name":
                continue
            types = int if f.name == "trace_seed" else float
            object.__setattr__(
                self, f.name,
                _coerce(where, f.name, getattr(self, f.name), types))
        if not self.load_frac > 0.0:
            raise ScenarioError(f"{where}: load_frac must be > 0, "
                                f"got {self.load_frac}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "WorkloadSpec":
        _coerce("workload", "<spec>", d, dict)
        _check_keys("workload", d, {f.name for f in
                                    dataclasses.fields(WorkloadSpec)})
        if "name" not in d:
            raise ScenarioError("workload: missing required field 'name'")
        return WorkloadSpec(**d)


# ---------------------------------------------------------------------------
# geo-distributed regions (see repro_torch.serving.geo for the serving semantics)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RegionSpec:
    """One region (datacenter) of a geo-distributed scenario.

    A region re-uses the owning spec's workload curves with its local
    clock: ``phase_hours`` shifts every workload's ``peak_hour`` /
    ``shoulder_hour`` (mod 24), ``load_scale`` scales its offered load,
    and ``trace_seed_offset`` decorrelates the trace jitter across
    regions.  ``servers`` / ``availability`` of ``None`` inherit the
    spec-level pool; overriding them gives the region its own topology.
    """

    name: str
    phase_hours: float = 0.0
    load_scale: float = 1.0
    trace_seed_offset: int = 0
    servers: tuple[str, ...] | None = None
    availability: dict[str, int] | None = None

    def __post_init__(self):
        _coerce("region", "name", self.name, str)
        if not self.name:
            raise ScenarioError("region: name must be non-empty")
        where = f"region {self.name!r}"
        object.__setattr__(self, "phase_hours",
                           _coerce(where, "phase_hours", self.phase_hours,
                                   float))
        scale = _coerce(where, "load_scale", self.load_scale, float)
        object.__setattr__(self, "load_scale", scale)
        if not scale > 0.0:
            raise ScenarioError(f"{where}: load_scale must be > 0, "
                                f"got {scale}")
        _coerce(where, "trace_seed_offset", self.trace_seed_offset, int)
        if self.servers is not None:
            srv = tuple(self.servers)
            object.__setattr__(self, "servers", srv)
            for s in srv:
                if s not in SERVER_TYPES:
                    raise ScenarioError(
                        f"{where}: unknown server type {s!r}; known: "
                        f"{', '.join(SERVER_TYPES)}")
            if len(set(srv)) != len(srv):
                raise ScenarioError(f"{where}: duplicate server types")
        if self.availability is not None:
            _coerce(where, "availability", self.availability, dict)
            for s, n in self.availability.items():
                if _coerce(where, f"availability[{s!r}]", n, int) <= 0:
                    raise ScenarioError(
                        f"{where}: availability[{s!r}] must be > 0, got {n}")

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "phase_hours": self.phase_hours,
            "load_scale": self.load_scale,
            "trace_seed_offset": self.trace_seed_offset,
            "servers": None if self.servers is None else list(self.servers),
            "availability": None if self.availability is None
            else dict(self.availability),
        }

    @staticmethod
    def from_dict(d: dict) -> "RegionSpec":
        _coerce("region", "<spec>", d, dict)
        _check_keys("region", d, {f.name for f in
                                  dataclasses.fields(RegionSpec)})
        if "name" not in d:
            raise ScenarioError("region: missing required field 'name'")
        kw = dict(d)
        if kw.get("servers") is not None:
            _coerce("region", "servers", kw["servers"], (list, tuple))
            kw["servers"] = tuple(kw["servers"])
        return RegionSpec(**kw)


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """One bidirectional inter-region link.

    ``rtt_ms`` is the round-trip a spilled query pays on top of its remote
    service time.  ``capacity_frac`` bounds the spill rate per direction as
    a fraction of the *smaller* endpoint's total best-case fleet capacity
    (summed over workloads), so a link declaration stays meaningful when
    the topology is scaled.
    """

    a: str
    b: str
    rtt_ms: float
    capacity_frac: float = 1.0

    def __post_init__(self):
        _coerce("link", "a", self.a, str)
        _coerce("link", "b", self.b, str)
        where = f"link {self.a!r}<->{self.b!r}"
        if self.a == self.b:
            raise ScenarioError(f"{where}: endpoints must differ")
        rtt = _coerce(where, "rtt_ms", self.rtt_ms, float)
        object.__setattr__(self, "rtt_ms", rtt)
        if rtt < 0:
            raise ScenarioError(f"{where}: rtt_ms must be >= 0, got {rtt}")
        cap = _coerce(where, "capacity_frac", self.capacity_frac, float)
        object.__setattr__(self, "capacity_frac", cap)
        if not cap > 0:
            raise ScenarioError(f"{where}: capacity_frac must be > 0, "
                                f"got {cap}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "LinkSpec":
        _coerce("link", "<spec>", d, dict)
        _check_keys("link", d, {f.name for f in
                                dataclasses.fields(LinkSpec)})
        for req in ("a", "b", "rtt_ms"):
            if req not in d:
                raise ScenarioError(f"link: missing required field {req!r}")
        return LinkSpec(**d)


# ---------------------------------------------------------------------------
# typed timeline events
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EventType:
    """One registered event kind: its field schema, cross-field validation
    against the owning spec, and its compile-time application."""

    kind: str
    doc: str
    # field name -> (accepted type(s), default or _REQUIRED)
    fields: dict[str, tuple]
    # validate(spec, params) -> error message or None
    validate: Callable[["ScenarioSpec", dict], str | None]
    # apply(compiled, runtime_overrides, params) — mutates traces/failures
    apply: Callable[["CompiledScenario", dict, dict], None]
    # interval-indexed fields, rescaled by full_scale()
    interval_fields: tuple[str, ...] = ()


def _window(spec: "ScenarioSpec", p: dict) -> str | None:
    if not 0 <= p["start"] < p["end"] <= spec.n_steps:
        return (f"window [{p['start']}, {p['end']}) outside the day "
                f"(n_steps={spec.n_steps})")
    return None


def _known_workload(spec: "ScenarioSpec", name) -> str | None:
    names = [w.name for w in spec.workloads]
    if name is not None and name not in names:
        return (f"workload {name!r} not in this scenario's workloads "
                f"({', '.join(names)})")
    return None


def _wl_index(comp: "CompiledScenario", name: str) -> int:
    return [w.name for w in comp.spec.workloads].index(name)


def _v_machine_failure(spec, p):
    if not 0 <= p["at"] < spec.n_steps:
        return f"at={p['at']} outside the day (n_steps={spec.n_steps})"
    if p["server"] not in spec.server_names():
        return (f"server {p['server']!r} not in this scenario's pool "
                f"({', '.join(spec.server_names())})")
    if not 0.0 < p["window_frac"] < 1.0:
        return f"window_frac must be in (0, 1), got {p['window_frac']}"
    return None


def _a_machine_failure(comp, runtime, p):
    h = comp.spec.server_names().index(p["server"])
    comp.failures.append((p["at"], h, p["window_frac"]))


def _v_random_failures(spec, p):
    if not 0.0 <= p["fail_prob"] <= 1.0:
        return f"fail_prob must be in [0, 1], got {p['fail_prob']}"
    return None


def _a_random_failures(comp, runtime, p):
    comp.failures.extend(failure_schedule(
        comp.spec.n_steps, len(comp.table.servers), p["fail_prob"],
        seed=p["seed"]))


def _v_load_surge(spec, p):
    return _window(spec, p) or _known_workload(spec, p["workload"]) or (
        None if p["factor"] > 0 else f"factor must be > 0, got {p['factor']}")


def _a_load_surge(comp, runtime, p):
    rows = slice(None) if p["workload"] is None \
        else _wl_index(comp, p["workload"])
    comp.traces[rows, p["start"]:p["end"]] *= p["factor"]


def _v_model_push(spec, p):
    if not 0 <= p["at"] < spec.n_steps:
        return f"at={p['at']} outside the day (n_steps={spec.n_steps})"
    if p["ramp"] < 1:
        return f"ramp must be >= 1 interval, got {p['ramp']}"
    if "canary_frac" in p and not 0.0 <= p["canary_frac"] < 1.0:
        return f"canary_frac must be in [0, 1), got {p['canary_frac']}"
    return _known_workload(spec, p["workload"])


def _a_model_push(comp, runtime, p):
    # canary trickle before the push keeps a sliver of the fleet allocated
    # and warm, so cutover traffic has ready servers while the scaled-up
    # pool is still loading (canary_frac=0 models a cold push: the first
    # model_load_s of the cutover interval has no ready servers at all,
    # which simulate_cluster_day reports as an infeasible day)
    T, at, ramp = comp.spec.n_steps, p["at"], p["ramp"]
    gate = np.full(T, p["canary_frac"])
    end = min(at + ramp, T)
    steps = np.arange(end - at) + 1
    gate[at:end] = p["canary_frac"] + steps * (1.0 - p["canary_frac"]) / ramp
    gate[end:] = 1.0
    comp.traces[_wl_index(comp, p["workload"])] *= gate


def _a_model_drain(comp, runtime, p):
    T, at, ramp = comp.spec.n_steps, p["at"], p["ramp"]
    gate = np.ones(T)
    end = min(at + ramp, T)
    gate[at:end] = 1.0 - (np.arange(end - at) + 1) / ramp
    gate[end:] = 0.0
    comp.traces[_wl_index(comp, p["workload"])] *= gate


def _v_hedge_storm(spec, p):
    if err := _window(spec, p):
        return err
    if not p["factor"] > 0:
        return f"factor must be > 0, got {p['factor']}"
    if not 0.0 < p["hedge_quantile"] < 1.0:
        return f"hedge_quantile must be in (0, 1), got {p['hedge_quantile']}"
    if not p["hedge_factor"] > 0:
        return f"hedge_factor must be > 0, got {p['hedge_factor']}"
    return None


def _a_hedge_storm(comp, runtime, p):
    comp.traces[:, p["start"]:p["end"]] *= p["factor"]
    runtime["hedge_quantile"] = p["hedge_quantile"]
    runtime["hedge_factor"] = p["hedge_factor"]


def _known_region(spec, name) -> str | None:
    if spec.regions is None:
        return ("region events require a geo scenario "
                "(ScenarioSpec.regions is None)")
    names = [r.name for r in spec.regions]
    if name not in names:
        return (f"region {name!r} not in this scenario's regions "
                f"({', '.join(names)})")
    return None


def _v_region_partition(spec, p):
    return _known_region(spec, p["region"]) or _window(spec, p)


def _a_region_partition(comp, runtime, p):
    # consumed by the geo compiler (repro_torch.serving.geo): severs every link
    # touching the region over [start, end)
    comp.partitions.append((p["region"], p["start"], p["end"]))


def _v_region_drain(spec, p):
    if err := _known_region(spec, p["region"]):
        return err
    if len(spec.regions) < 2:
        return "region_drain needs another region to evacuate into"
    if not 0 <= p["at"] < spec.n_steps:
        return f"at={p['at']} outside the day (n_steps={spec.n_steps})"
    if p["ramp"] < 1:
        return f"ramp must be >= 1 interval, got {p['ramp']}"
    return None


def _a_region_drain(comp, runtime, p):
    # consumed by the geo compiler: the region's keepable load ramps to 0
    # over [at, at+ramp); the remainder force-spills over surviving links
    comp.drains.append((p["region"], p["at"], p["ramp"]))


EVENT_TYPES: dict[str, EventType] = {
    "machine_failure": EventType(
        "machine_failure",
        "one machine of `server` dies at `window_frac` of interval `at`'s "
        "measured window (victim drawn serving-proportionally)",
        fields={"at": (int, _REQUIRED), "server": (str, _REQUIRED),
                "window_frac": (float, 0.5)},
        validate=_v_machine_failure, apply=_a_machine_failure,
        interval_fields=("at",)),
    "random_failures": EventType(
        "random_failures",
        "seeded day-long failure schedule: each server type loses one "
        "machine w.p. `fail_prob` per interval (failure_schedule)",
        fields={"fail_prob": (float, _REQUIRED), "seed": (int, 0)},
        validate=_v_random_failures, apply=_a_random_failures),
    "load_surge": EventType(
        "load_surge",
        "flash crowd: multiply `workload`'s (or every workload's) offered "
        "load by `factor` over intervals [start, end)",
        fields={"start": (int, _REQUIRED), "end": (int, _REQUIRED),
                "factor": (float, _REQUIRED),
                "workload": ((str, type(None)), None)},
        validate=_v_load_surge, apply=_a_load_surge,
        interval_fields=("start", "end")),
    "model_push": EventType(
        "model_push",
        "model push: `workload` serves only a `canary_frac` trickle before "
        "interval `at` (keeping a warm sliver of the fleet), then ramps in "
        "linearly over `ramp` intervals; canary_frac=0 is a cold push — "
        "the cutover interval has no ready servers during model load",
        fields={"workload": (str, _REQUIRED), "at": (int, _REQUIRED),
                "ramp": (int, 1), "canary_frac": (float, 0.02)},
        validate=_v_model_push, apply=_a_model_push,
        interval_fields=("at", "ramp")),
    "model_drain": EventType(
        "model_drain",
        "model drain: `workload` ramps out linearly over `ramp` intervals "
        "from interval `at`, then serves no traffic",
        fields={"workload": (str, _REQUIRED), "at": (int, _REQUIRED),
                "ramp": (int, 1)},
        validate=_v_model_push, apply=_a_model_drain,
        interval_fields=("at", "ramp")),
    "hedge_storm": EventType(
        "hedge_storm",
        "straggler storm: aggressive hedge knobs (hedge_quantile / "
        "hedge_factor, overriding the spec's runtime block) plus a "
        "`factor` surge over [start, end) that trips them",
        fields={"start": (int, _REQUIRED), "end": (int, _REQUIRED),
                "factor": (float, 1.5), "hedge_quantile": (float, 0.9),
                "hedge_factor": (float, 1.2)},
        validate=_v_hedge_storm, apply=_a_hedge_storm,
        interval_fields=("start", "end")),
    "region_partition": EventType(
        "region_partition",
        "network partition: every inter-region link touching `region` is "
        "severed over intervals [start, end) — the region serves (and "
        "spills) nothing across the partition and runs local-only",
        fields={"region": (str, _REQUIRED), "start": (int, _REQUIRED),
                "end": (int, _REQUIRED)},
        validate=_v_region_partition, apply=_a_region_partition,
        interval_fields=("start", "end")),
    "region_drain": EventType(
        "region_drain",
        "whole-DC evacuation: `region`'s keepable load ramps to 0 over "
        "`ramp` intervals from interval `at`; the evacuated load "
        "force-spills over surviving links and the receiving regions "
        "provision *before* the source stops serving (make-before-break "
        "power accounting via each region's StatefulProvisioner)",
        fields={"region": (str, _REQUIRED), "at": (int, _REQUIRED),
                "ramp": (int, 1)},
        validate=_v_region_drain, apply=_a_region_drain,
        interval_fields=("at", "ramp")),
}

# event kinds consumed by the geo compiler rather than a single-region day
GEO_EVENT_KINDS = ("region_partition", "region_drain")


@dataclasses.dataclass(frozen=True)
class Event:
    """One typed timeline event: a kind from :data:`EVENT_TYPES` plus its
    normalized parameters (defaults filled, names and types validated)."""

    kind: str
    params: dict[str, Any]

    def __post_init__(self):
        _coerce("event", "kind", self.kind, str)
        if self.kind not in EVENT_TYPES:
            raise ScenarioError(
                f"event: unknown event kind {self.kind!r}; registered "
                f"kinds: {', '.join(sorted(EVENT_TYPES))}")
        et = EVENT_TYPES[self.kind]
        where = f"event '{self.kind}'"
        _coerce(where, "params", self.params, dict)
        _check_keys(where, self.params, et.fields)
        norm = {}
        for fname, (types, default) in et.fields.items():
            if fname not in self.params:
                if default is _REQUIRED:
                    raise ScenarioError(
                        f"{where}: missing required field {fname!r} "
                        f"(fields: {', '.join(et.fields)})")
                norm[fname] = default
            else:
                norm[fname] = _coerce(where, fname, self.params[fname],
                                      types)
        object.__setattr__(self, "params", norm)

    @staticmethod
    def create(kind: str, **params) -> "Event":
        return Event(kind, params)

    def to_dict(self) -> dict:
        return {"kind": self.kind, **self.params}

    @staticmethod
    def from_dict(d: dict) -> "Event":
        _coerce("event", "<event>", d, dict)
        if "kind" not in d:
            raise ScenarioError(
                "event: missing 'kind'; registered kinds: "
                f"{', '.join(sorted(EVENT_TYPES))}")
        p = dict(d)
        return Event(p.pop("kind"), p)


# ---------------------------------------------------------------------------
# the scenario spec
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """A full serving scenario as data (see the module docstring).

    ``servers``/``availability`` of ``None`` mean the full paper pool
    (``SERVER_TYPES`` / ``DEFAULT_AVAILABILITY``).  ``overprovision`` of
    ``None`` derives the paper's rate R from the *base* arrival curves
    (events are disruptions the provisioner must absorb, not forecast).
    ``transitions`` / ``runtime`` are validated field overrides of
    :class:`TransitionConfig` / :class:`RuntimeConfig`.
    """

    name: str
    workloads: tuple[WorkloadSpec, ...]
    description: str = ""
    servers: tuple[str, ...] | None = None
    availability: dict[str, int] | None = None
    n_steps: int = 24
    seed: int = 0
    overprovision: float | None = None
    policy: str = "hercules"
    transitions: dict[str, float] = dataclasses.field(default_factory=dict)
    runtime: dict[str, Any] = dataclasses.field(default_factory=dict)
    events: tuple[Event, ...] = ()
    # geo-distributed scenarios (repro_torch.serving.geo): regions of phase-shifted
    # copies of the workload curves, joined by capacity/RTT links
    regions: tuple[RegionSpec, ...] | None = None
    links: tuple[LinkSpec, ...] | None = None
    # interference-aware multi-tenant packing (repro_torch.core.colocation): the
    # provisioner may merge complementary tenants onto shared machines
    colocation: bool = False

    def __post_init__(self):
        _coerce("scenario", "name", self.name, str)
        if not self.name:
            raise ScenarioError("scenario: name must be non-empty")
        where = f"scenario {self.name!r}"
        _coerce(where, "description", self.description, str)
        for fname in ("workloads", "events"):
            v = getattr(self, fname)
            if isinstance(v, list):
                object.__setattr__(self, fname, tuple(v))
        if not self.workloads:
            raise ScenarioError(f"{where}: at least one workload required")
        for w in self.workloads:
            if not isinstance(w, WorkloadSpec):
                raise ScenarioError(f"{where}: workloads must be "
                                    f"WorkloadSpec, got {type(w).__name__}")
        names = [w.name for w in self.workloads]
        if len(set(names)) != len(names):
            raise ScenarioError(f"{where}: duplicate workload names "
                                f"({', '.join(names)})")
        if self.servers is not None:
            srv = tuple(self.servers)
            object.__setattr__(self, "servers", srv)
            for s in srv:
                if s not in SERVER_TYPES:
                    raise ScenarioError(
                        f"{where}: unknown server type {s!r}; known: "
                        f"{', '.join(SERVER_TYPES)}")
            if len(set(srv)) != len(srv):
                raise ScenarioError(f"{where}: duplicate server types")
        if self.availability is not None:
            _coerce(where, "availability", self.availability, dict)
            for s, n in self.availability.items():
                if s not in self.server_names():
                    raise ScenarioError(
                        f"{where}: availability for {s!r} which is not in "
                        f"the pool ({', '.join(self.server_names())})")
                if _coerce(where, f"availability[{s!r}]", n, int) <= 0:
                    raise ScenarioError(
                        f"{where}: availability[{s!r}] must be > 0, got {n}")
        if _coerce(where, "n_steps", self.n_steps, int) < 2:
            raise ScenarioError(f"{where}: n_steps must be >= 2, "
                                f"got {self.n_steps}")
        _coerce(where, "seed", self.seed, int)
        if self.overprovision is not None:
            over = _coerce(where, "overprovision", self.overprovision, float)
            object.__setattr__(self, "overprovision", over)
            if over < 0:
                raise ScenarioError(f"{where}: overprovision must be >= 0")
        if self.policy not in POLICIES:
            raise ScenarioError(
                f"{where}: unknown policy {self.policy!r}; known: "
                f"{', '.join(POLICIES)}")
        object.__setattr__(self, "colocation",
                           _coerce(where, "colocation", self.colocation,
                                   bool))
        if self.colocation and self.regions is not None:
            raise ScenarioError(f"{where}: colocation is not supported for "
                                "geo (multi-region) scenarios yet")
        if self.regions is not None:
            reg = tuple(self.regions)
            object.__setattr__(self, "regions", reg)
            if not reg:
                raise ScenarioError(f"{where}: regions must be non-empty "
                                    "(or None for a single-DC scenario)")
            for r in reg:
                if not isinstance(r, RegionSpec):
                    raise ScenarioError(f"{where}: regions must be "
                                        f"RegionSpec, got {type(r).__name__}")
            rnames = [r.name for r in reg]
            if len(set(rnames)) != len(rnames):
                raise ScenarioError(f"{where}: duplicate region names "
                                    f"({', '.join(rnames)})")
            for r in reg:
                pool = r.servers if r.servers is not None else \
                    self.server_names()
                for s in (r.availability or {}):
                    if s not in pool:
                        raise ScenarioError(
                            f"{where}: region {r.name!r} availability for "
                            f"{s!r} which is not in its pool "
                            f"({', '.join(pool)})")
        if self.links is not None:
            if self.regions is None:
                raise ScenarioError(f"{where}: links require regions")
            lnk = tuple(self.links)
            object.__setattr__(self, "links", lnk)
            rnames = [r.name for r in self.regions]
            seen_pairs = []
            for li in lnk:
                if not isinstance(li, LinkSpec):
                    raise ScenarioError(f"{where}: links must be LinkSpec, "
                                        f"got {type(li).__name__}")
                for end in (li.a, li.b):
                    if end not in rnames:
                        raise ScenarioError(
                            f"{where}: link endpoint {end!r} is not a "
                            f"region ({', '.join(rnames)})")
                pair = tuple(sorted((li.a, li.b)))
                if pair in seen_pairs:
                    raise ScenarioError(
                        f"{where}: duplicate link {pair[0]}<->{pair[1]}")
                seen_pairs.append(pair)
        object.__setattr__(
            self, "transitions",
            _config_overrides(f"{where} transitions", self.transitions,
                              TransitionConfig))
        object.__setattr__(
            self, "runtime",
            _config_overrides(f"{where} runtime", self.runtime,
                              RuntimeConfig))
        for i, ev in enumerate(self.events):
            if not isinstance(ev, Event):
                raise ScenarioError(f"{where}: events[{i}] must be Event, "
                                    f"got {type(ev).__name__}")
            if err := EVENT_TYPES[ev.kind].validate(self, ev.params):
                raise ScenarioError(
                    f"{where}: events[{i}] ({ev.kind}): {err}")

    # -- resolved topology ---------------------------------------------------

    def server_names(self) -> tuple[str, ...]:
        """The effective server pool (spec order; full pool when None)."""
        return self.servers if self.servers is not None \
            else tuple(SERVER_TYPES)

    def workload_names(self) -> tuple[str, ...]:
        return tuple(w.name for w in self.workloads)

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> dict:
        """JSON-safe dict; ``from_dict`` round-trips it exactly."""
        return {
            "name": self.name,
            "description": self.description,
            "workloads": [w.to_dict() for w in self.workloads],
            "servers": None if self.servers is None else list(self.servers),
            "availability": None if self.availability is None
            else dict(self.availability),
            "n_steps": self.n_steps,
            "seed": self.seed,
            "overprovision": self.overprovision,
            "policy": self.policy,
            "transitions": dict(self.transitions),
            "runtime": dict(self.runtime),
            "events": [ev.to_dict() for ev in self.events],
            "regions": None if self.regions is None
            else [r.to_dict() for r in self.regions],
            "links": None if self.links is None
            else [li.to_dict() for li in self.links],
            "colocation": self.colocation,
        }

    @staticmethod
    def from_dict(d: dict) -> "ScenarioSpec":
        """Strict inverse of :meth:`to_dict`: unknown keys, unknown event
        kinds, missing required fields and type mismatches all raise
        :class:`ScenarioError` with an actionable message."""
        _coerce("scenario", "<spec>", d, dict)
        known = {f.name for f in dataclasses.fields(ScenarioSpec)}
        _check_keys("scenario", d, known)
        for req in ("name", "workloads"):
            if req not in d:
                raise ScenarioError(
                    f"scenario: missing required key {req!r}")
        kw = dict(d)
        _coerce("scenario", "workloads", kw["workloads"], (list, tuple))
        kw["workloads"] = tuple(
            WorkloadSpec.from_dict(w) for w in kw["workloads"])
        if kw.get("events") is not None:
            _coerce("scenario", "events", kw["events"], (list, tuple))
            kw["events"] = tuple(Event.from_dict(e) for e in kw["events"])
        if kw.get("servers") is not None:
            _coerce("scenario", "servers", kw["servers"], (list, tuple))
            kw["servers"] = tuple(kw["servers"])
        if kw.get("regions") is not None:
            _coerce("scenario", "regions", kw["regions"], (list, tuple))
            kw["regions"] = tuple(
                RegionSpec.from_dict(r) for r in kw["regions"])
        if kw.get("links") is not None:
            _coerce("scenario", "links", kw["links"], (list, tuple))
            kw["links"] = tuple(LinkSpec.from_dict(li) for li in kw["links"])
        return ScenarioSpec(**kw)


# ---------------------------------------------------------------------------
# compilation: spec -> simulate_cluster_day inputs
# ---------------------------------------------------------------------------

# in-process memo of profiled bundles keyed by topology, so compiling many
# scenarios over the same pool (the matrix suite, the bench's per-policy
# and per-fraction sweeps) builds the efficiency table once; the persistent
# profile cache (artifacts/profiles_torch/) already dedups across processes
_BUNDLES: dict[tuple, tuple] = {}


def _bundle(spec: ScenarioSpec, verbose: bool = False):
    # deferred: core.efficiency reaches repro_torch.serving through the engine
    # stack, so a module-level import here would close an import cycle
    from repro_torch.core.efficiency import build_table

    key = (spec.workload_names(), spec.servers,
           None if spec.availability is None
           else tuple(sorted(spec.availability.items())))
    if key not in _BUNDLES:
        avail = None if spec.availability is None else dict(spec.availability)
        # fast path: a bundle differing only in pool sizes reuses the
        # profiled tuples (EfficiencyTable.with_availability) — per-region
        # pool overrides in geo scenarios hit this instead of build_table
        if avail is not None:
            for k2, (t2, r2, p2, s2) in _BUNDLES.items():
                if k2[:2] == key[:2]:
                    _BUNDLES[key] = (t2.with_availability(avail), r2, p2, s2)
                    return _BUNDLES[key]
        profiles = {n: paper_profile(n) for n in spec.workload_names()}
        servers = None if spec.servers is None \
            else {s: SERVER_TYPES[s] for s in spec.servers}
        table, records = build_table(profiles, servers, avail,
                                     verbose=verbose)
        _BUNDLES[key] = (table, records, profiles, servers)
    return _BUNDLES[key]


# colocation tables, memoized like _BUNDLES (the admissible cells depend
# only on the workload set and the server pool, not on availability)
_COLOC_TABLES: dict[tuple, Any] = {}


def _coloc_table(spec: ScenarioSpec, profiles: dict, servers: dict | None):
    from repro_torch.core.colocation import build_colocation_table

    key = (tuple(sorted(spec.workload_names())),
           None if spec.servers is None else tuple(sorted(spec.servers)))
    if key not in _COLOC_TABLES:
        _COLOC_TABLES[key] = build_colocation_table(
            profiles, servers if servers is not None else dict(SERVER_TYPES))
    return _COLOC_TABLES[key]


@dataclasses.dataclass
class CompiledScenario:
    """A spec resolved to a :class:`DayInputs` bundle plus runtime config.

    The day's data lives in ``inputs`` (what ``simulate_cluster_day``
    consumes); ``table``/``traces``/... stay available as read-through
    properties for call sites that inspect the compiled day.
    """

    spec: ScenarioSpec
    inputs: DayInputs
    config: RuntimeConfig

    @property
    def table(self) -> EfficiencyTable:
        return self.inputs.table

    @property
    def records(self) -> dict:
        return self.inputs.records

    @property
    def profiles(self) -> dict:
        return self.inputs.profiles

    @property
    def servers(self) -> dict | None:
        return self.inputs.servers

    @property
    def traces(self) -> np.ndarray:          # [M, T] with events applied
        return self.inputs.traces

    @property
    def overprovision(self) -> float:
        return self.inputs.overprovision

    @property
    def transitions(self) -> TransitionConfig:
        return self.inputs.transitions

    @property
    def failures(self) -> list[tuple[int, int, float]]:
        return self.inputs.failures

    def run(self, policy: str | None = None,
            device: str | torch.device = "cuda") -> DayResult:
        """Serve the day (``simulate_cluster_day``) under ``policy``
        (default: the spec's declared policy) on ``device``."""
        return simulate_cluster_day(
            self.inputs, policy=policy or self.spec.policy,
            config=self.config, device=device)


def compile_scenario(spec: ScenarioSpec, verbose: bool = False):
    """Resolve ``spec``: profile the topology (cached), lay the per-workload
    diurnal traces, derive the over-provision rate R from the base curves
    (unless declared), then apply the event timeline in order (traces,
    failure list, runtime overrides).  Returns a :class:`CompiledScenario`
    whose ``inputs`` is the :class:`DayInputs` bundle — or, for a spec with
    ``regions``, a :class:`repro_torch.serving.geo.CompiledGeoScenario` holding
    one post-spill ``DayInputs`` per region."""
    if spec.regions is not None:
        # deferred: repro_torch.serving.geo imports this module
        from repro_torch.serving.geo import compile_geo_scenario

        return compile_geo_scenario(spec, verbose=verbose)
    table, records, profiles, servers = _bundle(spec, verbose=verbose)
    coloc = _coloc_table(spec, profiles, servers) if spec.colocation \
        else None
    cap = table.fleet_capacity()
    traces = np.stack([
        diurnal_trace(w.load_frac * cap[m], n_steps=spec.n_steps,
                      valley_frac=w.valley_frac, peak_hour=w.peak_hour,
                      shoulder_hour=w.shoulder_hour, jitter=w.jitter,
                      seed=w.trace_seed)
        for m, w in enumerate(spec.workloads)
    ])
    over = spec.overprovision if spec.overprovision is not None \
        else max(load_increment_rate(tr) for tr in traces)
    comp = CompiledScenario(
        spec=spec,
        inputs=DayInputs(
            table=table, records=records, profiles=profiles, traces=traces,
            servers=servers, overprovision=float(over),
            transitions=TransitionConfig(**spec.transitions),
            failures=[], seed=spec.seed, colocation=coloc),
        config=RuntimeConfig())
    runtime = dict(spec.runtime)
    for ev in spec.events:
        EVENT_TYPES[ev.kind].apply(comp, runtime, ev.params)
    comp.config = RuntimeConfig(**runtime)
    return comp


def run_scenario(spec: ScenarioSpec, policy: str | None = None,
                 verbose: bool = False,
                 device: str | torch.device = "cuda"):
    """Compile and serve ``spec`` in one call on ``device``.  Returns a
    :class:`DayResult` (single-DC) or a geo day result (spec with
    ``regions``)."""
    return compile_scenario(spec, verbose=verbose).run(policy=policy,
                                                       device=device)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ScenarioSpec] = {}


def register(spec: ScenarioSpec, replace: bool = False) -> ScenarioSpec:
    """Register ``spec`` in the zoo.  Registered scenarios are picked up by
    the scenario-matrix test suite and the bench's ``scenarios`` record
    automatically — registration *is* the test plan."""
    if spec.name in _REGISTRY and not replace:
        raise ScenarioError(
            f"scenario {spec.name!r} already registered "
            "(pass replace=True to overwrite)")
    _REGISTRY[spec.name] = spec
    return spec


def registry() -> tuple[str, ...]:
    """Sorted names of every registered scenario."""
    return tuple(sorted(_REGISTRY))


def get_scenario(name: str) -> ScenarioSpec:
    if name not in _REGISTRY:
        raise ScenarioError(f"unknown scenario {name!r}; registered: "
                            f"{', '.join(sorted(_REGISTRY))}")
    return _REGISTRY[name]


def full_scale(spec: ScenarioSpec, n_steps: int = 96,
               load_frac: float | None = None) -> ScenarioSpec:
    """Lift a smoke-scale spec to the full paper zoo: all six workloads
    (trace seeds 0..5, the benchmark convention), the full server pool and
    default availability, a ``n_steps``-interval day.  Interval-indexed
    event fields are rescaled proportionally; per-workload curve-shape
    overrides of the smoke spec are not carried (the full zoo uses the
    synchronized-peak defaults)."""
    frac = load_frac if load_frac is not None \
        else spec.workloads[0].load_frac
    scale = n_steps / spec.n_steps
    events = []
    for ev in spec.events:
        p = dict(ev.params)
        for f in EVENT_TYPES[ev.kind].interval_fields:
            p[f] = max(int(round(p[f] * scale)), 1)
        events.append(Event(ev.kind, p))
    return dataclasses.replace(
        spec,
        workloads=tuple(WorkloadSpec(name=n, load_frac=frac, trace_seed=i)
                        for i, n in enumerate(PAPER_MODELS)),
        servers=None, availability=None, n_steps=n_steps,
        events=tuple(events))


# ---------------------------------------------------------------------------
# the registered zoo
# ---------------------------------------------------------------------------

# The reduced topology every scenario is registered (and matrix-tested) at:
# 2 workloads x 3 server types, a 24-interval day — the same cell the
# benches' --smoke modes and the tests' cluster fixtures profile, so the
# persistent profile cache is shared across all of them.
SMOKE_WORKLOADS = ("dlrm-rmc1", "dlrm-rmc3")
SMOKE_SERVERS = ("T2", "T3", "T7")
SMOKE_AVAILABILITY = {"T2": 70, "T3": 15, "T7": 5}
SMOKE_STEPS = 24

# Peak load per workload = 9% of its fleet-wide best-case capacity (the
# highest point where the heterogeneity-oblivious baseline is still
# feasible, so all three provisioning policies stay comparable).
COMPARISON_FRAC = 0.09


def _smoke_spec(name: str, description: str, **kw) -> ScenarioSpec:
    base: dict[str, Any] = dict(
        workloads=tuple(
            WorkloadSpec(n, load_frac=COMPARISON_FRAC, trace_seed=i)
            for i, n in enumerate(SMOKE_WORKLOADS)),
        servers=SMOKE_SERVERS,
        availability=dict(SMOKE_AVAILABILITY),
        n_steps=SMOKE_STEPS,
    )
    base.update(kw)
    return ScenarioSpec(name=name, description=description, **base)


register(_smoke_spec(
    "baseline_day",
    "the hand-wired benchmark/example day: synchronized diurnal peaks at "
    "the comparison fraction, no events (bit-exact re-declaration, pinned "
    "by tests/test_scenarios.py)"))

register(_smoke_spec(
    "failure_day",
    "baseline day + the benchmark's seeded failure schedule: each server "
    "type loses a machine w.p. 1% per interval, mid-window (bit-exact "
    "re-declaration of the bench's fault-tolerance record)",
    events=(Event.create("random_failures", fail_prob=0.01, seed=7),)))

register(_smoke_spec(
    "flash_crowd",
    "evening flash crowd: every workload's offered load surges 1.35x over "
    "the four peak intervals, unforeseen by the over-provision rate",
    events=(Event.create("load_surge", start=18, end=22, factor=1.35),)))

register(_smoke_spec(
    "phase_shifted",
    "phase-shifted regions (the geo-distributed substrate): the second "
    "workload peaks 12h out of phase, de-synchronizing the fleet peak",
    workloads=(
        WorkloadSpec(SMOKE_WORKLOADS[0], load_frac=COMPARISON_FRAC,
                     trace_seed=0),
        WorkloadSpec(SMOKE_WORKLOADS[1], load_frac=COMPARISON_FRAC,
                     trace_seed=1, peak_hour=8.0, shoulder_hour=23.0),
    )))

register(_smoke_spec(
    "model_push_midpeak",
    "model push mid-peak: the second workload serves only a 2% canary "
    "trickle until it is pushed at interval 18 (the evening peak), "
    "ramping in over 3 intervals; explicit headroom since R cannot be "
    "derived from a ramp-from-canary curve",
    overprovision=0.25,
    events=(Event.create("model_push", workload=SMOKE_WORKLOADS[1],
                         at=18, ramp=3),)))

register(_smoke_spec(
    "hedge_storm",
    "straggler storm under aggressive hedging: p90 * 1.2 hedge threshold "
    "(vs the default p99 * 2) while a 1.25x surge rides the peak — many "
    "duplicates contending in live queues",
    events=(Event.create("hedge_storm", start=17, end=21, factor=1.25,
                         hedge_quantile=0.9, hedge_factor=1.2),)))

# The geo zoo: three regions whose evening peaks sit 7 h apart, each an
# instance of the smoke topology, joined by a metro-scale link triangle.
# RTTs stay inside the tightest workload SLA (dlrm-rmc1, 20 ms) so spill
# is SLA-feasible; the rtt-budget gate in repro_torch.serving.geo is what keeps
# longer links out of a workload's spill set.
#
# Geo regions run hotter than the single-DC comparison fraction: the
# follow-the-sun power win needs each region's peak in the convex part of
# the power-vs-load curve (the efficient T7/T3 pools exhausted, marginal
# load on T2 at ~3x the W/QPS), which on the smoke topology starts around
# 28% of fleet capacity — at COMPARISON_FRAC provisioning is linear in
# load and spilling cannot move power at all.
GEO_FRAC = 0.32

GEO_REGIONS = (
    RegionSpec("us-east", phase_hours=0.0),
    RegionSpec("eu-west", phase_hours=-7.0, trace_seed_offset=100),
    RegionSpec("ap-south", phase_hours=7.0, trace_seed_offset=200),
)
GEO_LINKS = (
    LinkSpec("us-east", "eu-west", rtt_ms=9.0, capacity_frac=0.5),
    LinkSpec("eu-west", "ap-south", rtt_ms=12.0, capacity_frac=0.5),
    LinkSpec("ap-south", "us-east", rtt_ms=6.0, capacity_frac=0.5),
)

GEO_WORKLOADS = tuple(
    WorkloadSpec(n, load_frac=GEO_FRAC, trace_seed=i)
    for i, n in enumerate(SMOKE_WORKLOADS))

register(_smoke_spec(
    "geo_3region",
    "three phase-shifted regions (evening peaks 7 h apart) joined by a "
    "link triangle: follow-the-sun spill flattens each region's served "
    "load, de-synchronizing the global fleet peak (vs per-region-isolated "
    "serving, the bench's geo_day comparison)",
    workloads=GEO_WORKLOADS, regions=GEO_REGIONS, links=GEO_LINKS))

register(_smoke_spec(
    "geo_partition",
    "geo_3region + a network partition: eu-west loses both its links over "
    "its local evening peak (intervals [11, 15) on the shared day clock), "
    "forcing local-only serving during the window",
    workloads=GEO_WORKLOADS, regions=GEO_REGIONS, links=GEO_LINKS,
    events=(Event.create("region_partition", region="eu-west",
                         start=11, end=15),)))

register(_smoke_spec(
    "geo_drain",
    "geo_3region + a whole-DC evacuation: ap-south drains over 2 "
    "intervals from interval 10 (its local valley); its load force-spills "
    "over the surviving links while the receiving regions provision "
    "make-before-break",
    workloads=GEO_WORKLOADS, regions=GEO_REGIONS, links=GEO_LINKS,
    events=(Event.create("region_drain", region="ap-south",
                         at=10, ramp=2),)))

register(_smoke_spec(
    "geo_hetero_pools",
    "geo_3region over heterogeneous per-region fleets: us-east keeps the "
    "full smoke pool, eu-west is a CPU-only site (no T7 accelerators), "
    "ap-south is an accelerator-dense edge site — spill decisions must "
    "respect each region's own efficiency table",
    workloads=GEO_WORKLOADS,
    regions=(
        RegionSpec("us-east", phase_hours=0.0),
        RegionSpec("eu-west", phase_hours=-7.0, trace_seed_offset=100,
                   servers=("T2", "T3"),
                   availability={"T2": 70, "T3": 25}),
        RegionSpec("ap-south", phase_hours=7.0, trace_seed_offset=200,
                   servers=("T3", "T7"),
                   availability={"T3": 15, "T7": 12}),
    ),
    links=GEO_LINKS))

# The co-location pair: a merge fires when two tenants' integer-rounding
# slack fits one shared machine, so these days run at fractions where the
# peak interval is merge-feasible (pinned by the bench's colo_day record:
# co-located Hercules beats single-tenant Hercules on peak provisioned
# power with every tenant meeting its SLA in every interval).

register(_smoke_spec(
    "colo_complements",
    "sparse-heavy + dense-heavy complements share machines: the "
    "interference-aware packer merges a gather-bound RMC1 machine with a "
    "compute-bound RMC3 machine wherever both tenants' dilated residual "
    "loads fit one server inside their SLAs",
    workloads=(
        WorkloadSpec(SMOKE_WORKLOADS[0], load_frac=0.07, trace_seed=0),
        WorkloadSpec(SMOKE_WORKLOADS[1], load_frac=0.07, trace_seed=1),
    ),
    colocation=True))

register(_smoke_spec(
    "colo_recsys_lm",
    "recommendation + LM-decode sharing accelerator hosts: the "
    "per-generation LM SLA is accel-only feasible, so every merge packs "
    "the token stream beside RMC1 on a T7 (engine/HBM slot sharing, "
    "measured-interference dilation)",
    workloads=(
        WorkloadSpec(SMOKE_WORKLOADS[0], load_frac=0.05, trace_seed=0),
        WorkloadSpec("llama3.2-3b-decode", load_frac=0.05, trace_seed=1),
    ),
    colocation=True))
