"""``BENCHMARK.json`` and the files it names agree with each other: names,
units, ``moves`` and ``workloads``, configurations against the port's
registered ones, a reader for every metric."""
import json
import re

import pytest

from bench import harness

ROOT = harness.ROOT
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = {w["name"]: w for w in MANIFEST["workloads"]}
E2E = {m["name"]: m for m in MANIFEST["end_to_end"]}


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["bench"]
    assert MANIFEST["command"] == ["python3", "bench/run.py"]
    assert isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= MANIFEST["run_seconds"] <= 51


def test_names_and_units():
    names = ([c["name"] for c in MANIFEST["configs"]] + list(CELLS)
             + list(E2E) + [m["name"] for m in MANIFEST["per_layer"]])
    assert all(NAME.match(n) for n in names)
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in MANIFEST[kind]]
        assert len(got) == len(set(got)), kind
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_cells():
    configs = {c["name"] for c in MANIFEST["configs"]}
    pairs = set()
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == configs


def test_end_to_end():
    assert E2E["setup_s"]["bound"] <= 0.25 and "workloads" not in E2E[
        "setup_s"]
    for m in E2E.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m["workloads"]) <= set(CELLS) if "workloads" in m else True
    for cell in CELLS:
        reported = [n for n, m in E2E.items()
                    if cell in m.get("workloads", [cell])]
        assert "setup_s" in reported and len(reported) >= 2


def test_per_layer():
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        moved = E2E[m["moves"]]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert cell in moved.get("workloads", [cell])
        base = m["name"].split(".")[0]
        layers.setdefault(base, set()).add(m["layer"])
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"
    assert all(len(v) == 1 for v in layers.values())
    for cell in CELLS:
        assert any(cell in m["workloads"] for m in MANIFEST["per_layer"])


@pytest.mark.parametrize("name", sorted(E2E) + sorted(
    m["name"] for m in MANIFEST["per_layer"]))
def test_every_metric_has_a_reader(name):
    assert callable(harness.metric_reader(ROOT, name))


@pytest.mark.parametrize("entry", MANIFEST["configs"],
                         ids=lambda c: c["name"])
def test_configs_are_the_ports(entry):
    path = ROOT / entry["file"]
    assert entry["file"].startswith("bench/configs/")
    assert path.name == f"{entry['name']}.json"
    sizes = json.loads(path.read_text())
    assert sizes["name"] == entry["name"]
    assert sizes["source"] == entry["source"]
    assert sizes["reduced"] == entry["reduced"] == []
    harness.check_registered(sizes)
    assert sizes["control"] in ("fp8", "tf32")
    assert 0 < sizes["score_gap_limit"] < 1


def test_a_changed_width_is_refused():
    sizes = harness.load_cell("rm2.bulk").sizes
    with pytest.raises(SystemExit):
        harness.check_registered(dict(sizes, embed_dim=32))
