"""A cell, a traffic, a loop and a metric are added as files and found by
name (``bench/README.md``): in a copy of the benchmark, a throwaway loop
(each pool batch once, of items that differ), a throwaway traffic and
metric, a cell that uses them, one run on the CPU."""
import json
import shutil

from bench import harness
from bench.tests.util import SMALL_ROWS

ROOT = harness.ROOT

ONCE = '''"""Each pool batch once, in order; batch j has batch + 5 j items."""
import time

from bench import gen


def draw_pool(sizes, traffic, seed, device):
    return [gen.draw_batch(sizes, traffic, traffic["batch"] + 5 * j,
                           gen.generator(gen.subseed(seed, 2, j), device),
                           device)
            for j in range(traffic["pool"])]


def window(launch, finish, pool, traffic, seconds):
    lat = []
    t_start = time.perf_counter()
    for j in range(len(pool)):
        t0 = time.perf_counter()
        finish(j, launch(j, j))
        lat.append(time.perf_counter() - t0)
    return time.perf_counter() - t_start, lat
'''


def test_added_files_are_found_by_name(tmp_path, cpu):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    traffic = json.loads((ROOT / "bench/traffic/bulk.json").read_text())
    traffic.update(name="tiny", loop="once", batch=48, pool=3, in_flight=1)
    (tmp_path / "bench/traffic/tiny.json").write_text(json.dumps(traffic))
    (tmp_path / "bench/loops/once.py").write_text(ONCE)
    (tmp_path / "bench/metrics/steps_done.py").write_text(
        "def read(run):\n    return float(run.steps)\n")
    manifest["workloads"].append(
        {"name": "mtwnd.tiny", "config": "mt-wnd", "traffic": "tiny",
         "chips": 1, "why": "a throwaway cell of a test"})
    for m in manifest["end_to_end"]:
        if m["name"] == "items_per_s":
            m["workloads"].append("mtwnd.tiny")
    manifest["per_layer"].append(
        {"name": "steps_done", "unit": "steps", "better": "higher",
         "source": "host_clock", "layer": "a test", "moves": "items_per_s",
         "workloads": ["mtwnd.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    cell = harness.load_cell("mtwnd.tiny", tmp_path, sizes={
        "vocab_sizes": [SMALL_ROWS] * 26})
    assert cell.traffic["name"] == "tiny" and cell.traffic["pool"] == 3
    assert [m["name"] for m in cell.per_layer] == ["steps_done"]
    out = harness.run_cell(cell, 77, 0.2, False, cpu)
    assert out["correct"] and out["attempted"] == 3
    assert set(out["metrics"]) == {"items_per_s", "setup_s"}
    traced = harness.run_cell(cell, 77, 0.2, True, cpu)
    assert traced["metrics"]["steps_done"]["value"] == 3
    assert "items 159 " in traced["_notes"][0]      # 48 + 53 + 58
