"""``bench/run.py`` measures only on a card: without one, or without the
port beside it, it exits non-zero and prints no result."""
import json
import os
import shutil
import subprocess
import sys

from bench import harness

ROOT = harness.ROOT
ARGS = ["--workload", "rm2.bulk", "--seed", "3000000000", "--seconds", "1",
        "--trace", "0"]


def _run(cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "bench/run.py", *ARGS], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _no_result(out: str) -> bool:
    for line in out.splitlines():
        try:
            if "correct" in json.loads(line):
                return False
        except (ValueError, TypeError):
            continue
    return True


def test_no_card_no_result():
    p = _run(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and _no_result(p.stdout)
    assert "bench:" in p.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and _no_result(p.stdout)
