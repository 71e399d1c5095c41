"""Nothing a run imports has ``jax``, ``jaxlib``, ``flax`` or the JAX
package (``repro``) as its top-level name, compared whole (the port's
``repro_torch`` begins with ``repro``)."""
import json
import os
import subprocess
import sys
import textwrap

from bench import harness

ROOT = harness.ROOT

SCRIPT = textwrap.dedent("""
    import json, sys
    sys.path[:0] = [{src!r}, {root!r}]
    import torch
    from bench import harness
    from bench.tests.util import small_cell
    for name in ("rm2.bulk", "mtwnd.bulk", "rm2.retrieval"):
        cell = small_cell(name)
        harness.check_registered(harness.load_cell(name).sizes)
        out = harness.run_cell(cell, 5, 0.2, True, torch.device("cpu"))
        assert out["correct"], out
    print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
""")


def test_a_run_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(src=str(ROOT / "src"),
                                             root=str(ROOT))],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top and "bench" in top
    assert not top & set(harness.FORBIDDEN)


def test_the_harness_refuses_a_loaded_jax_package():
    sys.modules.setdefault("repro", type(sys)("repro"))
    try:
        assert "repro" in harness.forbidden_modules()
    finally:
        if getattr(sys.modules.get("repro"), "__file__", None) is None:
            sys.modules.pop("repro", None)
    assert "repro_torch" not in harness.forbidden_modules()


def test_the_references_load_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [{root!r}]\n"
            "import bench.reference.dlrm, bench.reference.widedeep\n"
            "print(sorted({{m.split('.')[0] for m in sys.modules}}))"
            ).format(root=str(ROOT))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = p.stdout
    for name in ("repro_torch", "'repro'", "jax"):
        assert name not in loaded
