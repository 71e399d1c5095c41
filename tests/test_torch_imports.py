"""The port stands alone: it loads with ``jax`` blocked, pulls in nothing
of the reference package ``repro``, and ``chip_smoke.py`` refuses to run
without a card or outside the repository."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    return env


def test_every_port_module_imports_with_jax_blocked():
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [k for k in sys.modules if k == 'repro' or k.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25  # every subpackage was walked


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_and_no_reference(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path}: imports {bad}"


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


# the reference's modules whose counterpart has another name: the Pallas
# and jit rules of its static analysis became the port's kernel and
# step-purity rules
RENAMED = {"analysis/rules_pallas.py": "analysis/rules_kernels.py",
           "analysis/rules_jit.py": "analysis/rules_purity.py"}


def test_every_reference_module_has_a_counterpart():
    """Each module of ``src/repro/`` has one of the same path in the port
    (``analysis/`` was the last), or the one ``RENAMED`` gives it."""
    ref = ROOT / "src" / "repro"
    rels = [p.relative_to(ref).as_posix() for p in ref.rglob("*.py")]
    missing = sorted(r for r in rels
                     if not (PORT / RENAMED.get(r, r)).exists())
    assert not missing, missing
    assert set(RENAMED) <= set(rels)
    assert not any((PORT / r).exists() for r in RENAMED)


def test_analysis_loads_without_torch_or_jax():
    """The port's static analysis imports neither torch nor jax, nor
    anything of ``repro`` (``repro.analysis`` included): it runs over the
    tree in a Python where all three are blocked."""
    code = (
        "import sys\n"
        "for m in ('torch', 'jax', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "from repro_torch.analysis import analyze_paths, default_roots\n"
        "import repro_torch.analysis.__main__\n"
        "r = analyze_paths(default_roots())\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in\n"
        "       ('torch', 'jax', 'repro') and sys.modules[k] is not None]\n"
        "assert not bad, bad\n"
        "print(r.n_files, len(r.findings))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_files, n_findings = map(int, out.stdout.split())
    assert n_files > 120 and n_findings == 0
