"""Tests for repro_torch.analysis, the port's static analysis.

The corpus in ``tests/analysis_fixtures/torch/`` carries its own oracle, as
the reference's does: every line that must be flagged ends with
``# expect: rule`` (suppressed findings with ``# expect-suppressed:
rule``), and the analyzer must report exactly that set of (line, rule), so
false negatives and false positives both fail.  The corpus sits in a
subdirectory so that the reference's tests, which glob
``tests/analysis_fixtures/*.py``, never see it.  The kernel pass's corpus
is a package there (``repro_torch/kernels/{bad,clean}_kernels/ops.py``),
held on the card by two stand-ins for the repo's on-card files.

Beside the corpus: parity with ``repro.analysis`` on the reference's own
inputs, planted faults in copies of real port modules (the repo's files
are not touched), and the tree itself clean.  Pure host tests.
"""
import ast
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import RepoFacts as RefFacts
from repro.analysis import analyze_file as ref_analyze_file
from repro.analysis.core import suppressed_rules as ref_suppressed_rules
from repro_torch.analysis import (
    RepoFacts,
    analyze_file,
    analyze_paths,
    default_roots,
    rule_catalog,
)
from repro_torch.analysis.core import suppressed_rules, used_names

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "analysis_fixtures" / "torch"
REF_FIXTURES = REPO / "tests" / "analysis_fixtures"
PORT = REPO / "src" / "repro_torch"
FACTS = RepoFacts.discover([FIXTURES])
REF_FACTS = RefFacts.discover([REF_FIXTURES])
# the repo's facts, with the corpus's stand-ins as the on-card files
CORPUS_FACTS = dataclasses.replace(FACTS, on_card={
    name: used_names(FIXTURES / f"on_card_{Path(name).name}")
    for name in ("chip_smoke.py", "tests/test_torch_cuda.py")})

EXPECT_RE = re.compile(r"#\s*expect:\s*([\w\-, ]+)")
EXPECT_SUP_RE = re.compile(r"#\s*expect-suppressed:\s*([\w\-, ]+)")

PASSES = ("determinism", "kernels", "purity", "sharding")


def _corpus(kind: str) -> list[str]:
    """The corpus files of ``kind`` (bad or clean), relative to FIXTURES:
    ``<kind>_<pass>.py``, and the kernel pass's package ``ops.py``."""
    return sorted(p.relative_to(FIXTURES).as_posix() for p in [
        *FIXTURES.glob(f"{kind}_*.py"),
        *FIXTURES.glob(f"repro_torch/kernels/{kind}_*/ops.py")])


BAD_FIXTURES = _corpus("bad")
CLEAN_FIXTURES = _corpus("clean")

KERNEL_ENTRIES = {
    f"repro_torch.kernels.{pkg}.ops.{name}"
    for pkg, names in {
        "embedding_bag": ("hot_embedding_bag", "embedding_bag_features",
                          "hot_embedding_bag_grad",
                          "embedding_bag_features_grad"),
        "flash_attention": ("flash_attention", "flash_decode_partials",
                            "flash_decode", "flash_decode_int8",
                            "flash_decode_int8_partials"),
        "fleet_fifo": ("fleet_fifo_streams", "fleet_fifo", "launch"),
    }.items()
    for name in names
}


def _expected(path: Path, regex) -> set:
    out = set()
    for lineno, text in enumerate(path.read_text().splitlines(), start=1):
        m = regex.search(text)
        if m:
            for rule in m.group(1).split(","):
                out.add((lineno, rule.strip()))
    return out


def _got(findings) -> set:
    return {(f.line, f.rule) for f in findings}


# ---------------------------------------------------------------------------
# the corpus
# ---------------------------------------------------------------------------


def test_corpus_covers_every_pass_and_rule():
    for kind, names in (("bad", BAD_FIXTURES), ("clean", CLEAN_FIXTURES)):
        assert names == sorted(
            f"repro_torch/kernels/{kind}_{p}/ops.py" if p == "kernels"
            else f"{kind}_{p}.py" for p in PASSES)
    expected = {name: _expected(FIXTURES / name, EXPECT_RE)
                for name in BAD_FIXTURES}
    assert all(len(v) >= 2 for v in expected.values()), expected
    seen = {rule for v in expected.values() for _, rule in v}
    assert seen == set(rule_catalog())


@pytest.mark.parametrize("name", BAD_FIXTURES)
def test_bad_fixture_flagged_at_expected_lines(name):
    path = FIXTURES / name
    active, suppressed = analyze_file(path, CORPUS_FACTS)
    assert _got(active) == _expected(path, EXPECT_RE)
    assert not suppressed


@pytest.mark.parametrize("name", CLEAN_FIXTURES)
def test_clean_fixture_has_zero_findings(name):
    active, suppressed = analyze_file(FIXTURES / name, CORPUS_FACTS)
    assert active == [] and suppressed == []


def test_suppression_fixture():
    path = FIXTURES / "suppressed.py"
    active, suppressed = analyze_file(path, FACTS)
    assert _got(active) == _expected(path, EXPECT_RE)
    assert _got(suppressed) == _expected(path, EXPECT_SUP_RE)


def test_suppression_comment_parsing():
    assert suppressed_rules("x = 1") is None
    assert suppressed_rules("x = 1  # repro: ignore") == {"*"}
    assert suppressed_rules("x  # repro: ignore[a-rule] why") == {"a-rule"}
    assert suppressed_rules("x  # repro: ignore[a, b-c]") == {"a", "b-c"}
    assert suppressed_rules("x  # repro:ignore[a]") == {"a"}


# ---------------------------------------------------------------------------
# the facts read from the tree
# ---------------------------------------------------------------------------


def test_repo_facts_track_the_ports_sharding_module():
    assert FACTS.source == str(PORT / "dist" / "sharding.py")
    assert FACTS.logical_axes == frozenset(
        {"batch", "model", "seq", "residual_seq", "embed", "heads",
         "kv_heads", "ffn", "vocab", "expert", "kv_seq", "nodes"})
    assert FACTS.mesh_axes == frozenset({"data", "model", "pod"})
    # from any root under the repository, never the reference's module
    for root in (REPO, REPO / "tests", PORT / "models" / "layers.py"):
        assert RepoFacts.discover([root]).source == FACTS.source


def test_kernel_entries_are_the_twelve_ops_functions():
    assert set(FACTS.kernel_entries) == KERNEL_ENTRIES
    assert set(FACTS.on_card) == {"chip_smoke.py", "tests/test_torch_cuda.py"}
    for q, where in FACTS.kernel_entries.items():
        path, line = where.rsplit(":", 1)
        text = Path(path).read_text().splitlines()[int(line) - 1]
        assert text.startswith(f"def {q.rsplit('.', 1)[1]}("), (q, text)
    # every entry reaches a build, and every entry but K4's bare launch
    # its package's plain version
    assert KERNEL_ENTRIES <= FACTS.launchers
    assert KERNEL_ENTRIES - FACTS.plain_reachers == {
        "repro_torch.kernels.fleet_fifo.ops.launch"}


def test_rule_catalog_covers_all_four_passes():
    rules = rule_catalog()
    assert {r.split("-")[0] for r in rules} == {
        "sharding", "kernel", "device", "determinism", "step"}
    assert len(rules) == 15 and all(rules.values())


# ---------------------------------------------------------------------------
# parity with the reference's analyzer on its own inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["bad_determinism.py",
                                  "clean_determinism.py"])
def test_determinism_parity_with_reference(name):
    path = REF_FIXTURES / name
    ours, _ = analyze_file(path, FACTS)
    theirs, _ = ref_analyze_file(path, REF_FACTS)
    want, got = ({(f.line, f.rule) for f in found
                  if f.rule.startswith("determinism-")}
                 for found in (theirs, ours))
    assert got == want
    assert (name == "clean_determinism.py") == (not want)


def test_silent_fallback_parity_with_reference():
    path = REF_FIXTURES / "bad_sharding.py"
    ours, _ = analyze_file(path, FACTS)
    theirs, _ = ref_analyze_file(path, REF_FACTS)
    rule = "sharding-silent-fallback"
    want = {f.line for f in theirs if f.rule == rule}
    assert want and {f.line for f in ours if f.rule == rule} == want


def test_suppression_parity_with_reference():
    lines = (REF_FIXTURES / "suppressed.py").read_text().splitlines()
    assert any(ref_suppressed_rules(t) for t in lines)
    for text in lines:
        assert suppressed_rules(text) == ref_suppressed_rules(text), text


def _run_cli(module, *args, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run(
        [sys.executable, "-m", module, *args],
        capture_output=True, text=True, env=env, cwd=cwd, timeout=120,
    )


@pytest.mark.parametrize("name", ["bad_determinism.py",
                                  "clean_determinism.py", "suppressed.py"])
def test_cli_parity_with_reference(name, tmp_path):
    path = str(REF_FIXTURES / name)
    out = {}
    for module in ("repro.analysis", "repro_torch.analysis"):
        report = tmp_path / f"{module}.json"
        r = _run_cli(module, path, "--json", str(report))
        out[module] = (r.returncode, json.loads(report.read_text()))
        assert _run_cli(module, path, "--exit-zero").returncode == 0
    (rc_ref, ref), (rc, ours) = out["repro.analysis"], \
        out["repro_torch.analysis"]
    assert rc == rc_ref == (0 if name.startswith("clean") else 1)
    assert set(ours) == set(ref)
    for key in ("findings", "suppressed"):
        assert [set(f) for f in ours[key]] == [set(f) for f in ref[key]]
        assert [(f["line"], f["rule"]) for f in ours[key]] == \
            [(f["line"], f["rule"]) for f in ref[key]]
    assert set(ref["facts"]) <= set(ours["facts"])


# ---------------------------------------------------------------------------
# planted faults in copies of real port modules
# ---------------------------------------------------------------------------


def _port_copy(tmp_path: Path, rel: str) -> Path:
    """A copy of ``src/repro_torch/<rel>`` under ``tmp_path/repro_torch``
    (a package there, so the passes read its module path)."""
    pkg = tmp_path / "repro_torch"
    pkg.mkdir(exist_ok=True)
    (pkg / "__init__.py").write_text("")
    dst = pkg / rel
    dst.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(PORT / rel, dst)
    return dst


def _append(path: Path, code: str) -> int:
    """Append ``code`` (one function whose last line is the fault) and
    return the fault's line number."""
    text = path.read_text().rstrip("\n") + "\n\n\n" + code.strip("\n") + "\n"
    path.write_text(text)
    return len(text.splitlines())


def _replace(path: Path, old: str, new: str) -> None:
    text = path.read_text()
    assert text.count(old) == 1, old
    path.write_text(text.replace(old, new))


def _line_of(path: Path, needle: str) -> int:
    hits = [i for i, t in enumerate(path.read_text().splitlines(), start=1)
            if needle in t]
    assert len(hits) == 1, (needle, hits)
    return hits[0]


def _only(path: Path, line: int, rule: str, facts=FACTS, analyze=None):
    """The planted copy gives exactly one finding: ``rule`` at ``line``."""
    active, _ = (analyze or analyze_file)(path, facts)
    assert _got(active) == {(line, rule)}


def test_planted_global_rng_in_simulator(tmp_path):
    code = "def _planted_draw():\n    return np.random.rand()\n"
    ours = _port_copy(tmp_path, "serving/simulator.py")
    assert analyze_file(ours, FACTS)[0] == []
    _only(ours, _append(ours, code), "determinism-global-rng")
    # the reference's pass flags the same line of its own simulator
    theirs = tmp_path / "ref" / "repro" / "serving" / "simulator.py"
    theirs.parent.mkdir(parents=True)
    shutil.copy(REPO / "src" / "repro" / "serving" / "simulator.py", theirs)
    assert ref_analyze_file(theirs, REF_FACTS)[0] == []
    _only(theirs, _append(theirs, code), "determinism-global-rng",
          facts=REF_FACTS, analyze=ref_analyze_file)


def test_planted_torch_draw_in_layers(tmp_path):
    path = _port_copy(tmp_path, "models/layers.py")
    assert analyze_file(path, FACTS)[0] == []
    line = _append(path, "def _planted_init():\n    return torch.randn(3)\n")
    _only(path, line, "determinism-torch-global-rng")


def test_planted_fallback_around_a_launch(tmp_path):
    path = _port_copy(tmp_path, "kernels/flash_attention/ops.py")
    assert analyze_file(path, FACTS)[0] == []
    launch = ("    out = flash_attention_cuda(q, k, v, causal=causal, "
              "q_offset=int(q_offset))\n")
    _replace(path, launch, "    try:\n    " + launch
             + "    except Exception:\n"
             "        return ref.attention_ref(q, k, v, causal=causal,\n"
             "                                 q_offset=q_offset)\n")
    _only(path, _line_of(path, "except Exception:"),
          "kernel-silent-fallback")


def test_planted_cpu_fallback_in_serve_recsys(tmp_path):
    path = _port_copy(tmp_path, "launch/serve_recsys.py")
    assert analyze_file(path, FACTS)[0] == []
    line = _append(path, "def _planted_device():\n    return torch.device("
                   "\"cuda\" if torch.cuda.is_available() else \"cpu\")\n")
    _only(path, line, "device-cpu-fallback")


def test_planted_host_sync_in_a_forward(tmp_path):
    path = _port_copy(tmp_path, "models/dlrm.py")
    assert analyze_file(path, FACTS)[0] == []
    tree = ast.parse(path.read_text())
    fwd = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
               and n.name == "forward")
    last = fwd.body[-1]
    lines = path.read_text().splitlines(keepends=True)
    lines.insert(last.lineno - 1, " " * last.col_offset
                 + f"_planted = {fwd.args.args[1].arg}.item()\n")
    path.write_text("".join(lines))
    _only(path, last.lineno, "step-purity-host-sync")


def test_planted_axis_typo_in_constrain(tmp_path):
    path = _port_copy(tmp_path, "models/transformer.py")
    assert analyze_file(path, FACTS)[0] == []
    _replace(path, '"residual_seq" if seq else None',
             '"residual_sq" if seq else None')
    _only(path, _line_of(path, '"residual_sq"'),
          "sharding-unknown-logical-axis")


# ---------------------------------------------------------------------------
# the tree, and the CLI on it
# ---------------------------------------------------------------------------


def test_port_tree_is_clean():
    roots = default_roots(REPO)
    assert roots[:2] == [PORT, REPO / "chip_smoke.py"]
    assert REPO / "tests" / "test_torch_cuda.py" in roots
    report = analyze_paths(roots)
    assert report.findings == [] and report.errors == []
    assert report.n_files > 120
    # the one suppression in the port, with its reason on its line
    assert [(Path(f.file).name, f.rule) for f in report.suppressed] == [
        ("ops.py", "kernel-no-plain")]


def test_cli_default_roots_and_list_rules():
    r = _run_cli("repro_torch.analysis")
    assert r.returncode == 0, r.stdout + r.stderr
    assert " 0 finding(s)" in r.stderr and "12 kernel entries" in r.stderr
    r = _run_cli("repro_torch.analysis", "--list-rules")
    assert r.returncode == 0
    assert {ln.split(":")[0] for ln in r.stdout.splitlines()} == set(
        rule_catalog())


def test_cli_flags_a_bad_fixture(tmp_path):
    bad = FIXTURES / "bad_purity.py"
    line = min(_expected(bad, EXPECT_RE))
    r = _run_cli("repro_torch.analysis", str(bad))
    assert r.returncode == 1
    assert f"{bad.as_posix()}:{line[0]}: {line[1]}:" in r.stdout
    report = tmp_path / "r.json"
    r = _run_cli("repro_torch.analysis", str(FIXTURES), "--include-fixtures",
                 "--json", str(report))
    assert r.returncode == 1
    data = json.loads(report.read_text())
    assert data["n_files"] == 12
    assert set(data["facts"]["kernel_entries"]) == KERNEL_ENTRIES
    assert set(data["rules"]) == set(rule_catalog())


def test_parse_error_is_reported_not_fatal(tmp_path):
    bad = tmp_path / "broken.py"
    bad.write_text("def f(:\n")
    report = analyze_paths([bad], facts=FACTS)
    assert report.findings == []
    assert len(report.errors) == 1 and report.errors[0].rule == "parse-error"
