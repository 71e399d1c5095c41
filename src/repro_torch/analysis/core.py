"""Lint framework: findings, suppressions, repo facts, and the runner.

Counterpart of ``repro.analysis.core``, with the port's facts.  The
analyzer is a plain-``ast`` walk (no torch or jax import, no code
execution), so it runs in any Python and costs milliseconds per file.
Each pass is a module exposing ``RULES`` (rule name -> one-line
description) and ``run(ctx)`` yielding :class:`Finding`s; the runner
parses each file once, hands the shared :class:`FileContext` to every
pass, and filters findings whose line carries a ``# repro: ignore[rule]``
suppression (the reference's syntax, so the repo has one).

What the passes know of the port is read from its sources at analysis
time (:class:`RepoFacts`): the logical and mesh axis vocabulary from
``repro_torch/dist/sharding.py``'s rule tables, the kernel entries and the
functions that reach a kernel build from ``repro_torch/kernels/``, and the
names that ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` use.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path

SUPPRESS_RE = re.compile(r"#\s*repro:\s*ignore(?:\[([^\]]+)\])?")

# directories never descended into; "analysis_fixtures" additionally gated
# by include_fixtures (the known-bad lint corpus must not fail the repo)
SKIP_DIRS = {".git", "__pycache__", ".pytest_cache", "artifacts", ".github"}

PACKAGE = "repro_torch"
# the one function every compiled launch goes through: it builds (at first
# use) and loads a kernel's library
BUILD_LOAD = f"{PACKAGE}.kernels._build.load"
# the files that hold each kernel entry against its plain version on the card
ON_CARD_FILES = ("chip_smoke.py", "tests/test_torch_cuda.py")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer hit, anchored to a file/line for suppression + diffing."""

    file: str  # posix path as given on the command line
    line: int
    rule: str
    message: str

    def format(self) -> str:
        return f"{self.file}:{self.line}: {self.rule}: {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain rooted at a Name, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _bindings(stmts) -> dict[str, str]:
    """Local name -> qualified path of the import statements in ``stmts``
    (any depth; callers pass one scope's nodes)."""
    out: dict[str, str] = {}
    for node in stmts:
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            for a in node.names:
                if a.name == "*":
                    continue
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def resolve_call(node: ast.AST, imports: dict[str, str]) -> str | None:
    """Fully qualified dotted path of a call target, through import aliases.

    ``np.random.rand`` with ``import numpy as np`` -> "numpy.random.rand".
    None when the chain is not rooted at an imported name (locals,
    attributes of call results, ...)."""
    dotted = dotted_name(node)
    if dotted is None:
        return None
    head, _, rest = dotted.partition(".")
    base = imports.get(head)
    if base is None:
        return None
    return f"{base}.{rest}" if rest else base


def parent_map(tree: ast.Module, nodes=None) -> dict[ast.AST, ast.AST]:
    """Child -> parent of every node (``nodes``: the tree's nodes, if the
    caller has walked it already)."""
    return {
        child: parent
        for parent in (ast.walk(tree) if nodes is None else nodes)
        for child in ast.iter_child_nodes(parent)
    }


_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def enclosing_function(node: ast.AST, parents: dict) -> ast.AST | None:
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
        cur = parents.get(cur)
    return None


def assigned_value(node: ast.AST, scope: ast.AST | None) -> ast.AST | None:
    """The value of the one simple ``name = value`` assignment to the Name
    ``node`` inside ``scope``; None when there is not exactly one."""
    if not isinstance(node, ast.Name) or scope is None:
        return None
    hits = [
        n.value
        for n in ast.walk(scope)
        if isinstance(n, ast.Assign)
        and len(n.targets) == 1
        and isinstance(n.targets[0], ast.Name)
        and n.targets[0].id == node.id
    ]
    return hits[0] if len(hits) == 1 else None


def string_constants(node: ast.AST) -> list[tuple[str, int]]:
    """Every string literal under ``node`` with its line number."""
    return [
        (n.value, n.lineno)
        for n in ast.walk(node)
        if isinstance(n, ast.Constant) and isinstance(n.value, str)
    ]


def module_name(path: Path) -> str | None:
    """``repro_torch.models.layers`` for ``…/repro_torch/models/layers.py``
    (from the last ``repro_torch`` directory of the path that is a package:
    it holds an ``__init__.py``); None outside one."""
    parts = list(path.with_suffix("").parts)
    tops = [i for i, p in enumerate(parts[:-1]) if p == PACKAGE
            and (Path(*parts[:i + 1]) / "__init__.py").is_file()]
    if not tops:
        return None
    mod = parts[tops[-1]:]
    if mod[-1] == "__init__":
        mod = mod[:-1]
    return ".".join(mod)


def kernel_package(module: str | None) -> str | None:
    """``flash_attention`` for ``repro_torch.kernels.flash_attention.ops``."""
    if module is None:
        return None
    parts = module.split(".")
    if len(parts) == 4 and parts[:2] == [PACKAGE, "kernels"] \
            and parts[3] == "ops":
        return parts[2]
    return None


# ---------------------------------------------------------------------------
# name resolution inside one file (scoped imports, local definitions)
# ---------------------------------------------------------------------------


def _params(fn: ast.AST) -> list[str]:
    a = fn.args
    return [x.arg for x in (*a.posonlyargs, *a.args, a.vararg,
                            *a.kwonlyargs, a.kwarg) if x is not None]


class Resolver:
    """Qualified paths of names in one file: a name bound by an import in
    an enclosing function (innermost first), else by a module-level
    import, else a module-level ``def``/``class`` of the file itself
    (qualified by ``module``), else unresolved.  A function's parameter
    hides the imports of the scopes around it (it resolves to nothing)."""

    def __init__(self, tree: ast.Module, module: str | None, parents: dict,
                 nodes=None):
        self.parents = parents
        self.module = module
        # scope (a function, or None for the module) -> its bindings: its
        # imports, and None for each of its parameters
        self._scoped: dict[ast.AST | None, dict[str, str | None]] = {}
        nodes = list(ast.walk(tree)) if nodes is None else nodes
        for node in nodes:
            if isinstance(node, _FUNCS):
                self._scoped.setdefault(node, {}).update(
                    dict.fromkeys(_params(node)))
        for node in nodes:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                self._scoped.setdefault(self._scope_of(node), {}).update(
                    _bindings([node]))
        self.local_defs = {
            n.name
            for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef))
        }

    def _scope_of(self, node: ast.AST) -> ast.AST | None:
        cur = self.parents.get(node)
        while cur is not None and not isinstance(cur, _FUNCS):
            cur = self.parents.get(cur)
        return cur

    def head(self, name: str, at: ast.AST) -> str | None:
        cur = self._scope_of(at)
        while True:
            scope = self._scoped.get(cur, {})
            if name in scope:
                return scope[name]
            if cur is None:
                break
            cur = self._scope_of(cur)
        if name in self.local_defs and self.module:
            return f"{self.module}.{name}"
        return None

    def resolve(self, node: ast.AST) -> str | None:
        dotted = dotted_name(node)
        if dotted is None:
            return None
        head = dotted.partition(".")[0]
        base = self.head(head, node)
        return None if base is None else resolve_call(node, {head: base})


def _class_methods(cls: ast.ClassDef) -> list[ast.AST]:
    return [n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def call_graph(tree: ast.Module, module: str, resolver: Resolver
               ) -> dict[str, set[str]]:
    """Qualified name -> qualified names it refers to, for every top-level
    function and method of the file.  A reference is any name that
    resolves (called or passed on), which over-approximates a call; a
    reference to a class of the file reaches its methods (``Fn.apply``
    runs an ``autograd.Function``'s forward and backward)."""
    graph: dict[str, set[str]] = {}
    classes = {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}

    def refs(fn) -> set[str]:
        out: set[str] = set()
        for n in ast.walk(fn):
            if isinstance(n, (ast.Name, ast.Attribute)) and isinstance(
                    n.ctx, ast.Load):
                q = resolver.resolve(n)
                if q is None:
                    continue
                out.add(q)
                # Cls.apply / Cls(...) of a class of this file: its methods
                head = q[len(module) + 1:].split(".")[0] \
                    if q.startswith(module + ".") else None
                if head in classes:
                    out.update(f"{module}.{head}.{m.name}"
                               for m in _class_methods(classes[head]))
        return out

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            graph[f"{module}.{node.name}"] = refs(node)
        elif isinstance(node, ast.ClassDef):
            for m in _class_methods(node):
                graph[f"{module}.{node.name}.{m.name}"] = refs(m)
    return graph


def reaching(graph: dict[str, set[str]], hit) -> set[str]:
    """The nodes of ``graph`` from which a name with ``hit(name)`` is
    reachable (``hit`` is asked of the nodes and of every name they
    refer to)."""
    out = {q for q in graph if hit(q)}
    changed = True
    while changed:
        changed = False
        for q, callees in graph.items():
            if q not in out and any(c in out or hit(c) for c in callees):
                out.add(q)
                changed = True
    return out


# ---------------------------------------------------------------------------
# repo facts
# ---------------------------------------------------------------------------


# fallback vocabulary when repro_torch/dist/sharding.py is not under the
# scanned roots (e.g. linting a single file from elsewhere) — a snapshot of
# the rule tables, used only as a last resort
DEFAULT_LOGICAL_AXES = frozenset(
    {
        "batch", "model", "seq", "residual_seq", "embed", "heads", "kv_heads",
        "ffn", "vocab", "expert", "kv_seq", "nodes",
    }
)
DEFAULT_MESH_AXES = frozenset({"data", "model", "pod"})


@dataclasses.dataclass
class RepoFacts:
    """What the passes know of the port, read from its sources.

    ``logical_axes`` / ``mesh_axes``: the axis vocabulary of
    ``repro_torch/dist/sharding.py`` (``logical_rules``' keys; its values,
    the names in its assignments and ``kv_seq_axes``' tuples).
    ``launchers``: qualified names of the kernel-package functions that
    reach ``_build.load`` (and their package re-exports).
    ``plain_reachers``: those that reach their own package's ``ref``.
    ``kernel_entries``: the launchers that are public functions of a
    ``kernels/<name>/ops.py``, each with its ``path:line``.
    ``on_card``: for each of ``ON_CARD_FILES`` found, the qualified names
    it uses (empty when the repo's files were not found: the
    ``kernel-not-on-card`` rule then has nothing to hold entries to)."""

    logical_axes: frozenset[str] = DEFAULT_LOGICAL_AXES
    mesh_axes: frozenset[str] = DEFAULT_MESH_AXES
    source: str | None = None  # path the axis tables were read from
    launchers: frozenset[str] = frozenset()
    plain_reachers: frozenset[str] = frozenset()
    kernel_entries: dict = dataclasses.field(default_factory=dict)
    on_card: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def discover(cls, roots: list[Path]) -> "RepoFacts":
        """Facts of the port that holds (or sits above) the first root:
        the ``src/repro_torch`` of a parent directory, else the first
        ``repro_torch/dist/sharding.py`` under a root directory."""
        for root in roots:
            root = Path(root).absolute()
            base = root if root.is_dir() else root.parent
            for cand in [base, *base.parents]:
                hit = cand / "src" / PACKAGE / "dist" / "sharding.py"
                if hit.is_file():
                    return cls.from_package(hit.parents[1])
            if root.is_dir():
                hits = sorted(root.rglob(f"{PACKAGE}/dist/sharding.py"))
                if hits:
                    return cls.from_package(hits[0].parents[1])
        return cls()

    @classmethod
    def from_package(cls, pkg: Path) -> "RepoFacts":
        """Facts of the package directory ``pkg`` (``…/repro_torch``); the
        on-card files are looked for in the repository that holds it
        (``pkg``'s grandparent when ``pkg`` lies under ``src``)."""
        facts = cls.from_sharding_module(pkg / "dist" / "sharding.py")
        kernels = pkg / "kernels"
        if kernels.is_dir():
            facts.launchers, facts.plain_reachers, facts.kernel_entries = \
                kernel_facts(kernels)
        repo = pkg.parents[1] if pkg.parent.name == "src" else pkg.parent
        facts.on_card = {
            name: used_names(repo / name)
            for name in ON_CARD_FILES
            if (repo / name).is_file()
        }
        return facts

    @classmethod
    def from_sharding_module(cls, path: Path) -> "RepoFacts":
        tree = ast.parse(path.read_text(), filename=str(path))
        logical: set[str] = set()
        mesh: set[str] = set()
        for node in ast.walk(tree):
            if not isinstance(node, ast.FunctionDef):
                continue
            if node.name == "logical_rules":
                for n in ast.walk(node):
                    # rules = {"batch": dp, "model": "model", ...}
                    if isinstance(n, ast.Dict):
                        for k, v in zip(n.keys, n.values):
                            if isinstance(k, ast.Constant) and isinstance(
                                k.value, str
                            ):
                                logical.add(k.value)
                                mesh.update(s for s, _ in string_constants(v))
                    # rules.update(seq=None, heads="model", ...)
                    elif (
                        isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and n.func.attr == "update"
                    ):
                        for kw in n.keywords:
                            if kw.arg:
                                logical.add(kw.arg)
                                mesh.update(
                                    s for s, _ in string_constants(kw.value)
                                )
                    # rules["nodes"] = dp + ("model",)
                    elif isinstance(n, ast.Assign) and isinstance(
                        n.targets[0], ast.Subscript
                    ):
                        key = n.targets[0].slice
                        if isinstance(key, ast.Constant) and isinstance(
                            key.value, str
                        ):
                            logical.add(key.value)
                            mesh.update(s for s, _ in string_constants(n.value))
                    # dp = ("pod", "data") if multi_pod else ("data",)
                    elif (
                        isinstance(n, ast.Assign)
                        and isinstance(n.targets[0], ast.Name)
                        and not isinstance(n.value, ast.Dict)
                    ):
                        mesh.update(s for s, _ in string_constants(n.value))
            elif node.name == "kv_seq_axes":
                # returned tuples only (the docstring is prose, not axes)
                for n in ast.walk(node):
                    if isinstance(n, (ast.Return, ast.Assign)) and n.value:
                        mesh.update(s for s, _ in string_constants(n.value))
        if not logical or not mesh:
            return cls(source=str(path))
        return cls(frozenset(logical), frozenset(mesh), str(path))


def _parse_module(path: Path) -> tuple[ast.Module, Resolver] | None:
    try:
        tree = ast.parse(path.read_text(), filename=str(path))
    except SyntaxError:
        return None
    return tree, Resolver(tree, module_name(path), parent_map(tree))


def plain_prefix(pkg: str) -> str:
    """Qualified-name prefix of kernel package ``pkg``'s plain versions."""
    return f"{PACKAGE}.kernels.{pkg}.ref."


def kernel_facts(kernels: Path) -> tuple[frozenset, frozenset, dict]:
    """(launchers, plain_reachers, kernel_entries) of the kernel package
    directory ``kernels`` (see :class:`RepoFacts`)."""
    graph: dict[str, set[str]] = {}
    aliases: dict[str, str] = {}  # package re-export -> defining name
    for path in sorted(kernels.rglob("*.py")):
        parsed = _parse_module(path)
        if parsed is None:
            continue
        tree, resolver = parsed
        module = resolver.module
        graph.update(call_graph(tree, module, resolver))
        if path.name == "__init__.py":
            for local, q in _bindings(tree.body).items():
                aliases[f"{module}.{local}"] = q
    launch = reaching(graph, lambda q: q == BUILD_LOAD)

    def own_plain(q: str) -> bool:
        parts = q.split(".")
        return len(parts) > 3 and q.startswith(plain_prefix(parts[2]))

    plain: set[str] = set()
    for pkg in {q.split(".")[2] for q in graph}:
        sub = {k: v for k, v in graph.items() if k.split(".")[2] == pkg}
        plain |= reaching(sub, lambda c, p=pkg: c.startswith(plain_prefix(p)))
    entries = {}
    for q in sorted(launch):
        parts = q.split(".")
        if len(parts) == 5 and kernel_package(".".join(parts[:4])) \
                and not parts[4].startswith("_"):
            path = kernels / parts[2] / "ops.py"
            tree = ast.parse(path.read_text())
            line = next(n.lineno for n in tree.body
                        if isinstance(n, ast.FunctionDef)
                        and n.name == parts[4])
            entries[q] = f"{path.as_posix()}:{line}"
    launch |= {a for a, q in aliases.items() if q in launch}
    plain |= {a for a, q in aliases.items() if q in plain}
    return frozenset(launch), frozenset(plain), entries


def used_names(path: Path) -> frozenset[str]:
    """Qualified names a file uses (each Name/Attribute load resolved
    through its scope's imports)."""
    parsed = _parse_module(path)
    if parsed is None:
        return frozenset()
    tree, resolver = parsed
    out: set[str] = set()
    for n in ast.walk(tree):
        if isinstance(n, (ast.Name, ast.Attribute)) and isinstance(
                n.ctx, ast.Load):
            q = resolver.resolve(n)
            if q is not None:
                out.add(q)
    return frozenset(out)


# ---------------------------------------------------------------------------
# file context + runner
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FileContext:
    """Everything a pass needs about one parsed file (parse once, share)."""

    path: Path
    rel: str                       # path as reported in findings
    tree: ast.Module
    lines: list[str]
    facts: RepoFacts
    module: str | None = None      # dotted module inside repro_torch, or None
    _nodes: list | None = None
    _parents: dict | None = None
    _resolver: Resolver | None = None

    @property
    def nodes(self) -> list[ast.AST]:
        """Every node of the tree, in ``ast.walk`` order (walked once)."""
        if self._nodes is None:
            self._nodes = list(ast.walk(self.tree))
        return self._nodes

    @property
    def parents(self) -> dict:
        if self._parents is None:
            self._parents = parent_map(self.tree, self.nodes)
        return self._parents

    @property
    def resolver(self) -> Resolver:
        if self._resolver is None:
            self._resolver = Resolver(self.tree, self.module, self.parents,
                                      self.nodes)
        return self._resolver

    def resolve(self, node: ast.AST) -> str | None:
        return self.resolver.resolve(node)

    @property
    def in_port(self) -> bool:
        """A module of the port package."""
        return self.module is not None


def all_passes():
    from repro_torch.analysis import (
        rules_determinism,
        rules_kernels,
        rules_purity,
        rules_sharding,
    )

    return [rules_sharding, rules_kernels, rules_determinism, rules_purity]


def rule_catalog() -> dict[str, str]:
    out: dict[str, str] = {}
    for p in all_passes():
        out.update(p.RULES)
    return out


def suppressed_rules(line_text: str) -> set[str] | None:
    """Rules suppressed on this line: a set of names, the universal set
    (returned as ``{"*"}``) for a bare ``# repro: ignore``, or None."""
    m = SUPPRESS_RE.search(line_text)
    if not m:
        return None
    if m.group(1) is None:
        return {"*"}
    return {r.strip() for r in m.group(1).split(",") if r.strip()}


@dataclasses.dataclass
class Report:
    findings: list[Finding]
    suppressed: list[Finding]
    n_files: int
    facts: RepoFacts
    errors: list[Finding]  # unparseable files (reported, non-fatal)

    def to_dict(self) -> dict:
        return {
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "errors": [f.to_dict() for f in self.errors],
            "n_files": self.n_files,
            "rules": rule_catalog(),
            "facts": {
                "logical_axes": sorted(self.facts.logical_axes),
                "mesh_axes": sorted(self.facts.mesh_axes),
                "source": self.facts.source,
                "kernel_entries": dict(self.facts.kernel_entries),
            },
        }


def default_roots(base: Path = Path(".")) -> list[Path]:
    """The port's files under the repository root ``base``: the package,
    ``chip_smoke.py`` and the port's tests, whichever exist."""
    tests = base / "tests"
    paths = [base / "src" / PACKAGE, base / "chip_smoke.py",
             *sorted(tests.glob("test_torch_*.py")),
             *sorted(tests.glob("torch_*.py"))]
    return [p for p in paths if p.exists()]


def iter_py_files(paths: list[Path], include_fixtures: bool = False):
    for p in paths:
        if p.is_file() and p.suffix == ".py":
            yield p
            continue
        if not p.is_dir():
            continue
        for f in sorted(p.rglob("*.py")):
            parts = set(f.parts)
            if parts & SKIP_DIRS:
                continue
            if not include_fixtures and "analysis_fixtures" in parts:
                continue
            yield f


def analyze_file(
    path: Path, facts: RepoFacts, rel: str | None = None
) -> tuple[list[Finding], list[Finding]]:
    """(active findings, suppressed findings) for one file."""
    path = Path(path)
    rel = rel or path.as_posix()
    src = path.read_text()
    tree = ast.parse(src, filename=rel)
    lines = src.splitlines()
    ctx = FileContext(
        path=path, rel=rel, tree=tree, lines=lines, facts=facts,
        module=module_name(path.absolute()),
    )
    active: list[Finding] = []
    suppressed: list[Finding] = []
    for p in all_passes():
        for f in p.run(ctx):
            text = lines[f.line - 1] if 0 < f.line <= len(lines) else ""
            sup = suppressed_rules(text)
            if sup is not None and ("*" in sup or f.rule in sup):
                suppressed.append(f)
            else:
                active.append(f)
    key = lambda f: (f.file, f.line, f.rule)  # noqa: E731
    return sorted(active, key=key), sorted(suppressed, key=key)


def analyze_paths(
    paths: list[str | Path], include_fixtures: bool = False,
    facts: RepoFacts | None = None,
) -> Report:
    roots = [Path(p) for p in paths]
    facts = facts or RepoFacts.discover(roots)
    findings: list[Finding] = []
    suppressed: list[Finding] = []
    errors: list[Finding] = []
    n = 0
    for f in iter_py_files(roots, include_fixtures):
        n += 1
        rel = f.as_posix()
        try:
            a, s = analyze_file(f, facts, rel)
        except SyntaxError as e:
            errors.append(
                Finding(rel, e.lineno or 0, "parse-error", str(e.msg))
            )
            continue
        findings.extend(a)
        suppressed.extend(s)
    return Report(findings, suppressed, n, facts, errors)
