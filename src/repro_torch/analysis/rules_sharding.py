"""Sharding-consistency pass.

Counterpart of ``repro.analysis.rules_sharding`` at the port's APIs.  A
typo'd axis name does not error in the port either: ``logical.resolve``
and ``bound_axes`` map an unknown logical name to "unbound", so a sharded
dataflow silently runs its one-device path, and ``opt_spec_tree`` used to
replicate a diverging optimizer sub-tree without a word.  This pass
checks every literal axis name against the vocabulary of
``repro_torch/dist/sharding.py``'s rule tables
(:class:`repro_torch.analysis.core.RepoFacts`):

- logical names: ``logical.constrain``'s axes, ``logical.bound_axes``'s
  name, ``axis_rules`` dict keys and ``rules["…"] = …`` writes;
- mesh names: ``axis_rules`` dict values and ``rules["…"]`` written
  values, ``logical.group`` / ``shard_index`` / ``shards``'s axes,
  ``collectives.block_mean`` / ``reduce_grads``'s axes, every entry of
  ``sharding.P(...)``, the axis names a ``launch.mesh.Mesh`` is built with,
  and a mesh's ``axis_index`` / ``block_group`` axis;
- a spec-tree fallback that replicates on structural divergence without
  warning or raising is a finding (``opt_spec_tree`` now warns, and raises
  under ``strict=True``).

Only literal axes are checked (strings, tuples of them, either arm of a
conditional), and names bound once in the enclosing function to such a
literal (``axes = ("pod", "data") if multi_pod else ("data",)``); names
computed at run time (``self.rules["heads"]``, ``bound_axes("batch")``'s
result) pass through.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import (
    FileContext,
    Finding,
    assigned_value,
    dotted_name,
    enclosing_function,
)

RULES = {
    "sharding-unknown-logical-axis": (
        "logical axis name not declared in repro_torch/dist/sharding.py's "
        "rule tables (it would silently stay unbound)"
    ),
    "sharding-unknown-mesh-axis": (
        "mesh axis name not used by any declared mesh (the group, spec or "
        "mesh would fail or silently replicate)"
    ),
    "sharding-silent-fallback": (
        "spec-tree structural-divergence fallback replicates without "
        "warning or raising"
    ),
}

_LOGICAL = "repro_torch.dist.logical"
_COLLECTIVES = "repro_torch.dist.collectives"
# (qualified function, argument index, keyword, vocabulary): the argument
# that names axes at each of the port's sharding APIs
_AXIS_ARGS = (
    (f"{_LOGICAL}.constrain", 1, "axes", "logical"),
    (f"{_LOGICAL}.bound_axes", 0, "name", "logical"),
    (f"{_LOGICAL}.group", 0, "axes", "mesh"),
    (f"{_LOGICAL}.shard_index", 1, "axes", "mesh"),
    (f"{_LOGICAL}.shards", 0, "binding", "mesh"),
    (f"{_COLLECTIVES}.block_mean", 1, "axes", "mesh"),
    (f"{_COLLECTIVES}.reduce_grads", 3, "axes", "mesh"),
    ("repro_torch.launch.mesh.Mesh", 1, "axis_names", "mesh"),
)
_SPEC = "repro_torch.dist.sharding.P"
_AXIS_RULES = f"{_LOGICAL}.axis_rules"
# methods of a Mesh whose first argument is one of its axes
_MESH_METHODS = ("axis_index", "block_group")


def _api(ctx: FileContext, func: ast.AST) -> str | None:
    """The port API ``func`` refers to: through imports, or by its last
    two parts where it is not resolved (``logical.constrain`` reached
    through a relative import)."""
    resolved = ctx.resolve(func)
    known = [a[0] for a in _AXIS_ARGS] + [_SPEC, _AXIS_RULES]
    if resolved is not None:
        return resolved if resolved in known else None
    dotted = dotted_name(func)
    if dotted is None or "." not in dotted:
        return None
    tail = ".".join(dotted.split(".")[-2:])
    return next((k for k in known if k.endswith("." + tail)), None)


def _arg(call: ast.Call, index: int, keyword: str) -> ast.AST | None:
    for kw in call.keywords:
        if kw.arg == keyword:
            return kw.value
    if len(call.args) > index and not any(
            isinstance(a, ast.Starred) for a in call.args[:index + 1]):
        return call.args[index]
    return None


def _axis_strings(ctx: FileContext, node: ast.AST, follow: bool = True):
    """(name, line) of the axis names a literal axes expression holds:
    strings, in tuples/lists, either arm of a conditional, both sides of a
    ``+``; a Name bound once in its function to such an expression (that
    calls nothing) is followed one level.  Calls, subscripts and the rest
    are computed at run time and hold none."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        yield node.value, node.lineno
    elif isinstance(node, (ast.Tuple, ast.List)):
        for e in node.elts:
            yield from _axis_strings(ctx, e, follow)
    elif isinstance(node, ast.IfExp):
        yield from _axis_strings(ctx, node.body, follow)
        yield from _axis_strings(ctx, node.orelse, follow)
    elif isinstance(node, ast.BinOp):
        yield from _axis_strings(ctx, node.left, follow)
        yield from _axis_strings(ctx, node.right, follow)
    elif isinstance(node, ast.Starred):
        yield from _axis_strings(ctx, node.value, follow)
    elif isinstance(node, ast.Name) and follow:
        value = assigned_value(node, enclosing_function(node, ctx.parents))
        if value is not None and not any(isinstance(n, ast.Call)
                                         for n in ast.walk(value)):
            yield from _axis_strings(ctx, value, False)


def _check_axis_strings(ctx: FileContext, node: ast.AST | None, vocab: str):
    if node is None:
        return
    names = (ctx.facts.logical_axes if vocab == "logical"
             else ctx.facts.mesh_axes)
    rule = f"sharding-unknown-{vocab}-axis"
    for s, line in _axis_strings(ctx, node):
        if s not in names:
            yield Finding(
                ctx.rel, line, rule,
                f'unknown {vocab} axis "{s}" (declared: '
                f"{', '.join(sorted(names))})",
            )


def _check_axis_rules(ctx: FileContext, call: ast.Call):
    rules_dict = _arg(call, 1, "rules")
    if not isinstance(rules_dict, ast.Dict):
        return
    for k, v in zip(rules_dict.keys, rules_dict.values):
        if isinstance(k, ast.Constant) and isinstance(k.value, str):
            if k.value not in ctx.facts.logical_axes:
                yield Finding(
                    ctx.rel, k.lineno, "sharding-unknown-logical-axis",
                    f'axis_rules key "{k.value}" is not a declared logical '
                    "axis",
                )
        yield from _check_axis_strings(ctx, v, "mesh")


def _check_rules_write(ctx: FileContext, node: ast.Assign):
    """``rules["kv_seq"] = ...`` — the launch layer's idiom for extending a
    logical_rules dict: the key must be a declared logical axis, the
    literal value mesh axes."""
    t = node.targets[0]
    if not (
        isinstance(t, ast.Subscript)
        and isinstance(t.value, ast.Name)
        and t.value.id == "rules"
        and isinstance(t.slice, ast.Constant)
        and isinstance(t.slice.value, str)
    ):
        return
    if t.slice.value not in ctx.facts.logical_axes:
        yield Finding(
            ctx.rel, node.lineno, "sharding-unknown-logical-axis",
            f'rules["{t.slice.value}"] writes an undeclared logical axis',
        )
    yield from _check_axis_strings(ctx, node.value, "mesh")


def _check_silent_fallback(ctx: FileContext, node: ast.If):
    """``if len(a) != len(b): <build replicated specs>`` with no warn/raise
    in the branch — the opt_spec_tree bug class."""
    test = node.test
    if not (
        isinstance(test, ast.Compare)
        and len(test.ops) == 1
        and isinstance(test.ops[0], ast.NotEq)
    ):
        return
    sides = [test.left, *test.comparators]
    if not all(
        isinstance(s, ast.Call)
        and isinstance(s.func, ast.Name)
        and s.func.id == "len"
        for s in sides
    ):
        return
    body_calls = [
        n for stmt in node.body for n in ast.walk(stmt)
        if isinstance(n, ast.Call)
    ]
    replicates = any(
        "replicated" in (dotted_name(c.func) or "").lower()
        for c in body_calls
    )
    if not replicates:
        return
    warns = any(
        (dotted_name(c.func) or "").split(".")[-1] in ("warn", "warning")
        for c in body_calls
    )
    raises = any(
        isinstance(n, ast.Raise)
        for stmt in node.body
        for n in ast.walk(stmt)
    )
    if not warns and not raises:
        yield Finding(
            ctx.rel, node.lineno, "sharding-silent-fallback",
            "structure-mismatch branch falls back to replicated specs "
            "without a warning or raise — add a structured warning and a "
            "strict= escape hatch",
        )


def run(ctx: FileContext):
    for node in ctx.nodes:
        if isinstance(node, ast.Call):
            api = _api(ctx, node.func)
            if api == _AXIS_RULES:
                yield from _check_axis_rules(ctx, node)
            elif api == _SPEC:
                for arg in node.args:
                    yield from _check_axis_strings(ctx, arg, "mesh")
            elif api is not None:
                _, index, keyword, vocab = next(
                    a for a in _AXIS_ARGS if a[0] == api)
                yield from _check_axis_strings(
                    ctx, _arg(node, index, keyword), vocab)
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr in _MESH_METHODS
                  and ctx.resolve(node.func) is None and node.args):
                yield from _check_axis_strings(ctx, node.args[0], "mesh")
        elif isinstance(node, ast.Assign):
            yield from _check_rules_write(ctx, node)
        elif isinstance(node, ast.If):
            yield from _check_silent_fallback(ctx, node)
