"""Step-purity pass.

Counterpart of ``repro.analysis.rules_jit``.  What a host operation on a
traced value did inside ``jax.jit`` (fail or sync at trace time, print
once), it does inside the port's steps in another form: ``.item()``,
``.tolist()``, ``.cpu()``, ``.numpy()`` and ``float()``/``int()``/
``bool()`` of a tensor wait for the stream to drain, stall the launches
queued behind them, and make a CUDA-graph capture of the step fail.

Scope, found statically:

- ``forward`` of ``torch.nn.Module`` subclasses;
- ``forward`` and ``backward`` of ``torch.autograd.Function`` subclasses;
- the step functions a ``launch.steps.CellProgram`` runs: what is passed
  as its ``step_fn=`` or ``loss_fn=`` (a function of the enclosing scope,
  or a lambda), to ``CellProgram(...)`` or ``dataclasses.replace(...)``.

The tensor parameters of a scope are its parameters past ``self``/``ctx``
(for a step function, all of them), less those annotated as a Python
scalar or string.  A host sync that a scope truly needs carries a
``# repro: ignore[step-purity-host-sync]`` with its reason on its line.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import FileContext, Finding, dotted_name

RULES = {
    "step-purity-print": (
        "print inside a forward/backward or a cell's step function "
        "(a host write each step; it cannot be captured in a CUDA graph)"
    ),
    "step-purity-host-sync": (
        ".item()/.tolist()/.cpu()/.numpy() or float()/int()/bool() of a "
        "tensor parameter inside a step waits for the device"
    ),
    "step-purity-host-numpy": (
        "host numpy op applied to a tensor parameter inside a step — use "
        "torch"
    ),
}

_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
_SCALAR_ANNOTATIONS = {"int", "float", "bool", "str", "bytes"}
_MODULE_BASES = ("torch.nn.Module", "torch.nn.modules.module.Module")
_FUNCTION_BASES = ("torch.autograd.Function",
                   "torch.autograd.function.Function")


def _base_kind(ctx: FileContext, base: ast.AST, local: dict) -> str | None:
    resolved = ctx.resolve(base) or ""
    dotted = dotted_name(base) or ""
    if resolved in _MODULE_BASES or dotted.endswith("nn.Module"):
        return "module"
    if resolved in _FUNCTION_BASES or dotted.endswith("autograd.Function"):
        return "function"
    if isinstance(base, ast.Name):
        return local.get(base.id)
    return None


def _class_scopes(ctx: FileContext):
    """(function, label, skip-first-parameter) for every forward/backward
    in scope, classes taken in file order so that a subclass of a class of
    the file inherits its kind."""
    kinds: dict[str, str] = {}
    classes = sorted((n for n in ctx.nodes
                      if isinstance(n, ast.ClassDef)), key=lambda n: n.lineno)
    for cls in classes:
        kind = next((k for k in (_base_kind(ctx, b, kinds)
                                 for b in cls.bases) if k), None)
        if kind is None:
            continue
        kinds[cls.name] = kind
        methods = ("forward",) if kind == "module" else ("forward", "backward")
        for fn in cls.body:
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and fn.name in methods:
                yield fn, f"{cls.name}.{fn.name}", True


def _step_scopes(ctx: FileContext):
    """Functions and lambdas passed as a cell's ``step_fn``/``loss_fn``."""
    for node in ctx.nodes:
        if not isinstance(node, ast.Call):
            continue
        callee = (dotted_name(node.func) or "").split(".")[-1]
        if callee not in ("CellProgram", "replace"):
            continue
        for kw in node.keywords:
            if kw.arg not in ("step_fn", "loss_fn"):
                continue
            if isinstance(kw.value, ast.Lambda):
                yield kw.value, f"{kw.arg} lambda", False
            elif isinstance(kw.value, ast.Name):
                scope = ctx.parents.get(node)
                while scope is not None and not isinstance(
                        scope, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Module)):
                    scope = ctx.parents.get(scope)
                for fn in ast.walk(scope or ctx.tree):
                    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                            and fn.name == kw.value.id:
                        yield fn, f"{kw.arg} {fn.name}", False


def _tensor_params(fn, skip_first: bool) -> set[str]:
    a = fn.args
    params = [*a.posonlyargs, *a.args, *a.kwonlyargs]
    if skip_first and params:
        params = params[1:]
    out = set()
    for p in params:
        ann = p.annotation
        if isinstance(ann, ast.Name) and ann.id in _SCALAR_ANNOTATIONS:
            continue
        if isinstance(ann, ast.Constant) and ann.value in _SCALAR_ANNOTATIONS:
            continue
        out.add(p.arg)
    if a.vararg:
        out.add(a.vararg.arg)
    return out


def _check_scope(ctx: FileContext, fn, label: str, tensors: set[str]):
    body = fn.body if isinstance(fn.body, list) else [fn.body]
    for node in (n for stmt in body for n in ast.walk(stmt)):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Name) and node.func.id == "print":
            yield Finding(
                ctx.rel, node.lineno, "step-purity-print",
                f"print() inside {label}",
            )
        elif isinstance(node.func, ast.Attribute) \
                and node.func.attr in _SYNC_METHODS and not node.args:
            yield Finding(
                ctx.rel, node.lineno, "step-purity-host-sync",
                f".{node.func.attr}() inside {label} waits for the device",
            )
        elif (
            isinstance(node.func, ast.Name)
            and node.func.id in ("float", "int", "bool")
            and node.args
            and isinstance(node.args[0], ast.Name)
            and node.args[0].id in tensors
        ):
            yield Finding(
                ctx.rel, node.lineno, "step-purity-host-sync",
                f"{node.func.id}() of tensor parameter {node.args[0].id} "
                f"inside {label} waits for the device",
            )
        else:
            resolved = ctx.resolve(node.func)
            if (
                resolved
                and resolved.startswith("numpy.")
                and any(isinstance(a, ast.Name) and a.id in tensors
                        for a in node.args)
            ):
                yield Finding(
                    ctx.rel, node.lineno, "step-purity-host-numpy",
                    f"{resolved} applied to a tensor parameter of {label}",
                )


def run(ctx: FileContext):
    seen: set[tuple[int, str]] = set()
    for fn, label, skip_first in [*_class_scopes(ctx), *_step_scopes(ctx)]:
        for f in _check_scope(ctx, fn, label,
                              _tensor_params(fn, skip_first)):
            if (f.line, f.rule) not in seen:
                seen.add((f.line, f.rule))
                yield f
