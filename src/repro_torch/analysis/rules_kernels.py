"""Kernel-discipline pass.

Counterpart of ``repro.analysis.rules_pallas``: what the reference's
Pallas rules kept true of its kernels (each reachable in a mode CI can
check against the plain version), the port keeps with these rules on its
hand-written CUDA kernels.

The kernel entries are the public functions of ``kernels/<name>/ops.py``
that reach a compiled launch: they refer, through any chain of functions,
to ``kernels._build.load``, which builds and loads a kernel's library.
The chain is read from the tree, within the file and across the kernel
package (:class:`repro_torch.analysis.core.RepoFacts`).

- ``kernel-silent-fallback``: a ``try`` whose body reaches a build or a
  launch, with a handler that does not end in ``raise`` or that calls the
  kernel package's ``ref`` (plain) module.  A kernel that fails to build
  or launch must fail the run, not hand its work to the plain version;
- ``kernel-no-plain``: a kernel entry that reaches no function of its
  sibling ``ref.py``, the plain version it is held to;
- ``kernel-not-on-card``: a kernel entry that ``chip_smoke.py`` or
  ``tests/test_torch_cuda.py`` does not name (both hold every entry against
  its plain version on the card);
- ``device-cpu-fallback``: a branch on ``torch.cuda.is_available()``
  whose arm taken without a card chooses ``"cpu"`` (or
  ``torch.device("cpu")``): code that carries on on the CPU when it finds
  no GPU.  The port's entry points run on the card unless the caller asks
  for the CPU.

The kernel rules apply to the port package, the device rule also to
``chip_smoke.py``.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import (
    BUILD_LOAD,
    PACKAGE,
    FileContext,
    Finding,
    call_graph,
    kernel_package,
    plain_prefix,
    reaching,
)

RULES = {
    "kernel-silent-fallback": (
        "a try around a kernel build or launch whose handler does not "
        "re-raise, or falls back to the plain (ref) version"
    ),
    "kernel-no-plain": (
        "kernel entry reaches no function of its sibling ref.py (no plain "
        "version to hold it to)"
    ),
    "kernel-not-on-card": (
        "kernel entry that chip_smoke.py or tests/test_torch_cuda.py does "
        "not name (not held to its plain version on the card)"
    ),
    "device-cpu-fallback": (
        "branch on torch.cuda.is_available() that carries on on the CPU "
        "when no GPU is found"
    ),
}

_REF_PREFIX = f"{PACKAGE}.kernels."


def _is_ref(q: str) -> bool:
    """A function of some kernel package's ``ref`` (plain) module."""
    parts = q.split(".")
    return q.startswith(_REF_PREFIX) and len(parts) > 4 and parts[3] == "ref"


class _Reach:
    """Which qualified names of this file reach a launch, and its own
    package's plain version (the file's graph joined to the facts)."""

    def __init__(self, ctx: FileContext, pkg: str | None):
        self.resolver = ctx.resolver
        graph = call_graph(ctx.tree, ctx.module, self.resolver)
        facts = ctx.facts
        self.builds = lambda q: q == BUILD_LOAD or q in facts.launchers
        self.launch = reaching(graph, self.builds)
        prefix = plain_prefix(pkg) if pkg else None
        self.plain = reaching(graph, lambda q: prefix is not None and (
            q.startswith(prefix) or q in facts.plain_reachers))


def _check_try(ctx: FileContext, node: ast.Try, reach: _Reach):
    refs = {
        reach.resolver.resolve(n)
        for stmt in node.body for n in ast.walk(stmt)
        if isinstance(n, (ast.Name, ast.Attribute))
        and isinstance(n.ctx, ast.Load)
    }
    if not any(q and (q in reach.launch or reach.builds(q)) for q in refs):
        return
    for h in node.handlers:
        plain = sorted({
            q for n in ast.walk(h)
            if isinstance(n, ast.Call)
            for q in [reach.resolver.resolve(n.func)] if q and _is_ref(q)
        })
        reraises = bool(h.body) and isinstance(h.body[-1], ast.Raise)
        if plain or not reraises:
            why = (f"calls the plain version {plain[0]}" if plain
                   else "does not end in raise")
            yield Finding(
                ctx.rel, h.lineno, "kernel-silent-fallback",
                f"handler of a try around a kernel build or launch {why} — "
                "let the failure stop the run",
            )


def _entries(ctx: FileContext, reach: _Reach):
    for node in ctx.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and not node.name.startswith("_") \
                and f"{ctx.module}.{node.name}" in reach.launch:
            yield node


def _check_entries(ctx: FileContext, pkg: str, reach: _Reach):
    for fn in _entries(ctx, reach):
        q = f"{ctx.module}.{fn.name}"
        if q not in reach.plain:
            yield Finding(
                ctx.rel, fn.lineno, "kernel-no-plain",
                f"kernel entry {fn.name} reaches no function of "
                f"kernels/{pkg}/ref.py",
            )
        named = {f"{PACKAGE}.kernels.{pkg}.ops.{fn.name}",
                 f"{PACKAGE}.kernels.{pkg}.{fn.name}",
                 f"{PACKAGE}.kernels.{fn.name}"}
        missing = [f for f, used in sorted(ctx.facts.on_card.items())
                   if not named & used]
        if missing:
            yield Finding(
                ctx.rel, fn.lineno, "kernel-not-on-card",
                f"kernel entry {fn.name} is not named by "
                f"{' or '.join(missing)}",
            )


def _is_available(ctx: FileContext, node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and ctx.resolve(node.func) == \
        "torch.cuda.is_available"


def _no_card_arm(ctx: FileContext, test: ast.AST, body, orelse):
    """The arm of ``if test`` taken without a card, or None where ``test``
    is not a plain check of ``torch.cuda.is_available()``."""
    if _is_available(ctx, test):
        return orelse
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not) \
            and _is_available(ctx, test.operand):
        return body
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And) \
            and any(_is_available(ctx, v) for v in test.values):
        return orelse
    return None


def _chooses_cpu(arm) -> bool:
    nodes = arm if isinstance(arm, list) else [arm]
    return any(
        isinstance(n, ast.Constant) and isinstance(n.value, str)
        and (n.value == "cpu" or n.value.startswith("cpu:"))
        for stmt in nodes for n in ast.walk(stmt)
    )


def _check_device(ctx: FileContext, node: ast.AST):
    if isinstance(node, (ast.If, ast.IfExp)):
        arm = _no_card_arm(ctx, node.test, node.body, node.orelse)
        if arm is not None and _chooses_cpu(arm):
            yield Finding(
                ctx.rel, node.lineno, "device-cpu-fallback",
                "without a GPU this branch carries on on the CPU — run on "
                "the card, or on the CPU only where the caller asks for it",
            )


def run(ctx: FileContext):
    on_smoke = ctx.path.name == "chip_smoke.py"
    if not (ctx.in_port or on_smoke):
        return
    for node in ctx.nodes:
        yield from _check_device(ctx, node)
    if not ctx.in_port:
        return
    pkg = kernel_package(ctx.module)
    reach = _Reach(ctx, pkg)
    for node in ctx.nodes:
        if isinstance(node, (ast.Try, ast.TryStar)):
            yield from _check_try(ctx, node, reach)
    if pkg is not None:
        yield from _check_entries(ctx, pkg, reach)
