"""Simulation-determinism pass.

Counterpart of ``repro.analysis.rules_determinism``, scoped to the port's
paths.  The port's serving results (the cluster day bitwise the CPU day,
K4 bitwise ``engine._sweep``) assume a reproducible simulation: seeded
``np.random.Generator`` objects threaded through, virtual time from the
event loop, and ordered containers feeding ordered results.

Scope of the reference's four rules: the simulated paths,
``repro_torch/serving/{engine,event_core,simulator,cluster_runtime,
scenarios,geo}.py`` and ``repro_torch/core/`` (plus the lint fixture
corpus); the launchers, benchmarks and tests may use wall clocks.

- ``determinism-global-rng``: ``np.random.<draw>`` module-level RNG calls
  (seeded constructor entry points like ``default_rng``/``SeedSequence``
  are fine);
- ``determinism-stdlib-random``: any call on the stdlib ``random`` module;
- ``determinism-wall-clock``: ``time.time``/``monotonic``/``perf_counter``
  (and ``_ns`` variants);
- ``determinism-set-order``: iterating a ``set`` (for-loop, comprehension,
  ``sum``/``join`` reduction) where the result order matters.

One rule of the port's own, over the whole port package (not its tests):

- ``determinism-torch-global-rng``: a torch draw (``torch.rand``,
  ``randn``, ``randint``, ``randperm``, ``normal``, ``bernoulli``,
  ``multinomial``, ``Tensor.uniform_``/``normal_``/``random_``…, the
  ``torch.nn.init`` draws) without ``generator=``, or a seeding of torch's
  global generators (``torch.manual_seed``, ``torch.seed``,
  ``torch.cuda.manual_seed*``).  The port draws from explicit
  ``torch.Generator``s made from a seed, as
  ``repro_torch.models.embedding`` does; a global stream makes a run's
  weights depend on whatever drew before it.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import FileContext, Finding, dotted_name

RULES = {
    "determinism-global-rng": (
        "unseeded module-level numpy RNG in a simulated path — thread a "
        "seeded np.random.Generator instead"
    ),
    "determinism-stdlib-random": (
        "stdlib random (global Mersenne state) in a simulated path — "
        "thread a seeded np.random.Generator instead"
    ),
    "determinism-wall-clock": (
        "wall-clock read in a simulated path — use the event loop's "
        "virtual clock"
    ),
    "determinism-set-order": (
        "iteration over a set feeds an ordered result — sort it or use an "
        "ordered container"
    ),
    "determinism-torch-global-rng": (
        "torch draw without generator= (or a seeding of torch's global "
        "generators) in the port package — pass an explicit "
        "torch.Generator"
    ),
}

# determinism scope: the port's simulated hot paths, plus the lint fixture
# corpus (so known-bad fixtures are in scope by construction)
_SCOPE_MARKERS = (
    "repro_torch/serving/engine.py",
    "repro_torch/serving/event_core.py",
    "repro_torch/serving/simulator.py",
    "repro_torch/serving/cluster_runtime.py",
    "repro_torch/serving/scenarios.py",
    "repro_torch/serving/geo.py",
    "repro_torch/core/",
    "analysis_fixtures",
)

# numpy.random entry points that construct/derive seeded state rather than
# drawing from the hidden global stream
_SEEDED_CONSTRUCTORS = {
    "default_rng", "Generator", "SeedSequence", "PCG64", "PCG64DXSM",
    "Philox", "SFC64", "MT19937", "BitGenerator", "RandomState",
}

_WALL_CLOCK = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.process_time",
    "time.process_time_ns",
}

# torch functions that draw from a generator (the global one unless given)
_TORCH_DRAWS = {
    "rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
    "randperm", "normal", "bernoulli", "multinomial", "poisson",
}
# in-place Tensor draws; torch.nn.init's draws share the names and add these
_TENSOR_DRAWS = {
    "uniform_", "normal_", "random_", "bernoulli_", "exponential_",
    "geometric_", "cauchy_", "log_normal_",
}
_INIT_DRAWS = {
    "trunc_normal_", "xavier_uniform_", "xavier_normal_", "kaiming_uniform_",
    "kaiming_normal_", "orthogonal_", "sparse_",
}
_TORCH_SEEDING = {
    "torch.manual_seed", "torch.seed", "torch.random.manual_seed",
    "torch.random.seed", "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
    "torch.cuda.seed", "torch.cuda.seed_all",
}


def _in_scope(rel: str) -> bool:
    return any(m in rel for m in _SCOPE_MARKERS)


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id in ("set", "frozenset")
    )


def _check_call(ctx: FileContext, node: ast.Call):
    resolved = ctx.resolve(node.func)
    if resolved is None:
        return
    if resolved.startswith("numpy.random."):
        leaf = resolved.rsplit(".", 1)[1]
        if leaf not in _SEEDED_CONSTRUCTORS:
            yield Finding(
                ctx.rel, node.lineno, "determinism-global-rng",
                f"np.random.{leaf}() draws from the global stream — use a "
                "seeded Generator",
            )
    elif resolved.startswith("random."):
        leaf = resolved.rsplit(".", 1)[1]
        if leaf not in ("Random", "SystemRandom"):
            yield Finding(
                ctx.rel, node.lineno, "determinism-stdlib-random",
                f"random.{leaf}() uses the process-global Mersenne state",
            )
    elif resolved in _WALL_CLOCK:
        yield Finding(
            ctx.rel, node.lineno, "determinism-wall-clock",
            f"{resolved}() reads the wall clock inside a simulated path",
        )


def _check_set_iteration(ctx: FileContext, node: ast.AST):
    if isinstance(node, ast.For) and _is_set_expr(node.iter):
        yield Finding(
            ctx.rel, node.iter.lineno, "determinism-set-order",
            "for-loop iterates a set in an order-sensitive path",
        )
    elif isinstance(
        node, (ast.ListComp, ast.GeneratorExp, ast.DictComp)
    ):
        for gen in node.generators:
            if _is_set_expr(gen.iter):
                yield Finding(
                    ctx.rel, gen.iter.lineno, "determinism-set-order",
                    "comprehension iterates a set into an ordered result",
                )
    elif isinstance(node, ast.Call):
        # sum(set)/"".join(set): order-dependent float accumulation / text
        dotted = dotted_name(node.func) or ""
        leaf = dotted.split(".")[-1]
        if leaf in ("sum", "join") and node.args and _is_set_expr(
            node.args[0]
        ):
            yield Finding(
                ctx.rel, node.lineno, "determinism-set-order",
                f"{leaf}() over a set accumulates in hash order",
            )


def _check_torch_rng(ctx: FileContext, node: ast.Call):
    resolved = ctx.resolve(node.func) or ""
    if resolved in _TORCH_SEEDING:
        yield Finding(
            ctx.rel, node.lineno, "determinism-torch-global-rng",
            f"{resolved}() seeds torch's global generator — make a "
            "torch.Generator from the seed and pass it",
        )
        return
    if any(kw.arg == "generator" for kw in node.keywords):
        return
    leaf = resolved.rsplit(".", 1)[-1]
    draw = (
        resolved in {f"torch.{d}" for d in _TORCH_DRAWS}
        or (resolved.startswith("torch.nn.init.")
            and leaf in _TENSOR_DRAWS | _INIT_DRAWS)
        or (isinstance(node.func, ast.Attribute)
            and node.func.attr in _TENSOR_DRAWS)
    )
    if draw:
        what = resolved or f".{node.func.attr}"
        yield Finding(
            ctx.rel, node.lineno, "determinism-torch-global-rng",
            f"{what}() without generator= draws from torch's global "
            "generator",
        )


def run(ctx: FileContext):
    # the torch rule covers the whole package; the simulated scope lies in
    # it (and holds the lint corpus)
    simulated = _in_scope(ctx.rel)
    if not (simulated or ctx.in_port):
        return
    for node in ctx.nodes:
        if isinstance(node, ast.Call):
            if simulated:
                yield from _check_call(ctx, node)
            yield from _check_torch_rng(ctx, node)
        if simulated:
            yield from _check_set_iteration(ctx, node)
