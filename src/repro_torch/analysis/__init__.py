"""Static analysis of the PyTorch/CUDA port.

Counterpart of ``repro.analysis``: four AST passes hold whole-port
invariants that the tests can only sample.  Sharding axis names at the
port's APIs against ``repro_torch/dist/sharding.py``'s rule tables; the
kernel discipline (no silent fallback from a kernel to its plain version
or from the card to the CPU, every kernel entry with a plain version and
held to it on the card); simulated-path determinism, with explicit
``torch.Generator``s; and step purity (no host sync inside a forward, a
backward or a cell's step).  Run with ``python -m repro_torch.analysis``;
see ``docs/torch_static_analysis.md`` for the rule catalog.  Suppressions
use the reference's syntax, ``# repro: ignore[rule]``.

The package imports neither torch nor jax, nor anything of ``repro``: it
loads in any Python.
"""
from repro_torch.analysis.core import (
    Finding,
    RepoFacts,
    Report,
    analyze_file,
    analyze_paths,
    default_roots,
    rule_catalog,
)

__all__ = [
    "Finding",
    "RepoFacts",
    "Report",
    "analyze_file",
    "analyze_paths",
    "default_roots",
    "rule_catalog",
]
