"""Architecture registry: --arch <id> -> config module.

Counterpart of ``repro.configs.registry``.  Each arch module exposes
``ARCH_ID``, ``KIND``, ``FULL``, ``SMOKE`` and ``SHAPES``.  The ids are the
reference's; ``get_arch`` returns only those whose models are ported and
raises ``KeyError`` for the rest, saying so.
"""
from __future__ import annotations

import importlib

ARCH_IDS = (
    "qwen2-7b",
    "llama3.2-3b",
    "deepseek-67b",
    "qwen2-moe-a2.7b",
    "olmoe-1b-7b",
    "graphsage-reddit",
    "wide-deep",
    "mind",
    "din",
    "dlrm-rm2",
)

# arch id -> config module, for the archs whose modules are ported
_MODULES = {
    "llama3.2-3b": "llama3_2_3b",
    "graphsage-reddit": "graphsage_reddit",
    "wide-deep": "wide_deep",
    "mind": "mind_arch",
    "din": "din_arch",
    "dlrm-rm2": "dlrm_rm2",
}


def get_arch(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCH_IDS)}")
    if arch_id not in _MODULES:
        raise KeyError(f"arch {arch_id!r} is not ported yet; ported: "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def list_archs() -> tuple[str, ...]:
    return ARCH_IDS
