"""Architecture registry: --arch <id> -> config module.

Counterpart of ``repro.configs.registry``.  Each arch module exposes
``ARCH_ID``, ``KIND``, ``FULL``, ``SMOKE`` and ``SHAPES``.  The ids are the
reference's, every one of them ported.
"""
from __future__ import annotations

import importlib

_MODULES = {
    "qwen2-7b": "qwen2_7b",
    "llama3.2-3b": "llama3_2_3b",
    "deepseek-67b": "deepseek_67b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "graphsage-reddit": "graphsage_reddit",
    "wide-deep": "wide_deep",
    "mind": "mind_arch",
    "din": "din_arch",
    "dlrm-rm2": "dlrm_rm2",
}
ARCH_IDS = tuple(_MODULES)  # the reference's order


def get_arch(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def list_archs() -> tuple[str, ...]:
    return ARCH_IDS
