"""Pytrees of tensors: nested dicts and lists (tuples read as lists), the
port's form of the reference's parameter and optimizer-state trees.

A leaf's path is the tuple of its dict keys (str) and list indices (int),
as ``jax.tree_util``'s key paths name them.
"""
from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure) -> a tree of the results."""
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def tree_map_with_path(fn: Callable, tree, *rest, _path: tuple = ()):
    """``fn(path, leaf, *leaves)`` over the leaves -> a tree of results."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      _path=(*_path, k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_path(fn, v, *(r[i] for r in rest),
                                   _path=(*_path, i))
                for i, v in enumerate(tree)]
    return fn(_path, tree, *rest)


def tree_leaves(tree) -> list[Any]:
    """The leaves in the order ``tree_map`` visits them."""
    out: list[Any] = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree, leaves) -> Any:
    """A tree of ``tree``'s structure holding ``leaves`` in leaf order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
