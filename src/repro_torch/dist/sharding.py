"""Sharding policy: logical-axis rules, parameter and optimizer spec trees,
and each rank's block of a tree.

Counterpart of ``repro.dist.sharding``; the same rules for each
``ArchKind`` on the production meshes (``("data", "model")`` a pod,
``("pod", "data", "model")`` multi-pod):

- LMs: 2D data x tensor parallelism (heads and FFN width column-sharded,
  output projections row-sharded, the vocabulary sharded for the
  vocab-parallel loss, MoE expert stacks over the model axis);
- RecSys: only the combined embedding table, row-sharded over the model
  axis; the dense MLPs replicate;
- GNNs: parameters replicate, the graph shards over every mesh axis.

A spec is a ``Spec``: one binding a dimension (None, a mesh axis name, or a
tuple of names), the entries of the reference's ``PartitionSpec``
(``tuple(spec)`` compares equal to ``tuple(PartitionSpec(...))`` of the
same entries).  Trees are flattened with dict keys sorted, as
``jax.tree_util`` flattens them, so an optimizer sub-tree meets the
parameter specs in the reference's order.

``local_shard`` is the port's: it gives a rank its block of each leaf of a
whole tree, which is how a rank's state is made from the same numbers as a
single-device run.

Tensor parallelism keeps whole heads on a rank (``HeadSplit``).  Where
the "model" ranks outnumber the kv heads, the reference's GSPMD splits
the flat columns of ``wq`` (llama3.2-3b's 3,072 over 16 devices: 1.5
heads a device); the port instead replicates each kv head on the ranks
that share it and pads its group of q heads with zero heads to a
multiple of them.  That is another layout of the same function, whose
blocks ``local_shard(..., heads=)`` cuts.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.common.types import ArchKind, TensorSpec
from repro_torch.dist.logical import shard_index, shards


class ShardingFallbackWarning(UserWarning):
    """An optimizer sub-tree diverged from the parameter structure and its
    accumulators were conservatively replicated.

    Replication is correct but forfeits memory scaling: a replicated
    accumulator of a model-sharded multi-GB table sits whole on every rank.
    The warning names the diverging sub-tree and leaf paths; pass
    ``strict=True`` to turn it into an error."""


@dataclasses.dataclass(frozen=True)
class Spec:
    """Per-dimension mesh bindings of one leaf (a ``PartitionSpec``)."""

    axes: tuple = ()

    def __iter__(self):
        return iter(self.axes)

    def __len__(self) -> int:
        return len(self.axes)

    def __getitem__(self, i):
        return self.axes[i]


def P(*axes) -> Spec:
    """A ``Spec`` written as a ``PartitionSpec`` is: a one-axis tuple is
    that axis, an empty one None (as ``PartitionSpec`` stores them)."""
    def one(a):
        if isinstance(a, (list, tuple)):
            return None if not a else a[0] if len(a) == 1 else tuple(a)
        return a
    return Spec(tuple(one(a) for a in axes))


def logical_rules(kind: ArchKind, multi_pod: bool = False) -> dict:
    """Logical axis name -> mesh axis binding for one architecture family."""
    dp = ("pod", "data") if multi_pod else ("data",)
    rules = {
        "batch": dp,
        "model": "model",
    }
    if kind in (ArchKind.LM_DENSE, ArchKind.LM_MOE):
        rules.update(
            seq=None,            # sequence replicated (residual_seq opts in)
            residual_seq=None,   # bound to "model" by seq_shard configs
            embed=None,
            heads="model",
            kv_heads="model",
            ffn="model",
            vocab="model",
            expert="model",
            kv_seq=None,         # decode cells bind this (kv_seq_axes)
        )
    elif kind == ArchKind.GNN:
        # vertex/edge partition spreads the graph over the whole mesh
        rules["nodes"] = dp + ("model",)
    return rules


def kv_seq_axes(batch: int, multi_pod: bool = False) -> tuple[str, ...]:
    """Mesh axes the decode KV cache's sequence dimension shards over:
    "model" when the batch (>= 16) shards over the data axes, every axis
    when it is too small to split (long_500k, batch 1)."""
    dp = ("pod", "data") if multi_pod else ("data",)
    return dp + ("model",) if batch < 16 else ("model",)


def kv_cache_spec(batch: int, multi_pod: bool = False) -> Spec:
    """Spec of one stacked KV-cache leaf [L, B, S, KVH, hd] (the int8
    scales [L, B, S, KVH, 1] take the same): S over ``kv_seq_axes``, B
    over the data axes when it is large enough to split."""
    dp = ("pod", "data") if multi_pod else ("data",)
    if batch >= 16:
        return P(None, dp, kv_seq_axes(batch, multi_pod), None, None)
    return P(None, None, kv_seq_axes(batch, multi_pod), None, None)


# ---------------------------------------------------------------------------
# trees, flattened as jax.tree_util flattens them (dict keys sorted)
# ---------------------------------------------------------------------------


def _flatten(tree, path=(), is_leaf: Callable = lambda _: False):
    if not is_leaf(tree):
        if isinstance(tree, dict):
            return [kv for k in sorted(tree)
                    for kv in _flatten(tree[k], (*path, k), is_leaf)]
        if isinstance(tree, (list, tuple)):
            return [kv for i, v in enumerate(tree)
                    for kv in _flatten(v, (*path, i), is_leaf)]
    return [(path, tree)]


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, (*path, k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, (*path, i)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _unflatten_like(tree, leaves_by_path: dict):
    return _map_with_path(lambda p, _: leaves_by_path[p], tree)


def keystr(path) -> str:
    """A path as ``jax.tree_util.keystr`` writes it: ``['a'][0]``."""
    return "".join(f"[{k!r}]" for k in path)


def _spec(lead: int, ndim: int, shard_dim: int) -> Spec:
    axes = [None] * ndim
    axes[lead + shard_dim] = "model"
    return Spec(tuple(axes))


def _replicated(ndim: int) -> Spec:
    return Spec((None,) * ndim)


def _lm_leaf_spec(names: list, ndim: int) -> Spec:
    last = names[-1] if names else ""
    # per-layer params are stacked on a leading L axis under "blocks"
    lead = 1 if "blocks" in names else 0
    if last == "embed":
        return P("model", None)           # vocab-row sharded
    if last == "lm_head":
        return P(None, "model")           # vocab-column sharded
    if "experts" in names:
        return _spec(lead, ndim, 0)       # [L, E, ...]: expert parallel
    if last == "router":
        return _replicated(ndim)          # tiny; replicate for exact routing
    if last in ("wq", "wk", "wv", "bq", "bk", "bv"):
        return _spec(lead, ndim, ndim - lead - 1)  # heads column-sharded
    if last == "wo":
        return _spec(lead, ndim, 0)       # row-sharded (psum on output)
    if last in ("w_gate", "w_up"):
        return _spec(lead, ndim, ndim - lead - 1)  # ffn column-sharded
    if last == "w_down":
        return _spec(lead, ndim, 0)       # ffn row-sharded
    return _replicated(ndim)              # norms, biases


def _recsys_leaf_spec(names: list, ndim: int) -> Spec:
    # the combined embedding table (and its hot/cold split) row-shards over
    # the model axis; everything dense replicates
    if names and names[-1] in ("table", "hot", "cold") and ndim == 2:
        return P("model", None)
    return _replicated(ndim)


def _names(path) -> list:
    return [k for k in path if isinstance(k, str)]


def param_spec_tree(kind: ArchKind, params):
    """Spec tree matching ``params`` (leaves with a ``.shape``: tensors,
    numpy arrays, ``TensorSpec``s)."""

    def leaf_spec(path, leaf):
        names, ndim = _names(path), len(leaf.shape)
        if kind in (ArchKind.LM_DENSE, ArchKind.LM_MOE):
            return _lm_leaf_spec(names, ndim)
        if kind == ArchKind.RECSYS:
            return _recsys_leaf_spec(names, ndim)
        return _replicated(ndim)          # GNN: pure data parallel

    return _map_with_path(leaf_spec, params)


def opt_spec_tree(kind: ArchKind, opt_state, param_specs, strict: bool = False):
    """Spec tree of an optimizer state.

    Sub-trees that mirror the parameter tree ("m"/"v"/"mu"/"acc") inherit
    each parameter's spec, positionally (a row-wise accumulator [rows, 1]
    of a [rows, dim] table keeps the row sharding; a leaf of another rank
    replicates); a scalar counter ("step") replicates.  A sub-tree whose
    leaf count differs from the parameters' replicates with a
    ``ShardingFallbackWarning`` naming its paths; ``strict=True`` raises
    ``ValueError`` instead."""
    spec_leaves = [s for _, s in _flatten(
        param_specs, is_leaf=lambda x: isinstance(x, Spec))]

    def mirrored(name, sub):
        flat = _flatten(sub)
        leaves = [l for _, l in flat]
        if len(leaves) != len(spec_leaves):
            msg = (
                f'optimizer sub-tree "{name}" has {len(leaves)} leaves but '
                f"params have {len(spec_leaves)}; replicating "
                f"{[keystr(p) for p, _ in flat]}"
            )
            if strict:
                raise ValueError(f"opt_spec_tree: {msg}")
            warnings.warn(msg, ShardingFallbackWarning, stacklevel=3)
            fitted = [_replicated(len(l.shape)) for l in leaves]
        else:
            fitted = [
                s if len(s) == len(l.shape) else _replicated(len(l.shape))
                for l, s in zip(leaves, spec_leaves)
            ]
        return _unflatten_like(sub, {p: f for (p, _), f in zip(flat, fitted)})

    out = {}
    for name, sub in opt_state.items():
        sub_leaves = [l for _, l in _flatten(sub)]
        if not sub_leaves:
            out[name] = sub                      # e.g. momentum-less sgd {}
        elif len(sub_leaves) == 1 and not len(sub_leaves[0].shape):
            out[name] = P()                      # scalar step counter
        else:
            out[name] = mirrored(name, sub)
    return out


# ---------------------------------------------------------------------------
# whole heads over the "model" ranks
# ---------------------------------------------------------------------------

_Q_LEAVES = ("wq", "bq", "wo")      # columns (wo: rows) of the q heads
_KV_LEAVES = ("wk", "wv", "bk", "bv")  # columns of the kv heads


@dataclasses.dataclass(frozen=True)
class HeadSplit:
    """Whole attention heads over the ``ranks`` ranks of the "model" axes:
    ``n_heads`` q heads in ``n_kv_heads`` groups of g = n_heads /
    n_kv_heads.

    - ``n_kv_heads >= ranks`` (a multiple of them): rank i holds kv heads
      [i k, (i + 1) k), k = n_kv_heads / ranks, and their g k q heads;
    - ``n_kv_heads < ranks`` (a divisor of them): kv head j is whole on
      the ``share`` = ranks / n_kv_heads ranks [j share, (j + 1) share),
      replicated, and its g q heads, padded with zero heads to
      ceil(g / share) * share, are split over them in order.  A padded
      head's ``wq`` columns and ``wo`` rows are zero, so it adds nothing,
      and it takes no gradient (``pad_mask``).

    ``HeadSplit.of`` raises for any other case, naming the config."""

    n_heads: int
    n_kv_heads: int
    ranks: int

    @classmethod
    def of(cls, name: str, n_heads: int, n_kv_heads: int, ranks: int
           ) -> "HeadSplit":
        if n_heads % n_kv_heads:
            raise ValueError(f"{name}: {n_heads} heads do not group over "
                             f"{n_kv_heads} kv_heads")
        if (n_kv_heads % ranks if n_kv_heads >= ranks
                else ranks % n_kv_heads):
            raise ValueError(f"{name}: {n_kv_heads} kv_heads neither split "
                             f"over nor divide the {ranks} ranks of the "
                             f"heads' axes")
        return cls(n_heads, n_kv_heads, ranks)

    @property
    def group(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def share(self) -> int:
        """Ranks that hold each kv head (1: no replication)."""
        return max(1, self.ranks // self.n_kv_heads)

    @property
    def kv_local(self) -> int:
        return max(1, self.n_kv_heads // self.ranks)

    @property
    def q_local(self) -> int:
        """q heads a rank holds, padding included."""
        return -(-self.group // self.share) * self.kv_local

    @property
    def padded(self) -> bool:
        return self.q_local * self.ranks > self.n_heads

    def kv_heads(self, i: int) -> list[int]:
        """The kv heads rank i (its index over the heads' axes) holds."""
        if self.share == 1:
            return list(range(i * self.kv_local, (i + 1) * self.kv_local))
        return [i // self.share]

    def q_heads(self, i: int) -> list[int]:
        """The q head in each of rank i's slots, -1 for a padded one."""
        g = self.group
        if self.share == 1:
            return [j * g + t for j in self.kv_heads(i) for t in range(g)]
        j, p, m = i // self.share, i % self.share, self.q_local
        return [j * g + t if t < g else -1 for t in range(p * m, (p + 1) * m)]


def head_leaf(names) -> str | None:
    """"q" or "kv" for an attention leaf cut by heads, else None."""
    last = names[-1] if names else ""
    if "attn" not in names:
        return None
    return "q" if last in _Q_LEAVES else "kv" if last in _KV_LEAVES else None


def _head_index(heads: list[int], hd: int):
    """The flat columns of ``heads`` (-1: a padded head, column 0) and the
    mask of the real ones."""
    cols = np.array([max(h, 0) * hd + c for h in heads for c in range(hd)],
                    dtype=np.int64)
    real = np.repeat(np.array([h >= 0 for h in heads]), hd)
    return cols, real


def _head_dim_axis(names, ndim: int) -> int:
    """The axis of a head-cut leaf that holds the heads: wo's rows, the
    last axis of every other one."""
    return ndim - 2 if names[-1] == "wo" else ndim - 1


def head_block(leaf, names, split: HeadSplit, i: int, hd: int):
    """Rank i's block of a whole attention leaf (``head_leaf(names)``):
    the columns (``wo``: rows) of its heads, zero for a padded head.  A
    ``TensorSpec`` comes back with the block's shape."""
    kind = head_leaf(names)
    heads = split.q_heads(i) if kind == "q" else split.kv_heads(i)
    axis = _head_dim_axis(names, len(leaf.shape))
    if isinstance(leaf, TensorSpec):
        shape = list(leaf.shape)
        shape[axis] = len(heads) * hd
        return TensorSpec(tuple(shape), leaf.dtype)
    cols, real = _head_index(heads, hd)
    if isinstance(leaf, torch.Tensor):
        out = leaf.index_select(axis,
                                torch.as_tensor(cols, device=leaf.device))
        if not real.all():
            shape = [1] * out.dim()
            shape[axis] = -1
            out = out * torch.as_tensor(real, device=leaf.device).reshape(
                shape).to(out.dtype)
        return out.contiguous()
    out = np.take(leaf, cols, axis=axis)
    if not real.all():
        shape = [1] * out.ndim
        shape[axis] = -1
        out = out * real.reshape(shape).astype(out.dtype)
    return np.ascontiguousarray(out)


def pad_mask(names, split: HeadSplit, i: int, hd: int, ndim: int):
    """(axis, bool numpy mask of the head axis) of rank i's padded q-head
    entries in a "q" leaf, or None where it holds no padding."""
    if head_leaf(names) != "q" or not split.padded:
        return None
    _, real = _head_index(split.q_heads(i), hd)
    if real.all():
        return None
    return _head_dim_axis(names, ndim), ~real


# ---------------------------------------------------------------------------
# a rank's block
# ---------------------------------------------------------------------------


def local_shape(shape, spec: Spec, mesh) -> tuple[int, ...]:
    """The shape of this rank's block of a leaf of global ``shape``."""
    out = []
    for n, b in zip(shape, spec):
        k = shards(b, mesh) if b else 1
        if n % k:
            raise ValueError(f"dimension of {n} does not split into {k} "
                             f"shards ({b})")
        out.append(n // k)
    return tuple(out)


def _block(leaf, spec: Spec, mesh):
    if len(spec) != len(leaf.shape):
        raise ValueError(f"spec {tuple(spec)} for a leaf of shape "
                         f"{tuple(leaf.shape)}")
    index = []
    for n, b in zip(leaf.shape, spec):
        if not b:
            index.append(slice(None))
            continue
        k = n // shards(b, mesh)
        i = shard_index(mesh, b)
        index.append(slice(i * k, (i + 1) * k))
    local_shape(leaf.shape, spec, mesh)  # raises on a dimension that does not split
    block = leaf[tuple(index)]
    if not isinstance(block, torch.Tensor):
        return block
    if block.untyped_storage().nbytes() > block.numel() * block.element_size():
        # a copy of the block alone: a view would keep the whole leaf alive
        return block.clone(memory_format=torch.contiguous_format)
    return block.contiguous()


def local_shard(tree, spec_tree, mesh, heads: tuple | None = None):
    """This rank's block of every leaf: a dimension bound to axes (a, b)
    is cut into size(a) * size(b) blocks, and the rank takes block i =
    idx(a) * size(b) + idx(b), major first (as ``seq_shard_index`` orders
    it).  Tensors come back contiguous; ``TensorSpec`` leaves come back
    with their local shape.  ``heads=(split, head_dim)`` cuts an LM's
    attention leaves by whole heads (``head_block``; the heads' axes are
    their spec's) instead of by flat columns."""
    flat = dict(_flatten(spec_tree, is_leaf=lambda x: isinstance(x, Spec)))

    def one(path, leaf):
        spec = flat[path]
        if heads is not None and head_leaf(_names(path)):
            split, hd = heads
            axes = [b for b in spec if b]
            i = shard_index(mesh, axes[0]) if axes else 0
            return head_block(leaf, _names(path), split, i, hd)
        if isinstance(leaf, TensorSpec):
            return TensorSpec(local_shape(leaf.shape, spec, mesh), leaf.dtype)
        return _block(leaf, spec, mesh)

    return _map_with_path(one, tree)


def replicated_specs(tree) -> Any:
    """A spec tree that replicates every leaf of ``tree``."""
    return _map_with_path(lambda _, l: _replicated(len(l.shape)), tree)
