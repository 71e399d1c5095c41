"""Logical-axis bindings: which mesh axes shard which logical dimension.

Counterpart of ``repro.dist.logical``.  Model code names *logical* axes
("batch", "model", "kv_seq", "vocab", ...); the launcher binds them to mesh
axes with ``axis_rules`` around a step.  Without a binding every helper is
a no-op and every distributed function is the single-device one, the
reference's "no binding = local" rule.

The reference leaves data movement to GSPMD: ``constrain`` is a
``with_sharding_constraint``.  In eager torch nothing inserts collectives,
so each sharded function is an explicit dataflow over the process groups
``group`` returns, and ``constrain`` only checks that a tensor has the
local shape its binding implies; it moves nothing.

The binding is per thread, like the reference's (entered around a step,
not stored in the model).
"""
from __future__ import annotations

import contextlib
import math
import threading

_STATE = threading.local()


def _context():
    """The innermost (mesh, rules) binding, or None."""
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def axis_rules(mesh, rules: dict):
    """Bind logical axis names to mesh axes for the enclosed calls.

    ``mesh``: a ``repro_torch.launch.mesh.Mesh``; ``rules`` maps logical
    name -> mesh axis name, tuple of mesh axis names or None (replicated).
    Nesting is allowed; the innermost binding wins."""
    prev = _context()
    _STATE.ctx = (mesh, dict(rules))
    try:
        yield
    finally:
        _STATE.ctx = prev


def current_mesh():
    """The mesh of the active binding, or None."""
    ctx = _context()
    return None if ctx is None else ctx[0]


def current_rules() -> dict | None:
    """The logical -> mesh rules of the active binding, or None."""
    ctx = _context()
    return None if ctx is None else ctx[1]


def as_axes(axes) -> tuple[str, ...]:
    if axes is None:
        return ()
    if isinstance(axes, str):
        return (axes,)
    return tuple(axes)


def resolve(axes) -> tuple:
    """Logical names (or None), one a dimension -> the mesh binding of each
    (None, an axis name or a tuple of names), as the entries of the
    reference's ``PartitionSpec``.  Unbound names resolve to None."""
    ctx = _context()
    rules = {} if ctx is None else ctx[1]
    return tuple(None if a is None else rules.get(a) for a in axes)


def shards(binding, mesh) -> int:
    """How many pieces one dimension bound to ``binding`` is cut into."""
    return math.prod(mesh.shape[a] for a in as_axes(binding))


def shard_index(mesh, axes) -> int:
    """This rank's block along a dimension sharded over ``axes``: the
    major-first flat index i = idx(a) * size(b) + idx(b), the order of a
    ``PartitionSpec`` over several axes."""
    i = 0
    for a in as_axes(axes):
        i = i * mesh.shape[a] + mesh.axis_index(a)
    return i


def constrain(x, axes, shape=None):
    """Check, under a binding, that ``x`` (one logical name or None a
    dimension) is this rank's block of a tensor of global ``shape``: each
    bound dimension holds its global size over its shards.  Returns ``x``
    unchanged; without a binding it checks nothing.  ``shape`` None checks
    only the rank."""
    ctx = _context()
    if ctx is None:
        return x
    if len(axes) != x.dim():
        raise ValueError(f"constrain: {len(axes)} logical axes for rank-"
                         f"{x.dim()} tensor")
    if shape is not None:
        mesh = ctx[0]
        want = tuple(n // shards(b, mesh) if b else n
                     for n, b in zip(shape, resolve(axes)))
        if tuple(x.shape) != want:
            raise ValueError(f"constrain: local shape {tuple(x.shape)} is "
                             f"not the block {want} of {tuple(shape)} under "
                             f"{resolve(axes)}")
    return x


def bound_axes(name: str) -> tuple:
    """Mesh axes bound to one logical name, as a tuple; () without a
    binding, for an unbound name or for one bound to None.  This is how
    ``repro_torch.dist.decode`` finds the "kv_seq" axes."""
    ctx = _context()
    if ctx is None:
        return ()
    return as_axes(ctx[1].get(name))


def model_axis_name():
    """Mesh axis bound to the logical "model" axis, or None: the switch of
    the embedding, MoE and loss layers onto their sharded dataflows."""
    ctx = _context()
    if ctx is None:
        return None
    return ctx[1].get("model")


def group(axes):
    """The process group of this rank over the mesh ``axes`` (a name or a
    tuple) of the bound mesh.  Raises without a binding, or when the
    default process group is not initialised."""
    import torch.distributed as dist

    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError("no mesh is bound (logical.axis_rules)")
    if not dist.is_initialized():
        raise RuntimeError("a mesh is bound but no process group is "
                           "initialised")
    return mesh.group(as_axes(axes))
