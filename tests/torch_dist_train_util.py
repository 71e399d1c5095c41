"""Helpers of the mesh train tests (``tests/test_torch_dist_train*.py``):
a rank's block of a whole reference array, the whole array from the
ranks' blocks, and the tolerance check.  Imports neither jax nor the
reference."""
import numpy as np

from repro_torch.common.tree import tree_map
from repro_torch.dist.sharding import local_shard


class RankMesh:
    """The shape and one rank's coordinates of a mesh, as ``local_shard``
    reads them (no process group)."""

    def __init__(self, shape: dict, coords: dict):
        self.shape, self.coords = dict(shape), dict(coords)
        self.axis_names = tuple(shape)

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))


def block(tree, specs, shape: dict, coords: dict, heads=None):
    """A rank's block of every leaf of a whole numpy tree (``heads``:
    ``local_shard``'s whole-head cut of the attention leaves)."""
    return local_shard(tree, specs, RankMesh(shape, coords), heads=heads)


def assemble(blocks: list, specs, shape: dict, coords: list):
    """The whole tree from every rank's blocks (rank order, ``coords`` a
    dict a rank); a leaf held by several ranks must be the same on each."""
    def whole(spec, *leaves):
        full_shape = [n * (int(np.prod([shape[a] for a in
                                        (b if isinstance(b, tuple) else (b,))]))
                           if b else 1)
                      for n, b in zip(leaves[0].shape, spec)]
        out = np.full(full_shape, np.nan, np.float32)
        seen = np.zeros(full_shape, bool)
        for leaf, c in zip(leaves, coords):
            idx = np.arange(out.size).reshape(full_shape)
            at = block(idx, spec, shape, c)
            flat_out, flat_seen = out.reshape(-1), seen.reshape(-1)
            again = flat_seen[at]
            assert np.array_equal(flat_out[at][again], leaf[again]), \
                "replicated blocks differ between ranks"
            flat_out[at] = leaf
            flat_seen[at] = True
        assert seen.all()
        return out
    return tree_map(whole, specs, *blocks)


def close(got, want, tol, mask=None):
    """``got`` within ``tol`` of ``want``, scaled by the largest |want|."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    if mask is not None:
        got, want = got[mask], want[mask]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)
