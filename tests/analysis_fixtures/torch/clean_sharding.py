"""Clean counterpart for the port's sharding pass: zero findings."""
import warnings

from repro_torch.dist import collectives, logical
from repro_torch.dist.sharding import P
from repro_torch.launch.mesh import Mesh


def declared_axes(x, mesh, grads, specs, seq):
    x = logical.constrain(x, ("batch", "residual_seq" if seq else None,
                              "embed"))
    heads = logical.bound_axes("heads")
    m = collectives.block_mean(x, ("pod", "data"))
    r = collectives.reduce_grads(grads, specs, mesh, ("data",))
    return x, heads, m, r, P(("pod", "data"), "model"), mesh.axis_index("model")


def runtime_axes_pass_through(x, mesh, rules):
    # computed names are out of static reach: never flagged
    g = logical.group(tuple(mesh.axis_names))
    i = logical.shard_index(mesh, rules["heads"])
    n = logical.shards(logical.bound_axes("batch"), mesh)
    return g, i, n


def rule_table_ok(mesh, fn, x, multi_pod):
    dp = ("pod", "data") if multi_pod else ("data",)
    with logical.axis_rules(mesh, {"batch": dp, "heads": "model"}):
        rules = {"batch": dp}
        rules["kv_seq"] = dp + ("model",)
        return fn(x), rules, Mesh((1, 1), ("data", "model"), device_type="cpu")


def _replicated(ndim):
    return P(*([None] * ndim))


def guarded_fallback(leaves, spec_leaves):
    # the warning makes the divergence visible: not a silent fallback
    if len(leaves) != len(spec_leaves):
        warnings.warn("optimizer tree diverged from params")
        return [_replicated(len(leaf.shape)) for leaf in leaves]
    return spec_leaves
