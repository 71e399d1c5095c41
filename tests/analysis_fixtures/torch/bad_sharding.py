"""Known-bad corpus for the port's sharding pass (parsed, never run)."""
from repro_torch.dist import collectives, logical
from repro_torch.dist.sharding import P
from repro_torch.launch.mesh import Mesh


def logical_typos(x):
    x = logical.constrain(x, ("btch", None))  # expect: sharding-unknown-logical-axis
    seq = logical.bound_axes("kv_sq")  # expect: sharding-unknown-logical-axis
    return x, seq


def mesh_typos(mesh, x, grads, specs):
    g = logical.group("modle")  # expect: sharding-unknown-mesh-axis
    i = logical.shard_index(mesh, ("pod", "dta"))  # expect: sharding-unknown-mesh-axis
    m = collectives.block_mean(x, ("data", "pods"))  # expect: sharding-unknown-mesh-axis
    r = collectives.reduce_grads(grads, specs, mesh, axes="mdl")  # expect: sharding-unknown-mesh-axis
    j = mesh.axis_index("pdo")  # expect: sharding-unknown-mesh-axis
    return g, i, m, r, j, P(None, "modl")  # expect: sharding-unknown-mesh-axis


def rule_table_typos(mesh, fn, x):
    with logical.axis_rules(mesh, {
        "batch": "data",
        "hedas": "model",  # expect: sharding-unknown-logical-axis
        "heads": "modell",  # expect: sharding-unknown-mesh-axis
    }):
        rules = {"batch": ("data",)}
        rules["kv_sq"] = ("model",)  # expect: sharding-unknown-logical-axis
        return fn(x), rules


def meshes(multi_pod):
    axes = ("pods", "data", "model") if multi_pod else ("data", "model")  # expect: sharding-unknown-mesh-axis
    return (Mesh((2, 1, 1), axes, device_type="cpu"),
            Mesh((1, 2), ("data", "modl"), device_type="cpu"))  # expect: sharding-unknown-mesh-axis


def _replicated(ndim):
    return P(*([None] * ndim))


def silent_fallback(leaves, spec_leaves):
    if len(leaves) != len(spec_leaves):  # expect: sharding-silent-fallback
        return [_replicated(len(leaf.shape)) for leaf in leaves]
    return spec_leaves
