"""The distributed layer's rule tables, mesh and binding.

In process (no ranks): ``logical_rules``, ``kv_seq_axes`` and
``kv_cache_spec`` for every ``ArchKind`` and both ``multi_pod`` values,
and ``param_spec_tree`` / ``opt_spec_tree`` over the reference's own SMOKE
parameters and optimizer states of every architecture (numpy leaves), all
equal to the reference's ``PartitionSpec``s; the ``ShardingFallbackWarning``
cases of ``tests/test_sharding_specs.py`` with the reference's messages.
With four gloo ranks on the CPU (one ``spawn`` for the file): the (2, 2)
("data", "model") mesh's coordinates and groups, ``local_shard``'s blocks,
``constrain``, and ``build_cell``'s decode cells on the mesh (the
reference's ``tests/test_distributed.py:226-234`` assertions).  Also
``_build.build_lock`` across two processes."""
import multiprocessing
import warnings

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import torch_dist_ranks as ranks
from repro.common.types import ArchKind as JKind
from repro.configs.registry import ARCH_IDS, get_arch
from repro.dist import sharding as j_sh
from repro.launch.steps import RECSYS_INIT
from repro.models import gnn as j_gnn
from repro.models import transformer as j_tf
from repro.train import optimizer as j_opt
from repro_torch.common.types import ArchKind as TKind
from repro_torch.dist import logical
from repro_torch.dist import sharding as t_sh
from repro_torch.launch.mesh import Mesh, spawn


def _kind(k: JKind) -> TKind:
    return TKind(k.value)


def _norm(tree, is_leaf):
    """A tree with its spec leaves as plain tuples, tuples of subtrees as
    lists (the port's trees hold lists)."""
    if is_leaf(tree):
        return tuple(tuple(a) if isinstance(a, (list, tuple)) else a
                     for a in tree)
    if isinstance(tree, dict):
        return {k: _norm(v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_norm(v, is_leaf) for v in tree]
    return tree


def _ref(tree):
    return _norm(tree, lambda x: isinstance(x, JP))


def _port(tree):
    return _norm(tree, lambda x: isinstance(x, t_sh.Spec))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("kind", list(JKind))
def test_logical_rules_and_kv_specs(kind, multi_pod):
    assert t_sh.logical_rules(_kind(kind), multi_pod) == \
        j_sh.logical_rules(kind, multi_pod)
    for batch in (1, 15, 16, 128):
        assert t_sh.kv_seq_axes(batch, multi_pod) == \
            j_sh.kv_seq_axes(batch, multi_pod)
        assert _port(t_sh.kv_cache_spec(batch, multi_pod)) == \
            _ref(j_sh.kv_cache_spec(batch, multi_pod))


def _smoke_state(arch_id):
    """The reference's SMOKE parameters and optimizer state of ``arch_id``
    (shapes only), and the same trees with numpy leaves."""
    arch = get_arch(arch_id)
    cfg, key = arch.SMOKE, jax.random.PRNGKey(0)
    if arch.KIND in (JKind.LM_DENSE, JKind.LM_MOE):
        params = jax.eval_shape(lambda: j_tf.init(key, cfg))
        opt = j_opt.adamw(lr=3e-4)
    elif arch.KIND == JKind.RECSYS:
        params = jax.eval_shape(
            lambda: RECSYS_INIT[cfg.interaction](key, cfg))
        opt = j_opt.rowwise_adagrad(lr=0.01)
    else:
        params = jax.eval_shape(lambda: j_gnn.init(key, cfg))
        opt = j_opt.adamw(lr=1e-3)
    opt_state = jax.eval_shape(opt.init, params)

    def as_np(tree):
        return jax.tree.map(lambda a: np.zeros(a.shape, np.float32), tree)

    return arch.KIND, params, opt_state, as_np(params), as_np(opt_state)


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_param_and_opt_spec_trees(arch_id):
    kind, jp, jo, tp, to = _smoke_state(arch_id)
    j_specs = j_sh.param_spec_tree(kind, jp)
    t_specs = t_sh.param_spec_tree(_kind(kind), tp)
    assert _port(t_specs) == _ref(j_specs)
    with warnings.catch_warnings():
        warnings.simplefilter("error", j_sh.ShardingFallbackWarning)
        warnings.simplefilter("error", t_sh.ShardingFallbackWarning)
        j_o = j_sh.opt_spec_tree(kind, jo, j_specs, strict=True)
        t_o = t_sh.opt_spec_tree(_kind(kind), to, t_specs, strict=True)
    assert _port(t_o) == _ref(j_o)


def _spec_params(np_leaves: bool):
    z = np.zeros if np_leaves else jax.numpy.zeros
    return {"table": z((16, 8)), "mlp": {"w": z((8, 4)), "b": z((4,))}}


@pytest.mark.parametrize("case", ["mirrored", "row_acc", "diverged",
                                  "strict", "matching"])
def test_fallback_cases_match_reference(case):
    """The cases of tests/test_sharding_specs.py on both packages: the same
    specs, the same warnings with the same messages, the same errors."""
    out = {}
    for name, sh, kind, leaves in (("ref", j_sh, JKind.RECSYS, False),
                                   ("port", t_sh, TKind.RECSYS, True)):
        params = _spec_params(leaves)
        z = np.zeros if leaves else jax.numpy.zeros
        specs = sh.param_spec_tree(kind, params)
        opt = {
            "mirrored": {"m": params, "v": params, "step": z(())},
            "row_acc": {"acc": {"table": z((16,)),
                                "mlp": {"w": z((8, 4)), "b": z((4,))}}},
            "diverged": {"m": dict(params, extra=z((2, 2)))},
            "strict": {"m": dict(params, extra=z((2, 2)))},
            "matching": {"m": params, "v": params, "step": z(()), "none": {}},
        }[case]
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            try:
                got = sh.opt_spec_tree(kind, opt, specs,
                                       strict=case in ("strict", "matching"))
                err = None
            except ValueError as e:
                got, err = None, str(e)
        is_leaf = (lambda x: isinstance(x, JP)) if name == "ref" else \
            (lambda x: isinstance(x, t_sh.Spec))
        out[name] = (None if got is None else _norm(got, is_leaf), err,
                     [str(w.message) for w in rec
                      if issubclass(w.category, UserWarning)])
    assert out["port"] == out["ref"]
    if case == "diverged":
        assert "'extra'" in out["port"][2][0]
    if case == "strict":
        assert 'sub-tree "m"' in out["port"][1]


def test_unbound_layer_is_local_and_bound_needs_a_group():
    """No binding: every helper is a no-op.  A bound mesh without an
    initialised process group raises instead of running locally."""
    from repro_torch.models.embedding import EmbeddingConfig, embedding_bag

    x = torch.zeros(3, 2)
    assert logical.constrain(x, ("batch", None)) is x
    assert logical.model_axis_name() is None
    assert logical.bound_axes("kv_seq") == ()
    assert logical.resolve(("batch", None)) == (None, None)
    with pytest.raises(RuntimeError, match="initialised"):
        Mesh((1, 1), ("data", "model"), device_type="cpu")

    class _Stub:
        shape = {"data": 1, "model": 2}
        axis_names = ("data", "model")

        def axis_index(self, a):
            return 0

    cfg = EmbeddingConfig(vocab_sizes=(8,), dim=4, pooling=(2,), row_pad=8)
    ids = torch.zeros((2, 1, 2), dtype=torch.int32)
    with logical.axis_rules(_Stub(), {"model": "model"}):
        with pytest.raises(RuntimeError, match="no process group"):
            embedding_bag({"table": torch.zeros(4, 4)}, ids, cfg)


@pytest.fixture(scope="module")
def mesh_results(tmp_path_factory):
    rng = np.random.default_rng(0)
    tree = {k: torch.from_numpy(rng.standard_normal(shape, np.float32))
            for k, shape in (("a", (8, 3)), ("b", (2, 8)), ("c", (12, 2)),
                             ("d", (2, 2)))}
    out = spawn(ranks.rules_rank, 4, backend="gloo",
                init_file=tmp_path_factory.mktemp("rules") / "init",
                device="cpu", args=(tree,))
    return tree, out


def test_mesh_coordinates_and_groups(mesh_results):
    _, out = mesh_results
    for r, res in enumerate(out):
        d, m = divmod(r, 2)
        assert res["coords"] == {"data": d, "model": m}
        assert res["size"] == 4
        assert res["data_axes"] == ("data",)
        assert res["all_axes"] == ("data", "model")
        assert res["group_sizes"] == {("data",): 2, ("model",): 2,
                                      ("data", "model"): 4}
        # the sum of the member ranks of each of this rank's groups
        assert res["group_rank_sums"] == {("data",): 2.0 * m + 2,
                                          ("model",): 4.0 * d + 1,
                                          ("data", "model"): 6.0}
        assert res["shard_index"] == {"data_model": r, "model": m}
        assert res["production_mesh_raises"]  # 256 ranks, not 4


def test_local_shard_blocks(mesh_results):
    tree, out = mesh_results
    for r, res in enumerate(out):
        d, m = divmod(r, 2)
        b = res["blocks"]
        np.testing.assert_array_equal(b["a"], tree["a"][4 * m:4 * m + 4])
        np.testing.assert_array_equal(b["b"], tree["b"][:, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(b["c"], tree["c"][3 * r:3 * r + 3])
        np.testing.assert_array_equal(b["d"], tree["d"])


def test_binding_constrain_and_resolve(mesh_results):
    _, out = mesh_results
    for res in out:
        assert res["constrain_raises"]
        assert res["resolve"] == ("data", "model", None, None)
        assert res["bound_model"] == "model"
        assert res["unbound_model"] is None


def test_build_cell_decode_wiring(mesh_results):
    """The reference's launch wiring (tests/test_distributed.py:226-234):
    decode cells on a mesh flip to the flash decode and bind kv_seq; batch
    1 unbinds "batch".  The LM's weights stay replicated in this slice, so
    its tensor-parallel names are unbound; the cache specs are the rank's
    slice (SMOKE's S = 32 over the seq shards)."""
    _, out = mesh_results
    for res in out:
        c = res["cells"]["long_500k"]
        assert c["decode_impl"] == "flash"
        assert c["kv_seq"] == ("data", "model")
        assert c["batch"] is None and c["model"] is None
        assert c["cache_k"][1:3] == (1, 32 // 4) and c["token"] == (1, 1)
        c32 = res["cells"]["decode_32k"]
        assert c32["decode_impl"] == "flash"
        assert c32["kv_seq"] == ("model",)
        assert c32["batch"] == ("data",)
        assert c32["cache_k"][1:3] == (64, 32 // 2)
        assert c32["token"] == (64, 1)


def test_build_lock_serialises_processes(tmp_path):
    """Two processes taking ``_build.build_lock`` in turn never interleave
    their holds."""
    ctx = multiprocessing.get_context("spawn")
    lock, log = str(tmp_path / "build.lock"), str(tmp_path / "log")
    procs = [ctx.Process(target=ranks.lock_worker, args=(lock, log, 5))
             for _ in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    lines = open(log).read().split()
    events = list(zip(lines[0::2], lines[1::2]))
    assert len(events) == 20
    for start, end in zip(events[0::2], events[1::2]):
        assert start[0] == "start" and end[0] == "end"
        assert start[1] == end[1]
