"""The LM's residual stream sharded by sequence over "model"
(``LMConfig.seq_shard``, Megatron-style sequence parallelism), on gloo
ranks (``torch_dist_ranks.seq_shard_rank``; one spawn of 4 ranks):

- ``collectives.reduce_scatter`` and ``collectives.gather`` under
  autograd over 2 ranks (the "model" group of (data 2, model 2)) and 4
  (the world), along each dimension of a rank-3 f32 tensor: outputs and
  input gradients bitwise a one-process computation (sums in group-rank
  order), and each counted once forward and once, as the other,
  backward, a reduce-scatter at its operand's bytes;
- the ``train_4k`` cell with ``seq_shard`` on (data 2, model 2) for
  llama3.2-3b (GQA, tied embedding), qwen2-7b (qkv bias), olmoe-1b-7b
  (experts over "model") and qwen2-moe-a2.7b (tensor-parallel shared
  expert), and on (data 1, model 4) for the uneven head split of
  ``test_torch_dist_uneven.py``'s "pad" case (6 heads, 2 kv heads):
  against the reference's jitted one-device ``value_and_grad(lm_loss)``
  with ``seq_shard=True`` and ``mesh=None`` (its constraints then
  no-ops), the loss and each rank's gradient blocks at 2e-4 x the leaf's
  largest entry, and m and v at 1e-6 against the reference's ``adamw``
  fed the port's gradient blocks (elementwise, so blockwise); and
  against the port's own step without ``seq_shard``: on 2 "model" ranks
  every leaf sharded over "model" bitwise, on 4 (whose sums take other
  orders) and for the leaves replicated over "model" (norms, router),
  whose block shares are summed in another order, at 1e-6;
- the planted fault: the same cell with "model" left out of its
  gradient axes (the norms' sum over "model" left out) fails the
  reference check on the norms;
- prefill_32k's last logits and cache and a decode_32k step (one token:
  the all-reduce form) with ``seq_shard`` against the same cells
  without;
- a length that does not split over the "model" ranks (31 tokens over
  2) keeps the all-reduce form: no reduce-scatter or gather, and the
  loss and raw gradients bitwise those without ``seq_shard``;
- the dry run of deepseek-67b train_4k with and without ``seq_shard`` on
  the 256- and 512-rank fake worlds: equal arguments, the peak falling
  by 15/16 of the block inputs the remat checkpoints keep within 10%
  (with ``seq_shard`` the peak moves to the end of the gradient pass,
  where each layer's gradient blocks outweigh its saved 1/16 input, so
  the fall is not exactly 15/16), under 80 GB a rank, and the same wire
  bytes.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import torch_dist_ranks as ranks
from repro.configs.registry import get_arch as j_get_arch
from repro.models import transformer as j_tf
from repro.train import optimizer as j_opt
from repro_torch.common.tree import tree_map
from repro_torch.configs.registry import get_arch
from repro_torch.dist.sharding import HeadSplit, param_spec_tree
from repro_torch.launch.mesh import spawn
from repro_torch.models import transformer as t_tf
from torch_dist_train_util import block, close

TOL, OPT_TOL, FORM_TOL = 2e-4, 1e-6, 1e-6
CPU = __import__("torch").device("cpu")
MESH = {"data": 2, "model": 2}
WIDE = {"data": 1, "model": 4}
ARCHS = ("llama3.2-3b", "qwen2-7b", "olmoe-1b-7b", "qwen2-moe-a2.7b")
UNEVEN = {"uneven_pad": ("llama3.2-3b", {"n_heads": 6, "n_kv_heads": 2})}
NAMES = ARCHS + tuple(UNEVEN)
DENSE = ("llama3.2-3b", "qwen2-7b", "uneven_pad")
COLL_SHAPE = (4, 8, 12)   # every dimension splits over 2 and 4 ranks
UNSPLIT_SEQ = 31          # does not split over the 2 "model" ranks
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
j_value_and_grad = jax.jit(jax.value_and_grad(j_tf.lm_loss), static_argnums=2)

DRYRUN = """
import dataclasses, json, sys
from repro_torch.configs.registry import get_arch
from repro_torch.launch import dryrun
from repro_torch.launch.steps import build_cell
out = {}
for mesh in ("single", "multi"):
    for seq in (False, True):
        cfg = dataclasses.replace(get_arch("deepseek-67b").FULL,
                                  seq_shard=seq)
        rec = dryrun.run_cell_dryrun("deepseek-67b", "train_4k", mesh,
                                     save=False, verbose=False,
                                     cfg_override=cfg)
        cell = build_cell("deepseek-67b", "train_4k", "meta",
                          mesh=dryrun.make_mesh(mesh),
                          multi_pod=mesh == "multi", cfg_override=cfg)
        out[f"{mesh}|{seq}"] = {
            "memory": rec["memory"], "collectives": rec["collectives"],
            "wire": rec["collective_bytes_per_device"],
            "tokens": list(cell.batch_specs["tokens"].shape),
            "layers": cfg.n_layers, "d_model": cfg.d_model}
print(json.dumps(out))
"""


def _reference(arch_id: str, overrides: dict, seed: int, seq: int = 32):
    cfg = dataclasses.replace(j_get_arch(arch_id).SMOKE, seq_shard=True,
                              **overrides)
    jp = jax.jit(j_tf.init, static_argnums=1)(jax.random.PRNGKey(seed), cfg)
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab, (4, seq)).astype(np.int32)
    loss, grads = j_value_and_grad(jp, {"tokens": tokens}, cfg)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return {"params": np_tree(jp), "tokens": tokens, "loss": float(loss),
            "grads": np_tree(grads), "head_dim": cfg.head_dim}


def _coll_arrays(seed: int = 5) -> dict:
    rng = np.random.default_rng(seed)
    return {f"{op}_{k}": rng.standard_normal((4, *COLL_SHAPE)
                                             ).astype(np.float32)
            for op in ("reduce_scatter", "gather") for k in ("x", "c")}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq_shard")
    dry = subprocess.Popen(
        [sys.executable, "-c", DRYRUN], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")))
    refs = {a: _reference(a, {}, 20 + i) for i, a in enumerate(ARCHS)}
    for name, (arch, over) in UNEVEN.items():
        refs[name] = _reference(arch, over, 30)
    unsplit = _reference("llama3.2-3b", {}, 40, seq=UNSPLIT_SEQ)

    def case(name):
        arch, over = UNEVEN.get(name, (name, {}))
        return {"arch_id": arch, "overrides": over,
                "params": t_tf.params_from_reference(refs[name]["params"],
                                                     device=CPU),
                "tokens": refs[name]["tokens"]}

    coll = _coll_arrays()
    out = spawn(ranks.seq_shard_rank, 4, backend="gloo",
                init_file=tmp / "init", device="cpu",
                args=(coll, {a: case(a) for a in ARCHS},
                      {"arch_id": "llama3.2-3b",
                       "params": case("llama3.2-3b")["params"],
                       "tokens": refs["llama3.2-3b"]["tokens"]},
                      {"arch_id": "llama3.2-3b",
                       "params": t_tf.params_from_reference(
                           unsplit["params"], device=CPU),
                       "tokens": unsplit["tokens"]},
                      {n: case(n) for n in UNEVEN}))
    stdout, stderr = dry.communicate(timeout=600)
    assert dry.returncode == 0, stderr[-4000:]
    return {"refs": refs, "ranks": out, "coll": coll,
            "dryrun": json.loads(stdout.strip().splitlines()[-1])}


# ---------------------------------------------------------------------------
# the two collectives
# ---------------------------------------------------------------------------


def _block(a, dim: int, i: int, n: int):
    size = a.shape[dim] // n
    return np.take(a, range(i * size, (i + 1) * size), axis=dim)


def _sum(arrays):
    out = arrays[0].copy()
    for a in arrays[1:]:   # group-rank order, as the port sums
        out = out + a
    return out


@pytest.mark.parametrize("op", ["reduce_scatter", "gather"])
@pytest.mark.parametrize("dim", [0, 1, 2])
@pytest.mark.parametrize("n", [2, 4])
def test_collective_matches_one_process(results, n, dim, op):
    arrays = results["coll"]
    for rank, r in enumerate(results["ranks"]):
        res = r["coll"][(n, dim, op)]
        members = res["members"]
        assert rank in members and len(members) == n
        g = members.index(rank)
        if op == "reduce_scatter":
            y = _block(_sum([arrays["reduce_scatter_x"][s] for s in members]),
                       dim, g, n)
            grad = np.concatenate(
                [_block(arrays["reduce_scatter_c"][s], dim, j, n)
                 for j, s in enumerate(members)], axis=dim)
            whole = y.size * n * 4
            assert res["fwd_calls"]["reduce_scatter"] == 1
            assert res["fwd_bytes"]["reduce_scatter"] == whole  # operand's
            other = "gather"
        else:
            y = np.concatenate([_block(arrays["gather_x"][s], dim, 0, n)
                                for s in members], axis=dim)
            grad = _block(_sum([arrays["gather_c"][s] for s in members]),
                          dim, g, n)
            whole = y.size * 4
            assert res["fwd_calls"]["gather"] == 1
            assert res["fwd_bytes"]["gather"] == whole  # result's
            other = "reduce_scatter"
        np.testing.assert_array_equal(res["y"], y)
        np.testing.assert_array_equal(res["grad"], grad)
        # the backward is the other operation, counted under its own key
        assert res["fwd_calls"][other] == 0
        assert res["calls"][other] == 1 and res["nbytes"][other] == whole
        assert res["calls"]["all_reduce"] == res["calls"]["all_gather"] == 0


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _cases(results, name, seq=True):
    if name in UNEVEN:
        return WIDE, [(r["wide_coords"], r["uneven"][name][seq])
                      for r in results["ranks"]]
    return MESH, [(r["coords"], r["train"][name][seq])
                  for r in results["ranks"]]


def _heads(results, name, mesh):
    if name not in UNEVEN:
        return None
    _, over = UNEVEN[name]
    split = HeadSplit.of(name, over["n_heads"], over["n_kv_heads"],
                         mesh["model"])
    return split, results["refs"][name]["head_dim"]


def _specs(name, ref):
    arch = UNEVEN.get(name, (name,))[0]
    return param_spec_tree(get_arch(arch).KIND, ref["params"])


def _norm_leaves(tree) -> list:
    """The leaves replicated over "model" (their paths' last keys)."""
    return [tree["blocks"]["ln1"]["scale"], tree["blocks"]["ln2"]["scale"],
            tree["final_norm"]["scale"]]


@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_reference(results, name):
    ref = results["refs"][name]
    mesh, cases = _cases(results, name)
    specs, heads = _specs(name, ref), _heads(results, name, mesh)
    opt = j_opt.adamw(lr=3e-4)
    for coords, case in cases:
        close(case["loss"], ref["loss"], TOL)
        assert case["step_loss"] == case["loss"]
        tree_map(lambda g, w: close(g, w, TOL), case["grads"],
                 block(ref["grads"], specs, mesh, coords, heads=heads))
        # m and v: the reference's adamw fed this rank's gradient blocks
        _, want = opt.update(case["params"], case["grads"],
                             opt.init(case["params"]))
        for key in ("m", "v"):
            tree_map(lambda g, w: close(g, w, OPT_TOL), case["opt"][key],
                     jax.tree.map(np.asarray, want[key]))


@pytest.mark.parametrize("name", NAMES)
def test_seq_shard_against_all_reduce_form(results, name):
    """The port's step without seq_shard on the same mesh: over 2 "model"
    ranks a two-term f32 sum of the same partials, whatever the order, so
    every leaf sharded over "model" is bitwise; over 4 the all-reduce and
    the reduce-scatter add their four terms in other orders (1e-6), and a
    replicated leaf sums its block shares in another order anyway."""
    mesh, seq = _cases(results, name)
    _, plain = _cases(results, name, seq=False)
    specs = _specs(name, results["refs"][name])

    def same(g, w, spec):
        if "model" in spec and mesh["model"] == 2:
            np.testing.assert_array_equal(g, w)
        else:
            close(g, w, FORM_TOL)

    for (_, a), (_, b) in zip(seq, plain):
        close(a["loss"], b["loss"], FORM_TOL)
        tree_map(same, a["grads"], b["grads"], specs)


@pytest.mark.parametrize("name", NAMES)
def test_norm_sum_left_out_fails(results, name):
    """The planted fault: without the sum over "model" the norms hold one
    block's share of their gradient, which the reference check refuses;
    every leaf sharded over "model" is unaffected."""
    ref = results["refs"][name]
    mesh, cases = _cases(results, name)
    specs, heads = _specs(name, ref), _heads(results, name, mesh)
    for coords, case in cases:
        want = block(ref["grads"], specs, mesh, coords, heads=heads)
        for g, w in zip(_norm_leaves(case["fault_grads"]),
                        _norm_leaves(want)):
            with pytest.raises(AssertionError):
                close(g, w, TOL)
        tree_map(lambda g, w, spec: close(g, w, TOL) if "model" in spec
                 else None, case["fault_grads"], want, specs)


@pytest.mark.parametrize("name", NAMES)
def test_binding_and_collectives(results, name):
    """build_cell binds "residual_seq" to "model" exactly when seq_shard
    is set, and sums gradients over "model" then; every rank takes the
    same collectives; the reduce-scatters and gathers replace the
    residual path's all-reduces (a dense layer's: 2 forward, 1 in the
    remat's recompute, which stops before the block's last product, and 2
    backward, for 2 gathers and 2 reduce-scatters forward, 2 and 1 in
    the recompute, 2 and 2 backward)."""
    mesh, seq = _cases(results, name)
    _, plain = _cases(results, name, seq=False)
    dp = ("data",)
    for (_, a), (_, b) in zip(seq, plain):
        assert a["rules"]["residual_seq"] == "model"
        assert b["rules"]["residual_seq"] is None
        assert a["grad_axes"] == dp + ("model",) and b["grad_axes"] == dp
        assert a["calls"] == seq[0][1]["calls"]
        assert a["calls"]["reduce_scatter"] > 0 and a["calls"]["gather"] > 0
        assert b["calls"]["reduce_scatter"] == b["calls"]["gather"] == 0
        assert a["calls"]["all_reduce"] < b["calls"]["all_reduce"]
        if name in DENSE:
            L = 2  # SMOKE's layers; and the embedding and the head
            assert a["calls"]["gather"] == 6 * L + 2
            assert a["calls"]["reduce_scatter"] == 5 * L + 2


# ---------------------------------------------------------------------------
# prefill, decode and a length that does not split
# ---------------------------------------------------------------------------


def test_prefill_and_decode_under_seq_shard(results):
    """prefill_32k runs sequence-parallel and gives the same last logits
    and cache as without seq_shard; decode_32k's one token keeps the
    all-reduce form, bitwise."""
    for r in results["ranks"]:
        a, b = r["infer"][True], r["infer"][False]
        assert a["rules"][0]["residual_seq"] == a["rules"][1][
            "residual_seq"] == "model"
        close(a["prefill_logits"], b["prefill_logits"], FORM_TOL)
        for k in b["prefill_cache"]:
            close(a["prefill_cache"][k], b["prefill_cache"][k], FORM_TOL)
        assert a["prefill_calls"]["reduce_scatter"] > 0
        assert a["prefill_calls"]["gather"] > 0
        assert b["prefill_calls"]["reduce_scatter"] == 0
        np.testing.assert_array_equal(a["decode_logits"], b["decode_logits"])
        for k in b["decode_cache"]:
            np.testing.assert_array_equal(a["decode_cache"][k],
                                          b["decode_cache"][k])
        assert a["decode_calls"] == b["decode_calls"]
        assert a["decode_calls"]["reduce_scatter"] == 0
        assert a["decode_calls"]["gather"] == 0


def test_length_that_does_not_split(results):
    for r in results["ranks"]:
        a, b = r["unsplit"][True], r["unsplit"][False]
        assert not a["split"] and a["split_cell"] and not b["split_cell"]
        assert a["loss"] == b["loss"]
        for g, w in zip(a["grads"], b["grads"]):
            np.testing.assert_array_equal(g, w)
        assert a["calls"] == b["calls"]
        assert a["calls"]["reduce_scatter"] == a["calls"]["gather"] == 0


# ---------------------------------------------------------------------------
# the dry run of deepseek-67b train_4k
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_dryrun_deepseek_train_4k(results, mesh):
    dry = results["dryrun"]
    a, b = dry[f"{mesh}|True"], dry[f"{mesh}|False"]
    assert a["memory"]["argument_size_bytes"] == \
        b["memory"]["argument_size_bytes"]
    batch, seq = a["tokens"]
    saved = a["layers"] * batch * seq * a["d_model"] * 2   # bf16 inputs
    fall = b["memory"]["peak_memory_bytes"] - a["memory"]["peak_memory_bytes"]
    assert abs(fall - saved * 15 / 16) <= 0.10 * saved * 15 / 16, fall / 1e9
    assert a["memory"]["peak_memory_bytes"] < 80e9
    assert b["memory"]["peak_memory_bytes"] > 80e9
    # a layer's 5 all-reduces of 2 x the f32 partial (forward, recompute)
    # or bf16 cotangent (backward) against 6 bf16 gathers and 5
    # reduce-scatters of f32 partials or bf16 cotangents: equal bytes
    assert a["wire"] == b["wire"]
    c = a["collectives"]
    assert c["reduce-scatter_count"] > 0 and c["gather_count"] > 0
    assert c["all-reduce_count"] < b["collectives"]["all-reduce_count"]
