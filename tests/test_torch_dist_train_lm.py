"""The LM train cells on a mesh: tensor and expert parallelism with the
vocab-parallel loss, against the reference's single-device step.

``build_cell(arch, "train_4k", "cpu", mesh=...)`` on gloo ranks
(``torch_dist_ranks.train_cells_rank``), each rank holding its block of
the parameters by ``param_spec_tree`` and of the tokens over the data
axes, from the reference's parameters:

- on (2, 2) ("data", "model"): llama3.2-3b (GQA, tied embedding),
  qwen2-7b (qkv bias), olmoe-1b-7b (experts over "model", the router's
  global aux loss over "data") and qwen2-moe-a2.7b (a tensor-parallel
  shared expert);
- on (2, 2, 2) ("pod", "data", "model"): olmoe-1b-7b with 2 layers at
  batch 16, mirroring the reference's
  ``test_multipod_lm_train_step_matches_local`` (which fails under jax
  0.9.0), including its assertion that the optimizer's moments mirror the
  parameter specs leaf for leaf.

The oracle is the reference's jitted ``value_and_grad(lm_loss)`` on the
whole batch with ``mesh=None`` and its ``adamw(3e-4)``: the loss, each
rank's block of every gradient leaf (2e-4: attention and the sums a
row-parallel ``all_reduce`` reorders), m and v (1e-6) against the
reference's update fed the port's gradients reassembled from the ranks'
blocks, and the parameters after the step against the reference's step
where |g| is not tiny (2e-4: a first Adam step moves a parameter by lr x
g / (|g| + eps), which inherits the gradient's error where |g| nears
eps).  Each tolerance is scaled by the largest value compared."""
import jax
import numpy as np
import pytest

import torch_dist_ranks as ranks
from repro.configs.registry import get_arch as j_get_arch
from repro.models import transformer as j_tf
from repro.train import optimizer as j_opt
from repro_torch.common.tree import tree_map
from repro_torch.launch.mesh import spawn
from repro_torch.models import transformer as t_tf
from torch_dist_train_util import assemble, block, close

ATTN_TOL, OPT_TOL = 2e-4, 1e-6
CPU = __import__("torch").device("cpu")
MESH = {"data": 2, "model": 2}
POD_MESH = {"pod": 2, "data": 2, "model": 2}
ARCHS = ("llama3.2-3b", "qwen2-7b", "olmoe-1b-7b", "qwen2-moe-a2.7b")
j_value_and_grad = jax.jit(jax.value_and_grad(j_tf.lm_loss), static_argnums=2)


def _reference(arch_id: str, batch: int, seed: int):
    cfg = j_get_arch(arch_id).SMOKE
    jp = jax.jit(j_tf.init, static_argnums=1)(jax.random.PRNGKey(seed), cfg)
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, 32)).astype(np.int32)
    loss, grads = j_value_and_grad(jp, {"tokens": tokens}, cfg)
    opt = j_opt.adamw(lr=3e-4)
    new, _ = opt.update(jp, grads, opt.init(jp))
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return {"params": np_tree(jp), "tokens": tokens, "loss": float(loss),
            "grads": np_tree(grads), "new": np_tree(new)}


def _case(arch_id, ref, batch):
    return {"arch_id": arch_id, "shape": "train_4k",
            "params": t_tf.params_from_reference(ref["params"], device=CPU),
            "batch": {"tokens": ref["tokens"]}, "batch_size": batch}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_train")
    refs = {a: _reference(a, 4, i) for i, a in enumerate(ARCHS)}
    pod_ref = _reference("olmoe-1b-7b", 16, 7)
    out = spawn(ranks.train_cells_rank, 4, backend="gloo",
                init_file=tmp / "init", device="cpu",
                args=({a: _case(a, refs[a], 4) for a in ARCHS},))
    pod = spawn(ranks.train_cells_rank, 8, backend="gloo",
                init_file=tmp / "init-pod", device="cpu",
                args=({"olmoe": _case("olmoe-1b-7b", pod_ref, 16)},
                      tuple(POD_MESH.values()), tuple(POD_MESH)))
    return {"refs": refs, "ranks": out, "pod_ref": pod_ref, "pod": pod}


def _check(ranks_out, name, ref, shape):
    coords = [r["coords"] for r in ranks_out]
    cases = [r["cases"][name] for r in ranks_out]
    p_specs = cases[0]["p_specs"]
    for case, c in zip(cases, coords):
        close(case["loss"], ref["loss"], ATTN_TOL)
        assert case["step_loss"] == case["loss"]
        tree_map(lambda g, w: close(g, w, ATTN_TOL), case["grads"],
                 block(ref["grads"], p_specs, shape, c))
    # the optimizer state: the reference's adamw fed the port's gradients
    grads = assemble([c["grads"] for c in cases], p_specs, shape, coords)
    opt = j_opt.adamw(lr=3e-4)
    _, want_opt = opt.update(ref["params"], grads, opt.init(ref["params"]))
    for case, c in zip(cases, coords):
        assert int(case["opt"]["step"]) == 1
        for key in ("m", "v"):
            tree_map(lambda g, w: close(g, w, OPT_TOL), case["opt"][key],
                     block(jax.tree.map(np.asarray, want_opt[key]), p_specs,
                           shape, c))
        tree_map(lambda p, w, g: close(
            p, w, ATTN_TOL, mask=np.abs(g) > 1e-3 * np.abs(g).max()),
            case["params"], block(ref["new"], p_specs, shape, c),
            block(ref["grads"], p_specs, shape, c))
    return cases


@pytest.mark.parametrize("arch_id", ARCHS)
def test_lm_train_step_on_mesh_matches_reference(results, arch_id):
    cases = _check(results["ranks"], arch_id, results["refs"][arch_id], MESH)
    case = cases[0]
    assert case["rules"]["heads"] == case["rules"]["vocab"] == "model"
    assert case["grad_axes"] == ("data",)
    assert case["batch_shapes"]["tokens"] == (2, 32)
    # every rank holds a block of the tensor-parallel leaves: wq's columns
    # are half the heads', the embedding's rows half the vocabulary
    cfg = j_get_arch(arch_id).SMOKE
    wq = case["params"]["blocks"]["attn"]["wq"]
    assert wq.shape[-1] == cfg.n_heads * cfg.head_dim // 2
    assert case["params"]["embed"].shape[0] == cfg.vocab // 2


def test_multipod_lm_train_step_matches_reference(results):
    """olmoe-1b-7b, 2 layers, batch 16 over ("pod", "data"), experts and
    heads over "model"; the moments' specs mirror the parameters'."""
    cases = _check(results["pod"], "olmoe", results["pod_ref"], POD_MESH)
    case = cases[0]
    assert tuple(case["rules"]["batch"]) == ("pod", "data")
    assert case["grad_axes"] == ("pod", "data")
    for key in ("m", "v"):
        assert case["o_specs"][key] == case["p_specs"]
    assert case["batch_shapes"]["tokens"] == (4, 32)
    assert case["params"]["blocks"]["ffn"]["experts"]["w_gate"].shape[1] == \
        j_get_arch("olmoe-1b-7b").SMOKE.moe.n_experts_padded // 2
    assert case["calls"]["all_gather"] > 0  # the global routing's ids


def test_lm_train_cell_on_mesh_collectives(results):
    """The collectives one step takes are the same on every rank (ranks
    that issued different ones would have deadlocked or mixed tensors);
    only the MoE routing gathers."""
    for name in ARCHS:
        calls = [r["cases"][name]["calls"] for r in results["ranks"]]
        assert all(c == calls[0] for c in calls)
        assert calls[0]["all_reduce"] > 0
    for name in ("llama3.2-3b", "qwen2-7b"):
        assert results["ranks"][0]["cases"][name]["calls"]["all_gather"] == 0
    for name in ("olmoe-1b-7b", "qwen2-moe-a2.7b"):
        assert results["ranks"][0]["cases"][name]["calls"]["all_gather"] > 0
