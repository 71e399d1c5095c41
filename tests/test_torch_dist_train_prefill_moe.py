"""The LM prefill cell on a mesh, and MoE routing with dropped tokens
under data sharding, against the reference's single device.

Four gloo ranks on a (2, 2) ("data", "model") mesh
(``torch_dist_ranks.lm_prefill_moe_rank``):

- llama3.2-3b SMOKE ``prefill_32k`` (batch 4, sequence 32): each rank
  holds its block of the parameters (heads, kv_heads, FFN columns and
  vocabulary rows over "model") and its batch block; its vocabulary slice
  of the last logits and its block of the cache (its batch rows and
  kv_heads, the whole sequence) against the reference's
  ``build_cell(..., mesh=None)`` step (2e-4: attention, and the sums a
  row-parallel all-reduce reorders);
- ``moe_apply`` with 64 tokens over "data", 8 padded experts over "model"
  and a tensor-parallel shared expert at capacity_factor 0.5, where the
  reference's one-device dispatch drops tokens: the output, the aux loss
  and the gradients of the parameters (each rank's block, summed over
  "data") and of the tokens against ``jax.value_and_grad`` of the
  reference's ``moe_apply`` on all 64 tokens.  The global routing (the
  aux loss's per-expert sums over the data ranks, the capacity of all the
  tokens, dispatch positions from every rank's top-k ids) is what makes
  the dropped tokens the reference's: a rank routing its 32 tokens alone
  would drop others, which the test also shows;
- a decode cell's ``init_state`` on the mesh keeps its weights whole."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro.dist import moe as j_moe
from repro.launch import steps as j_steps
from repro.models import layers as j_layers
from repro_torch.common.convert import tree_from_numpy
from repro_torch.dist.sharding import P, Spec
from repro_torch.launch.mesh import spawn
from repro_torch.models import transformer as t_tf
from torch_dist_train_util import block, close

ATTN_TOL, SUM_TOL = 2e-4, 2e-4
CPU = torch.device("cpu")
MESH = {"data": 2, "model": 2}
MOE = dict(d_model=32, d_ff=16, n_experts=6, top_k=2, n_shared=1,
           shared_d_ff=64, capacity_factor=0.5, pad_to=4)
N_TOKENS = 64


def _prefill():
    jcell = j_steps.build_cell("llama3.2-3b", "prefill_32k", mesh=None)
    jp = jcell.init_state(jax.random.PRNGKey(3))
    params = jax.tree.map(np.asarray, jp)
    tokens = np.random.default_rng(3).integers(
        0, jcell.cfg.vocab, (4, 32)).astype(np.int32)
    out = jcell.step_fn(jp, {"tokens": jnp.asarray(tokens)})
    case = {"arch_id": "llama3.2-3b", "tokens": tokens,
            "params": t_tf.params_from_reference(params, device=CPU)}
    return case, jax.tree.map(np.asarray, out)


def _moe_loss(cfg, r):
    def loss(p, x):
        y, aux = j_moe.moe_apply(p, x, cfg)
        return (y * r).sum(-1).mean() + aux, (y, aux)
    return loss


def _moe():
    cfg = j_layers.MoEConfig(**MOE)
    jp = j_layers.init_moe(jax.random.PRNGKey(4), cfg)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((N_TOKENS, 32)).astype(np.float32)
    r = rng.standard_normal((N_TOKENS, 32)).astype(np.float32)
    (loss, (y, aux)), (gp, gx) = jax.value_and_grad(
        _moe_loss(cfg, r), argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    params = jax.tree.map(np.asarray, jp)
    case = {"cfg": MOE, "params": tree_from_numpy(params, CPU), "x": x,
            "r": r}
    ref = {"loss": float(loss), "y": np.asarray(y), "aux": float(aux),
           "grads": jax.tree.map(np.asarray, gp), "x_grad": np.asarray(gx),
           "params": params, "x": x}
    return case, ref


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("prefill_moe")
    prefill, prefill_ref = _prefill()
    moe, moe_ref = _moe()
    out = spawn(ranks.lm_prefill_moe_rank, 4, backend="gloo",
                init_file=tmp / "init", device="cpu", args=(prefill, moe))
    return {"ranks": out, "prefill": prefill_ref, "moe": moe_ref}


def test_prefill_on_mesh_matches_reference(results):
    ref = results["prefill"]
    cfg = j_steps.build_cell("llama3.2-3b", "prefill_32k", mesh=None).cfg
    for r in results["ranks"]:
        c, got = r["coords"], r["prefill"]
        assert got["logits"].shape == (2, cfg.vocab // 2)
        close(got["logits"], block(ref["logits"], P("data", "model"), MESH,
                                   c), ATTN_TOL)
        spec = P(None, "data", None, "model", None)
        for k, v in got["cache"].items():
            assert v.shape == (cfg.n_layers, 2, 32, cfg.n_kv_heads // 2,
                               cfg.head_dim)
            close(v, block(ref["cache"][k], spec, MESH, c), ATTN_TOL)
        assert got["calls"]["all_reduce"] > 0
        assert got["calls"] == results["ranks"][0]["prefill"]["calls"]


def test_decode_cell_on_mesh_keeps_whole_weights(results):
    """A decode cell's tensor-parallel names are unbound: its
    ``init_state`` on the mesh gives every rank the whole weights, which
    the prefill cell splits."""
    cfg = j_steps.build_cell("llama3.2-3b", "prefill_32k", mesh=None).cfg
    for r in results["ranks"]:
        shapes = r["decode_shapes"]
        assert shapes["wq"] == (cfg.n_layers, cfg.d_model,
                                cfg.n_heads * cfg.head_dim)
        assert shapes["wo"] == (cfg.n_layers, cfg.n_heads * cfg.head_dim,
                                cfg.d_model)


def _dropped(topk, capacity):
    _, _, slot_of = j_moe.dispatch_indices(topk, 8, capacity)
    return np.asarray(slot_of) < 0


def test_moe_drops_tokens_as_one_device_under_data_sharding(results):
    ref = results["moe"]
    cfg = j_layers.MoEConfig(**MOE)
    # the one-device dispatch drops tokens; one data rank's 32 tokens
    # routed alone would drop others
    topk, _, _ = j_layers.moe_router(ref["params"], jnp.asarray(ref["x"]), cfg)
    whole = _dropped(topk, j_moe.expert_capacity(N_TOKENS, cfg))
    assert whole.sum() > 0
    half = N_TOKENS // 2
    alone = np.concatenate([_dropped(topk[i * half:(i + 1) * half],
                                     j_moe.expert_capacity(half, cfg))
                            for i in range(2)])
    assert (alone != whole).any()
    specs = {"router": P(None, None),
             "experts": {k: Spec(("model", None, None))
                         for k in ref["grads"]["experts"]},
             "shared": {"w_gate": P(None, "model"), "w_up": P(None, "model"),
                        "w_down": P("model", None)}}
    for r in results["ranks"]:
        c, got = r["coords"], r["moe"]
        close(got["y"], block(ref["y"], P("data", None), MESH, c), SUM_TOL)
        close(got["aux"], ref["aux"], 1e-5)
        close(got["loss"], ref["loss"], 1e-5)
        close(got["x_grad"], block(ref["x_grad"], P("data", None), MESH, c),
              SUM_TOL)
        want = block(ref["grads"], specs, MESH, c)
        for name in ("router",):
            close(got["grads"][name], want[name], SUM_TOL)
        for group in ("experts", "shared"):
            for k in want[group]:
                close(got["grads"][group][k], want[group][k], SUM_TOL)


# (FULL config's kv heads, their ranks a kv head and q heads a rank on 16
# "model" ranks; a kv-head count whose split must still raise)
UNEVEN = {"llama3.2-3b": (2, 2, 3), "qwen2-7b": (4, 2, 7),
          "deepseek-67b": (2, 4, 6)}


@pytest.mark.parametrize("arch_id,what", [
    ("llama3.2-3b", "24 heads"), ("qwen2-7b", "28 heads"),
    ("deepseek-67b", "8 kv_heads")])
def test_tensor_parallel_refuses_heads_that_do_not_split(arch_id, what):
    """On the production mesh's 16 "model" ranks these FULL configs'
    heads (``what``) do not split evenly: each kv head is replicated on
    the ranks that share it and its q heads padded to a multiple of them
    (``HeadSplit``).  A kv-head count that neither splits over nor
    divides the ranks still raises, naming the config."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.dist import logical
    from repro_torch.dist.sharding import logical_rules
    from repro_torch.models import transformer as tf
    from torch_dist_train_util import RankMesh

    arch = get_arch(arch_id)
    share, q_local, bad_kv = UNEVEN[arch_id]
    mesh = RankMesh({"data": 16, "model": 16}, {"data": 0, "model": 0})
    with logical.axis_rules(mesh, logical_rules(arch.KIND)):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(logical, "group", lambda axes: None)
            _, split, i = tf._tensor_parallel(arch.FULL)
        assert (split.share, split.q_local, i) == (share, q_local, 0)
        assert split.kv_local == 1
        bad = dataclasses.replace(arch.FULL, n_kv_heads=bad_kv,
                                  n_heads=bad_kv * 8)
        with pytest.raises(ValueError, match=f"{arch.FULL.name}: {bad_kv} "
                           "kv_heads neither split"):
            tf._tensor_parallel(bad)


def test_row_parallel_bf16_partials_round_once():
    """A bf16 row-parallel product on a mesh: each rank's partial of x @ w
    kept in float32 and rounded once after the sum is one device's bf16
    product to within its own rounding (at most one bf16 ulp, and equal at
    more elements than bf16 partials rounded on each rank and again after
    the sum); its backward is one device's, bitwise."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 5, 256)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((256, 48)).astype(
        np.float32)).to(torch.bfloat16)
    want = x @ w
    blocks = (slice(0, 128), slice(128, 256))
    once = sum(t_tf._Float32Product.apply(x[..., b], w[b])
               for b in blocks).to(torch.bfloat16)
    twice = sum(x[..., b] @ w[b] for b in blocks)
    assert once.dtype == torch.bfloat16
    ulp = torch.ldexp(torch.ones_like(want.float()),
                      torch.frexp(want.float()).exponent - 8)
    assert bool(((once.float() - want.float()).abs() <= ulp).all())
    assert int((once != want).sum()) < int((twice != want).sum())

    xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
    g = torch.from_numpy(rng.standard_normal((3, 5, 48)).astype(
        np.float32)).to(torch.bfloat16)
    t_tf._Float32Product.apply(xs, ws).to(torch.bfloat16).backward(g)
    x1, w1 = x.clone().requires_grad_(), w.clone().requires_grad_()
    (x1 @ w1).backward(g)
    assert xs.grad.dtype == torch.bfloat16 and ws.grad.dtype == torch.bfloat16
    assert torch.equal(xs.grad, x1.grad) and torch.equal(ws.grad, w1.grad)
