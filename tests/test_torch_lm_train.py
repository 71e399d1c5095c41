"""The port's LM training path against the reference: ``dist.loss``
(``ce_loss``, ``cast_grad``), ``data.lm.TokenStream``, ``transformer.
lm_loss`` with its gradients for the SMOKE config of all five LM archs
(two of them MoE: the aux loss and the routing's gradient), the remat
and the train-safe chunked attention, and ``launch.steps``' ``train_4k``
cell against the reference's ``build_cell(..., mesh=None)`` step.

Tolerances (ROADMAP): f32 1e-5, 2e-4 for attention and its gradients,
the optimizer state 1e-6, each scaled by the largest value compared;
``TokenStream`` and the remat bitwise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as j_get_arch
from repro.data.lm import TokenStream as JTokenStream
from repro.dist import loss as j_loss
from repro.launch.steps import build_cell as j_build_cell
from repro.models import transformer as j_tf
from repro.train import optimizer as j_opt
from repro_torch.common.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.configs.registry import get_arch
from repro_torch.data.lm import TokenStream
from repro_torch.dist import loss as t_loss
from repro_torch.launch.steps import build_cell
from repro_torch.models import transformer as t_tf

CPU = torch.device("cpu")
TOL = 1e-5
ATTN_TOL = 2e-4
OPT_TOL = 1e-6
LM_ARCHS = ("qwen2-7b", "llama3.2-3b", "deepseek-67b", "qwen2-moe-a2.7b",
            "olmoe-1b-7b")
# the reference's init, loss and gradients, and forward, compiled once a
# config (eager, its op-by-op dispatch takes seconds a call)
j_init = jax.jit(j_tf.init, static_argnums=1)
j_value_and_grad = jax.jit(jax.value_and_grad(j_tf.lm_loss),
                           static_argnums=2)
j_forward = jax.jit(j_tf.forward, static_argnums=2)


def _close(got, want, tol=TOL, mask=None):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    if mask is not None:
        got, want = got[mask], want[mask]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _trainable(jparams):
    """Reference parameters as the port's, each leaf requiring grad."""
    params = t_tf.params_from_reference(jax.tree.map(np.asarray, jparams),
                                        device=CPU)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    return params


def _value_and_grad(params, tokens, cfg):
    loss = t_tf.lm_loss(params, {"tokens": torch.from_numpy(tokens)}, cfg)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    return loss.detach(), tree_unflatten(params, grads)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ce_loss_and_cast_grad_match_reference(dtype):
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 5, 40)) * 4).astype(np.float32)
    targets = rng.integers(0, 40, (3, 5), dtype=np.int32)
    jx = jnp.asarray(logits, jdt)

    def jfn(x):
        return j_loss.ce_loss(j_loss.cast_grad(x), jnp.asarray(targets))

    jl, jg = jax.value_and_grad(jfn)(jx)
    x = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        {"f32": torch.float32, "bf16": torch.bfloat16}[dtype])
    x.requires_grad_(True)
    loss = t_loss.ce_loss(t_loss.cast_grad(x), torch.from_numpy(targets))
    (g,) = torch.autograd.grad(loss, x)
    assert loss.dtype == torch.float32
    assert g.dtype == x.dtype          # the gradient reaching bf16 is bf16
    _close(loss, jl)
    _close(g, jg.astype(jnp.float32), TOL if dtype == "f32" else 3e-2)


def test_token_stream_bitwise():
    for seed in (0, 7):
        j, t = JTokenStream(512, seed=seed), TokenStream(512, seed=seed)
        for shape in ((4, 32), (2, 50)):
            np.testing.assert_array_equal(t.batch(*shape)["tokens"],
                                          j.batch(*shape)["tokens"])


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_lm_loss_and_grads_match_reference(arch_id):
    jcfg, tcfg = j_get_arch(arch_id).SMOKE, get_arch(arch_id).SMOKE
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tokens = TokenStream(jcfg.vocab, seed=1).batch(2, 24)["tokens"]
    jl, jg = j_value_and_grad(jp, {"tokens": jnp.asarray(tokens)}, jcfg)
    loss, grads = _value_and_grad(_trainable(jp), tokens, tcfg)
    _close(loss, jl)
    tree_map(_close, grads, jax.tree.map(np.asarray, jg))
    if tcfg.moe is not None:           # the aux loss is in the loss
        with torch.no_grad():
            _, _, aux = t_tf.forward(_trainable(jp), torch.from_numpy(tokens),
                                     tcfg)
        _, _, jaux = j_forward(jp, jnp.asarray(tokens), jcfg)
        assert float(aux) > 0
        _close(aux, jaux)


@pytest.mark.parametrize("arch_id", ["llama3.2-3b", "olmoe-1b-7b"])
def test_lm_loss_chunked_attention_matches_reference(arch_id):
    """The train path through the out-of-place chunked attention (SMOKE
    with attn_impl "chunked", 3 chunks) against the reference's scan."""
    kw = dict(attn_impl="chunked", attn_chunk=8)
    jcfg = dataclasses.replace(j_get_arch(arch_id).SMOKE, **kw)
    tcfg = dataclasses.replace(get_arch(arch_id).SMOKE, **kw)
    jp = j_init(jax.random.PRNGKey(2), jcfg)
    tokens = TokenStream(jcfg.vocab, seed=3).batch(2, 24)["tokens"]
    jl, jg = j_value_and_grad(jp, {"tokens": jnp.asarray(tokens)}, jcfg)
    loss, grads = _value_and_grad(_trainable(jp), tokens, tcfg)
    _close(loss, jl)
    tree_map(lambda g, w: _close(g, w, ATTN_TOL), grads,
             jax.tree.map(np.asarray, jg))


@pytest.mark.parametrize("arch_id", ["llama3.2-3b", "qwen2-moe-a2.7b"])
def test_remat_bitwise(arch_id):
    """Each block under torch.utils.checkpoint gives the loss and every
    gradient bitwise those of the plain backward."""
    jcfg = j_get_arch(arch_id).SMOKE
    jp = j_init(jax.random.PRNGKey(4), jcfg)
    tokens = TokenStream(jcfg.vocab, seed=5).batch(2, 16)["tokens"]
    outs = [_value_and_grad(_trainable(jp), tokens, dataclasses.replace(
        get_arch(arch_id).SMOKE, attn_impl="chunked", attn_chunk=4,
        remat=remat)) for remat in (True, False)]
    assert get_arch(arch_id).SMOKE.remat
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(tree_leaves(outs[0][1]), tree_leaves(outs[1][1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("q_offset", [0, 5])
def test_chunked_attention_gradients_match_attention(q_offset):
    """The train-safe ``_attention_chunked`` (grad on) against
    ``_attention``: outputs and the gradients of q, k and v, f32; the
    in-place form (grad off) gives the out-of-place form's output
    bitwise."""
    rng = np.random.default_rng(6)
    B, Tq, Tk, H, KVH, hd = 2, 12, 12 + q_offset, 6, 2, 16
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, Tq, H, hd), (B, Tk, KVH, hd), (B, Tk, KVH, hd)))
    w = torch.from_numpy(rng.standard_normal((B, Tq, H, hd)).astype(
        np.float32))
    results = []
    for fn in (t_tf._attention_chunked, t_tf._attention):
        qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*qkv, q_offset=q_offset, chunk=4 if q_offset == 0 else 17)
        grads = torch.autograd.grad((out * w).sum(), qkv)
        results.append((out.detach(), grads))
    (out, grads), (want, want_grads) = results
    _close(out, want.numpy(), ATTN_TOL)
    for g, wg in zip(grads, want_grads):
        _close(g, wg.numpy(), ATTN_TOL)
    with torch.no_grad():
        in_place = t_tf._attention_chunked(q, k, v, q_offset=q_offset,
                                           chunk=4 if q_offset == 0 else 17)
    assert torch.equal(in_place, out)


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_lm_train_cell_matches_reference(arch_id):
    """One step of ``build_cell(arch, "train_4k", "cpu")`` against the
    reference's smoke cell from the same parameters and batch: the loss
    (1e-5; the gradients of this loss are held above); m and v (the
    optimizer state, 1e-6) against the reference's adamw(3e-4) fed the
    port's gradients, since the state inherits the gradients' rounding (v
    is g²: twice its relative error); the parameters after the step
    against the reference's step (where |g| is not tiny: a first Adam step
    moves a parameter by about lr x sign(g)); the step count."""
    jcell = j_build_cell(arch_id, "train_4k", mesh=None)
    tcell = build_cell(arch_id, "train_4k", device="cpu")
    assert (tcell.batch, tcell.seq_len) == (4, 32)
    assert tcell.cfg == get_arch(arch_id).SMOKE
    assert tuple(tcell.batch_specs["tokens"].shape) == \
        tuple(jcell.batch_specs["tokens"].shape)
    jopt = j_opt.adamw(lr=3e-4)
    jp = j_init(jax.random.PRNGKey(0), jcell.cfg)   # the cell's init_state
    jparams = jax.tree.map(np.asarray, jp)
    params = _trainable(jparams)
    state = {"params": params, "opt": tcell.opt.init(params)}
    tokens = TokenStream(tcell.cfg.vocab, seed=8).batch(4, 32)["tokens"]
    jnew, jout = jcell.run({"params": jp, "opt": jopt.init(jp)},
                           {"tokens": jnp.asarray(tokens)})
    jnew = jax.tree.map(np.asarray, jnew)

    batch = {"tokens": torch.from_numpy(tokens)}
    loss, grads = tcell.value_and_grad(state, batch)
    _close(loss, jout["loss"])
    grads = tree_map(lambda g: g.numpy(), grads)
    _, want_opt = jopt.update(jparams, grads, jopt.init(jparams))
    state, out = tcell.run(state, batch)
    assert float(out["loss"]) == float(loss)
    assert state["params"] is params       # updated in place
    assert int(state["opt"]["step"]) == int(jnew["opt"]["step"]) == 1
    for key in ("m", "v"):
        tree_map(lambda a, b: _close(a, b, OPT_TOL), state["opt"][key],
                 jax.tree.map(np.asarray, want_opt[key]))

    def param(p, want, g, p0):
        assert not torch.equal(p, torch.from_numpy(p0)) or not g.any()
        _close(p, want, mask=np.abs(g) > 1e-3 * np.abs(g).max())
    tree_map(param, state["params"], jnew["params"], grads, jparams)
