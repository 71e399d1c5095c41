"""The port's LM against the reference's ``repro.models.transformer``
on carried-across parameters and the same numpy tokens: the LM layers,
``forward``, ``prefill`` and ``decode_step`` (with ``decode_impl="flash"``,
so the reference runs kernel K3 in interpret mode and the port its plain
version) for llama3.2-3b and the SMOKE configs of qwen2-7b, deepseek-67b,
qwen2-moe-a2.7b and olmoe-1b-7b, the configs field for field,
``_quantize_kv``, and the ``launch.steps`` LM cells against the
reference's ``build_cell(..., mesh=None)``.

Tolerances: f32 1e-4 (XLA-CPU and torch sum the products in other orders,
as in tests/test_torch_dlrm.py); bf16 3e-2 (the kernel tolerance: the
two frameworks round bf16 at other places); int8 quantization bitwise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama3_2_3b as j_llama
from repro.configs.registry import get_arch as j_get_arch
from repro.launch.steps import build_cell as j_build_cell
from repro.models import layers as j_layers
from repro.models import transformer as j_tf
from repro_torch.common.convert import tensor_from_numpy
from repro_torch.configs import llama3_2_3b as t_llama
from repro_torch.configs.registry import get_arch, list_archs
from repro_torch.launch.steps import build_cell as t_build_cell
from repro_torch.models import layers as t_layers
from repro_torch.models import transformer as t_tf

CPU = torch.device("cpu")
F32_TOL = 1e-4
BF16_TOL = 3e-2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _params(jcfg, seed=0):
    jp = j_tf.init(jax.random.PRNGKey(seed), jcfg)
    return jp, t_tf.params_from_reference(_np(jp), device=CPU)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               rtol=tol, atol=tol)


# A tiny config with FULL's features: bf16, int8 KV cache, chunked prefill
# attention, tied embeddings, group 3.
TINY_FULL = dict(name="tiny-full", n_layers=2, d_model=192, n_heads=6,
                 n_kv_heads=2, d_ff=256, vocab=512, head_dim=32,
                 rope_theta=500_000.0, tie_embeddings=True,
                 attn_impl="chunked", attn_chunk=16, kv_quant="int8",
                 decode_impl="flash")
CASES = {
    "smoke-f32": (dataclasses.replace(j_llama.SMOKE, decode_impl="flash"),
                  dataclasses.replace(t_llama.SMOKE, decode_impl="flash"),
                  F32_TOL),
    "tiny-full-bf16": (j_tf.LMConfig(**TINY_FULL, dtype=jnp.bfloat16),
                       t_tf.LMConfig(**TINY_FULL, dtype=torch.bfloat16),
                       BF16_TOL),
}
# the other LM archs' SMOKE configs (qwen2: QKV bias; the MoE two: their
# blocks' routed and shared experts), decoding through K3
NEW_ARCHS = ("qwen2-7b", "deepseek-67b", "qwen2-moe-a2.7b", "olmoe-1b-7b")
for _arch in NEW_ARCHS:
    CASES[_arch] = (
        dataclasses.replace(j_get_arch(_arch).SMOKE, decode_impl="flash"),
        dataclasses.replace(get_arch(_arch).SMOKE, decode_impl="flash"),
        F32_TOL)


def test_configs_match_reference():
    for jc, tc in ((j_llama.FULL, t_llama.FULL), (j_llama.SMOKE, t_llama.SMOKE)):
        for f in dataclasses.fields(tc):
            if f.name != "dtype":
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
    assert t_llama.FULL.param_count() == 3_212_749_824
    assert get_arch("llama3.2-3b") is t_llama
    for arch_id in list_archs():      # every reference id resolves
        assert get_arch(arch_id).ARCH_ID == arch_id
    with pytest.raises(KeyError, match="unknown"):
        get_arch("gpt-5")


@pytest.mark.parametrize("arch_id", NEW_ARCHS)
def test_new_lm_configs_match_reference(arch_id):
    """FULL and SMOKE field for field (the MoE config's too), and the
    reference's parameter counts."""
    jarch, tarch = j_get_arch(arch_id), get_arch(arch_id)
    assert (tarch.ARCH_ID, tarch.KIND.value) == (jarch.ARCH_ID,
                                                 jarch.KIND.value)
    assert [s.name for s in tarch.SHAPES] == [s.name for s in jarch.SHAPES]
    for jc, tc in ((jarch.FULL, tarch.FULL), (jarch.SMOKE, tarch.SMOKE)):
        # unroll_layers is an XLA lowering choice: the port's layer loop is
        # Python, and its dry run counts every op of every layer
        assert {f.name for f in dataclasses.fields(tc)} == \
            {f.name for f in dataclasses.fields(jc)} - {"unroll_layers"}
        for f in dataclasses.fields(tc):
            if f.name in ("dtype", "moe"):
                continue
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert (tc.moe is None) == (jc.moe is None)
        if tc.moe is not None:
            for f in dataclasses.fields(tc.moe):
                if f.name != "router_dtype":
                    assert getattr(tc.moe, f.name) == getattr(jc.moe, f.name)
        assert str(tc.dtype).split(".")[-1] == jnp.dtype(jc.dtype).name
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_layers_match_reference(dtype):
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((2, 6, 64)), jdt)
    tx = tensor_from_numpy(np.asarray(x), CPU)
    scale = jnp.asarray(rng.uniform(0.5, 1.5, 64), jdt)
    ln = {"scale": scale, "bias": jnp.asarray(rng.standard_normal(64), jdt)}
    tln = {k: tensor_from_numpy(np.asarray(v), CPU) for k, v in ln.items()}
    _close(t_layers.apply_rmsnorm(tln, tx), j_layers.apply_rmsnorm(ln, x), tol)
    _close(t_layers.apply_layernorm(tln, tx), j_layers.apply_layernorm(ln, x), tol)

    pos = np.arange(3, 9)[None, :]
    jc, js = j_layers.rope_angles(jnp.asarray(pos), 16, 500_000.0)
    tc, ts = t_layers.rope_angles(torch.from_numpy(pos), 16, 500_000.0)
    _close(tc, jc, 1e-5)
    _close(ts, js, 1e-5)
    xh = jnp.asarray(rng.standard_normal((2, 6, 4, 16)), jdt)
    _close(t_layers.apply_rope(tensor_from_numpy(np.asarray(xh), CPU), tc, ts),
           j_layers.apply_rope(xh, jc, js), tol)

    acfg = j_layers.AttentionConfig(64, 4, 2, 16, qkv_bias=True)
    tcfg = t_layers.AttentionConfig(64, 4, 2, 16, qkv_bias=True)
    jp = j_layers.init_attention(jax.random.PRNGKey(2), acfg, dtype=jdt)
    jp = {k: v + 0.1 if k.startswith("b") else v for k, v in jp.items()}
    tp = {k: tensor_from_numpy(np.asarray(v), CPU) for k, v in jp.items()}
    jq, jk, jv = j_layers.qkv_projection(jp, x, acfg)
    tq, tk, tv = t_layers.qkv_projection(tp, tx, tcfg)
    for g, w in ((tq, jq), (tk, jk), (tv, jv)):
        _close(g, w, tol)
    valid = np.array([6, 4])
    jo = j_layers.gqa_attention(jq, jk, jv, causal=True,
                                kv_valid_len=jnp.asarray(valid))
    to = t_layers.gqa_attention(tq, tk, tv, causal=True,
                                kv_valid_len=torch.from_numpy(valid))
    _close(to, jo, tol)
    _close(t_layers.attention_output(tp, to), j_layers.attention_output(jp, jo),
           tol)
    sp = j_layers.init_swiglu(jax.random.PRNGKey(3), 64, 96, dtype=jdt)
    tsp = {k: tensor_from_numpy(np.asarray(v), CPU) for k, v in sp.items()}
    _close(t_layers.apply_swiglu(tsp, tx), j_layers.apply_swiglu(sp, x), tol)

    gen = torch.Generator().manual_seed(0)
    p = t_layers.init_attention(tcfg, generator=gen, device=CPU)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_prefill_decode_match_reference(name):
    jcfg, tcfg, tol = CASES[name]
    jp, tp = _params(jcfg)
    B, T, S = 2, 32, 48
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab, (B, T + 3),
                                               dtype=np.int32)
    prompt = tokens[:, :T]

    jl, _, _ = j_tf.forward(jp, jnp.asarray(prompt), jcfg)
    with torch.inference_mode():
        tl, _, _ = t_tf.forward(tp, torch.from_numpy(prompt), tcfg)
    _close(tl, jl, tol)

    jcache = j_tf.init_kv_cache(jcfg, B, S)
    tcache = t_tf.init_kv_cache(tcfg, B, S, device=CPU)
    for k in jcache:
        assert tuple(tcache[k].shape) == jcache[k].shape
    jlast, jcache = j_tf.prefill(jp, jnp.asarray(prompt), jcache, jcfg)
    with torch.inference_mode():
        tlast, tcache = t_tf.prefill(tp, torch.from_numpy(prompt), tcache, tcfg)
    _close(tlast, jlast, tol)
    _close(tlast, jl[:, -1], tol)
    for pos in range(T, T + 3):
        tok = tokens[:, pos:pos + 1]
        jlast, jcache = j_tf.decode_step(jp, jnp.asarray(tok), jcache, pos, jcfg)
        with torch.inference_mode():
            tlast, tcache = t_tf.decode_step(tp, torch.from_numpy(tok), tcache,
                                             pos, tcfg)
        _close(tlast, jlast, tol)
    if tcfg.kv_quant == "int8":
        # the cache in value space: int8 x scale (a bf16 k that rounds one
        # ulp apart may move its int8 code by one or two)
        for k in ("k", "v"):
            _close(tcache[k].float() * tcache[k + "s"],
                   np.asarray(jcache[k], np.float32) * np.asarray(jcache[k + "s"]),
                   tol)
    else:
        for k in jcache:
            _close(tcache[k], jcache[k], tol)


def test_decode_flash_equals_naive_on_the_port():
    """decode_impl "flash" (K3's plain version on CPU) and "naive" give the
    same step on the port."""
    jcfg, tcfg, _ = CASES["smoke-f32"]
    _, tp = _params(jcfg, seed=5)
    tok = torch.from_numpy(np.random.default_rng(6).integers(
        0, tcfg.vocab, (2, 9), dtype=np.int32))
    outs = []
    for impl in ("flash", "naive"):
        cfg = dataclasses.replace(tcfg, decode_impl=impl)
        cache = t_tf.init_kv_cache(cfg, 2, 12, device=CPU)
        with torch.inference_mode():
            t_tf.prefill(tp, tok[:, :8], cache, cfg)
            outs.append(t_tf.decode_step(tp, tok[:, 8:], cache, 8, cfg)[0])
    torch.testing.assert_close(outs[0], outs[1], rtol=F32_TOL, atol=F32_TOL)


def test_decode_int8_flash_equals_eager_dequant(monkeypatch):
    """The int8 flash decode path (K3's int8 entry, its plain version on
    CPU) gives bitwise the step of the eager path it replaced: the whole
    cache dequantised in the model's dtype, then decode_attention."""
    jcfg, tcfg, _ = CASES["tiny-full-bf16"]
    _, tp = _params(jcfg, seed=8)
    tok = torch.from_numpy(np.random.default_rng(9).integers(
        0, tcfg.vocab, (2, 21), dtype=np.int32))

    def eager(q, kq, ks, vq, vs, *, kv_len):
        return t_tf.decode_attention(q, kq.to(q.dtype) * ks.to(q.dtype),
                                     vq.to(q.dtype) * vs.to(q.dtype),
                                     kv_len=kv_len)

    outs, caches = [], []
    for swap in (False, True):
        if swap:
            monkeypatch.setattr(t_tf, "decode_attention_int8", eager)
        cache = t_tf.init_kv_cache(tcfg, 2, 32, device=CPU)
        with torch.inference_mode():
            t_tf.prefill(tp, tok[:, :16], cache, tcfg)
            steps = [t_tf.decode_step(tp, tok[:, p:p + 1], cache, p, tcfg)[0]
                     for p in range(16, 21)]
        outs.append(torch.stack(steps))
        caches.append(cache)
    assert outs[0].dtype == torch.bfloat16
    assert torch.equal(outs[0], outs[1])
    for name in caches[0]:
        assert torch.equal(caches[0][name], caches[1][name])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_kv_bitwise(dtype):
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 3, 32)) * rng.uniform(0.01, 30, (2, 5, 3, 1))
    x[0, 0, 0] = 0.0                       # an all-zero row: the 1e-8 floor
    jx = jnp.asarray(x, jdt)
    jq, js = j_tf._quantize_kv(jx)
    tq, ts = t_tf._quantize_kv(tensor_from_numpy(np.asarray(jx), CPU))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_cache_write_outside_raises():
    cfg = t_llama.SMOKE
    params = t_tf.init(cfg, generator=torch.Generator().manual_seed(0),
                       device=CPU)
    cache = t_tf.init_kv_cache(cfg, 1, 4, device=CPU)
    with pytest.raises(ValueError, match="outside"):
        t_tf.decode_step(params, torch.zeros((1, 1), dtype=torch.int32),
                         cache, 4, cfg)


def test_init_shapes_match_reference():
    cfg = dataclasses.replace(t_llama.SMOKE, qkv_bias=True, tie_embeddings=False)
    jcfg = dataclasses.replace(j_llama.SMOKE, qkv_bias=True, tie_embeddings=False)
    tp = t_tf.init(cfg, generator=torch.Generator().manual_seed(0), device=CPU)
    jp = jax.eval_shape(lambda: j_tf.init(jax.random.PRNGKey(0), jcfg))
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert jax.tree.map(lambda t: tuple(t.shape), tp) == shapes
    assert sum(t.numel() for t in jax.tree.leaves(tp)) == cfg.param_count()


# ---------------------------------------------------------------------------
# launch.steps LM cells
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_lm_cells_match_reference(shape):
    jcell = j_build_cell("llama3.2-3b", shape, mesh=None)
    tcell = t_build_cell("llama3.2-3b", shape, device="cpu")
    assert (tcell.batch, tcell.seq_len) == (4, 32)
    assert tcell.cfg == t_llama.SMOKE
    jp = jcell.init_state(jax.random.PRNGKey(0))
    tp = t_tf.params_from_reference(_np(jp), device=CPU)
    rng = np.random.default_rng(8)

    def make(spec):
        if spec.dtype == jnp.int32:
            return rng.integers(0, 512, spec.shape, dtype=np.int32)
        return rng.standard_normal(spec.shape).astype(np.float32)

    batch = jax.tree.map(make, jcell.batch_specs)
    assert jax.tree.map(lambda s: tuple(s.shape), tcell.batch_specs) == \
        jax.tree.map(lambda s: tuple(s.shape), jcell.batch_specs)
    tbatch = jax.tree.map(lambda a: torch.from_numpy(a.copy()), batch)
    want = jcell.run(jp, jax.tree.map(jnp.asarray, batch))
    got = tcell.run(tp, tbatch)
    _close(got["logits"], want["logits"], F32_TOL)
    for k in want["cache"]:
        _close(got["cache"][k], want["cache"][k], F32_TOL)


def test_cell_device_and_batch():
    """Without a card the default device raises; the CPU cell honours a
    stated batch."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_build_cell("llama3.2-3b", "decode_32k")
    cell = t_build_cell("llama3.2-3b", "decode_32k", device="cpu", batch=2)
    assert cell.batch == 2 and cell.cfg.decode_impl == "naive"
    assert cell.batch_specs["cache"]["k"].shape == (2, 2, 32, 2, 32)
    # every LM shape is ported; an LM's depth cut is stated with n_layers
    train = t_build_cell("llama3.2-3b", "train_4k", device="cpu")
    assert (train.batch, train.seq_len, train.opt.name) == (
        4, 32, "adamw(lr=0.0003)")
    cut = t_build_cell("deepseek-67b", "decode_32k", device="cpu", n_layers=2)
    assert cut.cfg.n_layers == 2 and cut.batch_specs["cache"]["k"].shape[0] == 2
    with pytest.raises(ValueError, match="n_layers"):
        t_build_cell("dlrm-rm2", "serve_p99", device="cpu", n_layers=2)
    # the recsys serve and train cells are ported
    assert t_build_cell("dlrm-rm2", "serve_p99", device="cpu").batch == 16
    assert t_build_cell("dlrm-rm2", "train_batch", device="cpu").batch == 16
