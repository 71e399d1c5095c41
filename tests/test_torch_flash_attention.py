"""Kernels K2 (flash attention) and K3 (split-KV flash decode): the port's
plain versions against the reference's Pallas kernels (interpret mode on
CPU, through ``ops.flash_attention`` / ``ops.flash_decode`` /
``flash_decode_partials``) on the same numpy inputs, the port's
``lse_combine`` against the reference's and its merge properties, and the
CUDA kernels against the plain versions where a card is present.

Tolerances are those of tests/test_kernels.py: f32 2e-4 (the kernels sum
the softmax in another order than the oracle), bf16 3e-2.  The empty
decode partial is compared exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.flash_attention import flash_decode as jax_flash_decode
from repro.kernels.flash_attention.flash_decode import (
    flash_decode_partials as jax_flash_decode_partials,
)
from repro.kernels.flash_attention.flash_decode import lse_combine as jax_lse_combine
from repro_torch.common.convert import tensor_from_numpy
from repro_torch.kernels.flash_attention import (
    attention_ref,
    flash_attention,
    flash_decode,
    flash_decode_int8,
    flash_decode_partials,
    flash_decode_partials_ref,
    lse_combine,
    ops,
)
from repro_torch.kernels.flash_attention.ref import (
    dequantize_kv,
    flash_decode_int8_ref,
    flash_decode_ref,
)
from repro_torch.kernels.flash_attention.flash_decode import (
    MIN_SPLIT,
    split_plan,
)

TOL = {"f32": 2e-4, "bf16": 3e-2}
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _pair(a, dtype):
    """The same array as a jax array and a CPU tensor, both in ``dtype``."""
    j = jnp.asarray(a, JNP[dtype])
    return j, tensor_from_numpy(np.asarray(j), CPU)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

FA_CASES = [  # (Tq, H, KVH, hd, bq, bk): the tests/test_kernels.py sweep
    (128, 4, 4, 32, 64, 64),    # MHA
    (256, 8, 2, 64, 128, 128),  # GQA 4:1
    (128, 8, 1, 32, 128, 64),   # MQA
    (128, 6, 2, 32, 64, 64),    # GQA 3:1 (llama3.2-3b's group)
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("Tq,H,KVH,hd,bq,bk", FA_CASES)
def test_flash_attention_plain_matches_reference(Tq, H, KVH, hd, bq, bk, dtype):
    B = 2
    qn, kn, vn = _normal(Tq + H, (B, Tq, H, hd), (B, Tq, KVH, hd),
                         (B, Tq, KVH, hd))
    (jq, q), (jk, k), (jv, v) = (_pair(a, dtype) for a in (qn, kn, vn))
    want = jax_flash_attention(jq, jk, jv, causal=True, bq=bq, bk=bk)
    before = dict(ops.launches)
    got = flash_attention(q, k, v, causal=True, bq=bq, bk=bk)
    assert ops.launches == before  # CPU tensors never launch a kernel
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, TOL[dtype])
    _close(attention_ref(q, k, v, causal=True),
           jax_attention_ref(jq, jk, jv, causal=True), TOL[dtype])


@pytest.mark.parametrize("causal,q_offset,Tq,Tk", [
    (False, 0, 128, 128),   # tests/test_kernels.py's non-causal case
    (True, 64, 64, 128),    # queries after a 64-token cache prefix
    (True, 128, 128, 256),
])
def test_flash_attention_offset_and_noncausal(causal, q_offset, Tq, Tk):
    B, H, KVH, hd = 1, 4, 2, 16
    qn, kn, vn = _normal(q_offset + Tk, (B, Tq, H, hd), (B, Tk, KVH, hd),
                         (B, Tk, KVH, hd))
    want = jax_flash_attention(jnp.asarray(qn), jnp.asarray(kn),
                               jnp.asarray(vn), causal=causal,
                               q_offset=q_offset, bq=64, bk=64)
    got = flash_attention(torch.from_numpy(qn), torch.from_numpy(kn),
                          torch.from_numpy(vn), causal=causal,
                          q_offset=q_offset, bq=64, bk=64)
    _close(got, want, TOL["f32"])


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("S,kv_len,bk", [(512, 512, 128), (1024, 700, 256),
                                         (256, 1, 128)])
def test_flash_decode_plain_matches_reference(S, kv_len, bk, dtype):
    B, H, KVH, hd = 2, 8, 2, 32
    qn, kn, vn = _normal(S + kv_len, (B, 1, H, hd), (B, S, KVH, hd),
                         (B, S, KVH, hd))
    (jq, q), (jk, k), (jv, v) = (_pair(a, dtype) for a in (qn, kn, vn))
    want = jax_flash_decode(jq, jk, jv, kv_len=kv_len, bk=bk)
    before = dict(ops.launches)
    got = flash_decode(q, k, v, kv_len=kv_len, bk=bk)
    assert ops.launches == before
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, TOL[dtype])
    # the partials themselves, merged over the reference's chunks
    jm, jl, jo = jax_flash_decode_partials(jq, jk, jv, kv_len=kv_len, bk=bk,
                                           interpret=True)
    m, l, o = flash_decode_partials(q, k, v, kv_len=kv_len, bk=bk)
    for g, w in ((m, jm), (l, jl), (o, jo)):
        assert g.dtype == torch.float32 and g.shape == w.shape
    _close(m, jm, TOL[dtype])
    # l and o scale with exp(-m); compare them relative to their size
    _close(o / l, np.asarray(jo) / np.asarray(jl), TOL[dtype])
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=TOL["f32"])


def test_flash_decode_offset_shard_merge():
    """Per-shard slices with a GLOBAL kv_len and their base offset merge to
    the full-cache answer (the sequence-sharded decode contract)."""
    B, S, H, KVH, hd = 2, 512, 8, 2, 32
    kv_len = 300                               # ends mid-slice 2 of 4
    qn, kn, vn = _normal(3, (B, 1, H, hd), (B, S, KVH, hd), (B, S, KVH, hd))
    q, k, v = (torch.from_numpy(a) for a in (qn, kn, vn))
    parts = [flash_decode_partials(q, k[:, i:i + 128], v[:, i:i + 128],
                                   kv_len=kv_len, kv_offset=i, bk=64)
             for i in range(0, S, 128)]
    jparts = [jax_flash_decode_partials(
        jnp.asarray(qn), jnp.asarray(kn[:, i:i + 128]),
        jnp.asarray(vn[:, i:i + 128]), kv_len=kv_len, kv_offset=i, bk=64,
        interpret=True) for i in range(0, S, 128)]
    for p, jp in zip(parts, jparts):
        for g, w in zip(p, jp):
            _close(g, w, TOL["f32"])
    m, l, o = (torch.stack([p[j] for p in parts]) for j in range(3))
    _, l_c, o_c = lse_combine(m, l, o, axis=0)
    out = (o_c / l_c.clamp_min(1e-30)).reshape(B, 1, H, hd)
    _close(out, jax_attention_ref(jnp.asarray(qn), jnp.asarray(kn),
                                  jnp.asarray(vn), causal=False,
                                  kv_len=kv_len), TOL["f32"])
    full = flash_decode(q, k, v, kv_len=kv_len, bk=64)
    np.testing.assert_allclose(out.numpy(), full.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_decode_empty_slice_is_exactly_empty(dtype):
    """A slice wholly past kv_len gives l = 0, o = 0, m = -1e30 exactly, as
    the reference's kernel does."""
    B, H, KVH, hd = 1, 4, 2, 16
    qn, kn, vn = _normal(4, (B, 1, H, hd), (B, 128, KVH, hd), (B, 128, KVH, hd))
    (jq, q), (jk, k), (jv, v) = (_pair(a, dtype) for a in (qn, kn, vn))
    jm, jl, jo = jax_flash_decode_partials(jq, jk, jv, kv_len=200,
                                           kv_offset=256, bk=64,
                                           interpret=True)
    m, l, o = flash_decode_partials(q, k, v, kv_len=200, kv_offset=256, bk=64)
    assert not np.asarray(jl).any() and not np.asarray(jo).any()
    assert not l.any() and not o.any()
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    assert (m == -1e30).all()


def test_lse_combine_matches_reference():
    rng = np.random.default_rng(0)
    m = rng.normal(scale=3.0, size=(5, 3, 2, 1)).astype(np.float32)
    l = rng.uniform(0.1, 4.0, (5, 3, 2, 1)).astype(np.float32)
    o = rng.normal(size=(5, 3, 2, 8)).astype(np.float32)
    m[1], l[1], o[1] = -1e30, 0.0, 0.0        # an empty partial
    for axis in (0, 1):
        got = lse_combine(torch.from_numpy(m), torch.from_numpy(l),
                          torch.from_numpy(o), axis=axis)
        want = jax_lse_combine(jnp.asarray(m), jnp.asarray(l), jnp.asarray(o),
                               axis=axis)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("seed", range(6))
def test_lse_combine_permutation_invariant_and_associative(seed):
    """The two merge properties tests/test_lse_properties.py holds the
    reference to, on the port's merge."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 12))
    m = torch.from_numpy(rng.normal(scale=3.0, size=(n, 3, 1)).astype(np.float32))
    l = torch.from_numpy(rng.uniform(0.1, 4.0, (n, 3, 1)).astype(np.float32))
    o = torch.from_numpy(rng.normal(size=(n, 3, 8)).astype(np.float32))
    empty = rng.choice(n, size=int(rng.integers(0, n)), replace=False)
    m[empty], l[empty], o[empty] = -1e30, 0.0, 0.0

    def final(l_, o_):
        return (o_ / l_.clamp_min(1e-30)).numpy()

    _, l_f, o_f = lse_combine(m, l, o, axis=0)
    perm = torch.from_numpy(rng.permutation(n))
    _, l_p, o_p = lse_combine(m[perm], l[perm], o[perm], axis=0)
    np.testing.assert_allclose(final(l_p, o_p), final(l_f, o_f), rtol=1e-5,
                               atol=1e-6)
    split = int(rng.integers(1, n))
    a = lse_combine(m[:split], l[:split], o[:split], axis=0)
    b = lse_combine(m[split:], l[split:], o[split:], axis=0)
    _, l_h, o_h = lse_combine(*(torch.stack([x, y]) for x, y in zip(a, b)),
                              axis=0)
    np.testing.assert_allclose(final(l_h, o_h), final(l_f, o_f), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# K3's int8 entry
# ---------------------------------------------------------------------------

TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _int8_cache(seed, B, S, KVH, hd):
    """An int8 cache and f32 scales in [0.005, 0.02] (the chip check's)."""
    rng = np.random.default_rng(seed)
    kq, vq = (torch.from_numpy(rng.integers(-127, 128, (B, S, KVH, hd),
                                            dtype=np.int8)) for _ in range(2))
    ks, vs = (torch.from_numpy(rng.uniform(0.005, 0.02, (B, S, KVH, 1))
                               .astype(np.float32)) for _ in range(2))
    return kq, ks, vq, vs


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("S,kv_len,kv_offset", [(256, 256, 0), (300, 157, 0),
                                                (512, 700, 300),
                                                (128, 100, 200)])
def test_flash_decode_int8_plain_is_eager_dequant(S, kv_len, kv_offset, dtype):
    """The int8 entry on CPU tensors against the reference's K3
    (interpret mode) on the same int8 cache dequantised in q's dtype by
    jax; and bitwise flash_decode_ref on the cache dequantised eagerly in
    torch, which shows that the CPU takes the plain version and launches
    nothing."""
    B, H, KVH, hd = 2, 6, 2, 32
    q = _normal(S, (B, 1, H, hd))[0]
    jq, q = _pair(q, dtype)
    kq, ks, vq, vs = _int8_cache(S + kv_len, B, S, KVH, hd)
    before = dict(ops.launches)
    got = flash_decode_int8(q, kq, ks, vq, vs, kv_len=kv_len,
                            kv_offset=kv_offset)
    assert ops.launches == before
    jk, jv = (jnp.asarray(t.numpy()).astype(JNP[dtype]) *
              jnp.asarray(s.numpy()).astype(JNP[dtype])
              for t, s in ((kq, ks), (vq, vs)))
    _close(got, jax_flash_decode(jq, jk, jv, kv_len=kv_len,
                                 kv_offset=kv_offset), TOL[dtype])
    kd = kq.to(q.dtype) * ks.to(q.dtype)
    vd = vq.to(q.dtype) * vs.to(q.dtype)
    want = flash_decode_ref(q, kd, vd, kv_len=kv_len, kv_offset=kv_offset)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert torch.equal(got, want)
    assert torch.equal(flash_decode(q, kd, vd, kv_len=kv_len,
                                    kv_offset=kv_offset), want)
    assert torch.equal(dequantize_kv(kq, ks, q.dtype), kd)


def test_flash_decode_int8_matches_reference_on_dequantised_cache():
    """Against the reference's K3 (interpret mode) on the same int8 cache
    dequantised in bf16 by jax, at the bf16 tolerance."""
    B, S, H, KVH, hd = 2, 384, 6, 2, 32
    q = _normal(5, (B, 1, H, hd))[0]
    kq, ks, vq, vs = _int8_cache(6, B, S, KVH, hd)
    jq, tq = _pair(q, "bf16")
    jk = jnp.asarray(kq.numpy()).astype(jnp.bfloat16) * \
        jnp.asarray(ks.numpy()).astype(jnp.bfloat16)
    jv = jnp.asarray(vq.numpy()).astype(jnp.bfloat16) * \
        jnp.asarray(vs.numpy()).astype(jnp.bfloat16)
    want = jax_flash_decode(jq, jk, jv, kv_len=300, bk=128)
    got = flash_decode_int8(tq, kq, ks, vq, vs, kv_len=300, bk=128)
    _close(got, want, TOL["bf16"])


def test_flash_decode_int8_rejects_bad_inputs():
    q = torch.zeros(1, 1, 4, 16)
    kq, ks, vq, vs = _int8_cache(0, 1, 8, 2, 16)
    with pytest.raises(ValueError):          # a scale of the wrong shape
        flash_decode_int8(q, kq, ks[:, :4], vq, vs, kv_len=8)
    with pytest.raises(ValueError):
        flash_decode_int8(q, kq, ks, vq, vs.squeeze(-1), kv_len=8)
    with pytest.raises(TypeError):           # a scale of the wrong dtype
        flash_decode_int8(q, kq, ks.double(), vq, vs, kv_len=8)
    with pytest.raises(TypeError):           # K/V that are not int8
        flash_decode_int8(q, kq.float(), ks, vq, vs, kv_len=8)
    with pytest.raises(TypeError):
        flash_decode_int8(q, kq, ks, vq.to(torch.int16), vs, kv_len=8)
    with pytest.raises(ValueError):          # scales on another device
        flash_decode_int8(q, kq, ks.to("meta"), vq, vs, kv_len=8)
    with pytest.raises(ValueError):          # K/V on another device
        flash_decode_int8(q, kq.to("meta"), ks, vq.to("meta"), vs, kv_len=8)
    with pytest.raises(ValueError):          # two query tokens
        flash_decode_int8(torch.zeros(1, 2, 4, 16), kq, ks, vq, vs, kv_len=8)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_live,bh", [(0, 16), (1, 128), (700, 4),
                                       (32768, 128), (2049, 32)])
def test_split_plan_covers_the_live_rows(n_live, bh):
    split_len, n_splits = split_plan(n_live, bh)
    assert split_len >= MIN_SPLIT
    assert split_len * n_splits >= n_live > split_len * (n_splits - 1) or \
        n_live == n_splits == 0


def test_wrappers_reject_bad_inputs():
    q = torch.zeros(1, 1, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError):
        flash_decode(q, k, k[:, :4], kv_len=8)
    with pytest.raises(ValueError):
        flash_decode(torch.zeros(1, 2, 4, 16), k, k, kv_len=8)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16))
    with pytest.raises(ValueError):
        flash_decode(q, k, k, kv_len=8, bk=0)


# ---------------------------------------------------------------------------
# on the card: the CUDA kernels against the plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_kernels_match_plain(cuda_device, dtype):
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    tol = TOL[dtype]
    qn, kn, vn = _normal(9, (2, 200, 6, 128), (2, 200, 2, 128),
                         (2, 200, 2, 128))
    q, k, v = (torch.from_numpy(a).to(cuda_device, tdt) for a in (qn, kn, vn))
    for causal, off in ((True, 0), (False, 0), (True, 37)):
        got = flash_attention(q, k, v, causal=causal, q_offset=off)
        want = attention_ref(q, k, v, causal=causal, q_offset=off)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    qd = q[:, :1].contiguous()
    for kv_len, off in ((200, 0), (150, 0), (300, 100), (50, 100)):
        got = flash_decode_partials(qd, k, v, kv_len=kv_len, kv_offset=off)
        want = flash_decode_partials_ref(qd, k, v, kv_len=kv_len,
                                         kv_offset=off)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=tol, atol=tol)
    torch.cuda.synchronize()


