"""The sequence-sharded decode against the reference's ``flash_decode_sharded``
and the port's single-device decode.

The reference runs in a subprocess with 8 fake CPU devices on a (2, 4)
("data", "model") mesh, exactly as ``tests/test_distributed.py::run_sub``
runs it (its ``test_distributed_flash_decode_matches_local`` passes), and
writes its outputs for both layouts (the cache's sequence over ("data",
"model"), long_500k's; over "model" with the batch over "data",
decode_32k's) at kv_len S, 700, 130 and 1.  The port runs the same numpy
inputs on four gloo ranks ((2, 2) mesh), spawned once for the file while
the reference's subprocess runs: K3's partials on each rank's slice, one
all-gather, the lse merge.  Also K3's int8 entry through the same merge
against the path on the eagerly dequantised cache and the single-device
int8 entry, the binding's entry point, and one decode step of a 2-layer
LM (f32 and int8 caches) with its cache sequence-sharded against the
port's single-device step: the logits, the cache after the write, and the
new token's row written on exactly one rank.

Tolerances: 1e-5 on attention (float32 partials merged in another order),
2e-4 on the LM's logits (two layers of reordered sums)."""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro_torch.kernels.flash_attention import ops as t_ops
from repro_torch.launch.mesh import spawn
from repro_torch.models import transformer as tf_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL, LM_TOL = 1e-5, 2e-4
B, S, H, KVH, HD = 2, 1024, 8, 2, 32
KV_LENS = (S, 700, 130, 1)
LAYOUTS = {"long_500k": (("data", "model"), ()),
           "decode_32k": (("model",), ("data",))}
LM_CFG = dict(name="t", n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
              d_ff=128, vocab=128, head_dim=16, dtype=torch.float32)
LM_B, LM_S, LM_POS = 1, 256, 100   # kv_len 101 ends inside shard 1 of 4

REF_BODY = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import warnings; warnings.filterwarnings("ignore")
import jax, jax.numpy as jnp, numpy as np
from repro.dist.decode import flash_decode_sharded
mesh = jax.make_mesh((2, 4), ("data", "model"))
inp = np.load(sys.argv[1])
q, k, v = (jnp.asarray(inp[n]) for n in ("q", "k", "v"))
layouts = {"long_500k": dict(seq_axes=("data", "model"), batch_axes=()),
           "decode_32k": dict(seq_axes=("model",), batch_axes=("data",))}
out = {}
for name, lay in layouts.items():
    for kv_len in (%s):
        o = jax.jit(lambda q, k, v, kl=kv_len, la=lay: flash_decode_sharded(
            q, k, v, kv_len=kl, mesh=mesh, bk=128, interpret=True,
            **la))(q, k, v)
        out[f"{name}-{kv_len}"] = np.asarray(o)
np.savez(sys.argv[2], **out)
print("PASS")
""" % ", ".join(map(str, KV_LENS))


def _attn_inputs() -> dict:
    rng = np.random.default_rng(0)
    f32 = np.float32
    inp = {"q": rng.standard_normal((B, 1, H, HD)).astype(f32),
           "k": rng.standard_normal((B, S, KVH, HD)).astype(f32),
           "v": rng.standard_normal((B, S, KVH, HD)).astype(f32)}
    for n in ("k", "v"):
        inp[n + "q"] = rng.integers(-127, 128, (B, S, KVH, HD)).astype(
            np.int8)
        inp[n + "s"] = rng.uniform(0.005, 0.02, (B, S, KVH, 1)).astype(f32)
    return inp


def _lm_case(kv_quant: str) -> dict:
    """The whole model, the prefilled cache before the step, and the
    single-device step's logits and cache after it (naive and flash)."""
    cfg = tf_lib.LMConfig(**LM_CFG, kv_quant=kv_quant)
    cpu = torch.device("cpu")
    params = tf_lib.init(cfg, generator=torch.Generator().manual_seed(1),
                         device=cpu)
    g = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (LM_B, LM_POS), generator=g)
    token = torch.randint(0, cfg.vocab, (LM_B, 1), generator=g)
    with torch.inference_mode():
        cache = tf_lib.init_kv_cache(cfg, LM_B, LM_S, device=cpu)
        tf_lib.prefill(params, toks, cache, cfg)
        before = {k: v.clone() for k, v in cache.items()}
        want = {}
        for impl in ("naive", "flash"):
            c = {k: v.clone() for k, v in before.items()}
            logits, c = tf_lib.decode_step(
                params, token, c, LM_POS,
                dataclasses.replace(cfg, decode_impl=impl))
            want[impl] = (logits.numpy(), {k: v.numpy() for k, v in
                                           c.items()})
    fields = dict(LM_CFG, kv_quant=kv_quant)
    return {"args": dict(cfg=fields, params=params, cache=before,
                         token=token, pos=LM_POS),
            "want": want, "before": {k: v.numpy() for k, v in
                                     before.items()}}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("decode")
    attn = _attn_inputs()
    np.savez(tmp / "in.npz", **attn)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REF_BODY), str(tmp / "in.npz"),
         str(tmp / "ref.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    lm = {kv: _lm_case(kv) for kv in ("none", "int8")}
    try:
        out = spawn(ranks.decode_rank, 4, backend="gloo",
                    init_file=tmp / "init", device="cpu",
                    args=(dict(attn, kv_lens=KV_LENS),
                          {kv: c["args"] for kv, c in lm.items()}))
    finally:
        stdout, stderr = ref.communicate(timeout=300)
    assert ref.returncode == 0 and "PASS" in stdout, stderr
    return attn, dict(np.load(tmp / "ref.npz")), lm, out


def _gathered(out, key, batch_axes):
    """The whole [B, ...] output from the ranks' batch blocks."""
    if not batch_axes:
        first = out[0][key]
        for r in out[1:]:
            np.testing.assert_array_equal(r[key], first)
        return first
    by = {r["coords"]["data"]: r[key] for r in out}
    return np.concatenate([by[d] for d in sorted(by)])


@pytest.mark.parametrize("kv_len", KV_LENS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sharded_decode_matches_reference(results, layout, kv_len):
    attn, ref, _, out = results
    got = _gathered([{"coords": r["coords"],
                      "x": r["attn"][(layout, kv_len)]} for r in out], "x",
                    LAYOUTS[layout][1])
    np.testing.assert_allclose(got, ref[f"{layout}-{kv_len}"], rtol=TOL,
                               atol=TOL)
    single = t_ops.flash_decode(*(torch.from_numpy(attn[n]) for n in
                                  ("q", "k", "v")), kv_len=kv_len).numpy()
    np.testing.assert_allclose(got, single, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kv_len", KV_LENS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sharded_int8_decode(results, layout, kv_len):
    """K3's int8 partials through the merge: the sharded path on the
    eagerly dequantised cache, and the single-device int8 entry."""
    attn, _, _, out = results
    got = _gathered([{"coords": r["coords"],
                      "x": r["int8"][(layout, kv_len)]} for r in out], "x",
                    LAYOUTS[layout][1])
    t = {n: torch.from_numpy(attn[n]) for n in attn}
    single = t_ops.flash_decode_int8(t["q"], t["kq"], t["ks"], t["vq"],
                                     t["vs"], kv_len=kv_len).numpy()
    np.testing.assert_allclose(got, single, rtol=TOL, atol=TOL)
    deq = t_ops.flash_decode(t["q"], t["kq"].float() * t["ks"],
                             t["vq"].float() * t["vs"], kv_len=kv_len)
    np.testing.assert_allclose(got, deq.numpy(), rtol=TOL, atol=TOL)


def test_bound_entry_takes_the_sharded_path(results):
    attn, ref, _, out = results
    got = _gathered(out, "bound", ("data",))
    np.testing.assert_allclose(got, ref["decode_32k-700"], rtol=TOL,
                               atol=TOL)
    for r in out:  # 2 layouts x 4 kv_len x 2 entries, then the bound call
        assert r["gathers"] >= 2 * len(KV_LENS) * 2 + 1


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_lm_decode_step_seq_sharded(results, kv_quant):
    """One decode step of a 2-layer LM with the cache over ("data",
    "model"): the logits against the single-device step (naive and flash),
    the cache after the write (the first layer's bitwise: it sees the same
    input), and the new row written only by the rank holding ``pos``."""
    _, _, lm, out = results
    case = lm[kv_quant]
    s_local = LM_S // 4
    for r in out:
        res = r["lm"][kv_quant]
        assert res["s_local"] == s_local
        for impl in ("naive", "flash"):
            np.testing.assert_allclose(res["logits"], case["want"][impl][0],
                                       rtol=LM_TOL, atol=LM_TOL)
        i = 2 * r["coords"]["data"] + r["coords"]["model"]
        owner = i * s_local <= LM_POS < (i + 1) * s_local
        assert res["changed_rows"] == ([LM_POS - i * s_local] if owner
                                       else [])
        want_cache = case["want"]["flash"][1]
        for name, got in res["cache"].items():
            want = want_cache[name][:, :, i * s_local:(i + 1) * s_local]
            np.testing.assert_array_equal(got[0], want[0].astype(np.float32))
            if name in ("k", "v") and kv_quant == "int8":
                assert np.abs(got - want.astype(np.float32)).max() <= 1
            else:
                np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
