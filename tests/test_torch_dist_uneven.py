"""The uneven head split of the LM's tensor parallelism, against the
reference's single-device step.

Where the "model" ranks outnumber the kv heads, each kv head is whole on
the ranks that share it and its q heads, padded with zero heads to a
multiple of them, are split over them (``repro_torch.dist.sharding.
HeadSplit``): the layout the production meshes' 16 "model" ranks need for
llama3.2-3b, qwen2-7b and deepseek-67b.  Gloo ranks on the CPU
(``torch_dist_ranks.uneven_rank``), small configs:

- llama3.2-3b SMOKE with 6 heads and 2 kv heads on (data 1, model 4): a
  kv head on 2 ranks, 3 q heads padded to 4, 2 a rank;
- qwen2-7b SMOKE (qkv bias, untied head) with the same heads on (data 2,
  model 4);
- llama3.2-3b SMOKE with 8 heads and 2 kv heads on 4 ranks: replicated,
  no padding;
- 6 heads and 3 kv heads on 4 ranks, which must still raise.

Each case's ``train_4k`` step (batch 4, sequence 32, f32) against the
reference's jitted ``value_and_grad(lm_loss)`` and ``adamw(3e-4)``: the
loss, each rank's block of every gradient leaf (its heads' columns, a
padded head's exactly zero; 2e-4 of the leaf's largest entry, the mesh
train tests' attention tolerance) and its parameters after the step
where |g| is not tiny; after the step every padded head's entries and
optimizer moments are exactly zero and the copies of each kv head
bitwise equal on the ranks that hold it.  Its ``prefill_32k`` against
the reference's prefill: the rank's vocabulary slice of the last logits
and its block of the cache (its batch rows and its kv head)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_ranks as ranks
from repro.configs.registry import get_arch as j_get_arch
from repro.models import transformer as j_tf
from repro.train import optimizer as j_opt
from repro_torch.common.tree import tree_map
from repro_torch.common.types import ArchKind
from repro_torch.dist.sharding import HeadSplit, P, param_spec_tree
from repro_torch.launch.mesh import spawn
from repro_torch.models import transformer as t_tf
from torch_dist_train_util import block, close

TOL = 2e-4
CPU = __import__("torch").device("cpu")
CASES = {  # name: (arch, heads, kv heads, mesh)
    "pad": ("llama3.2-3b", 6, 2, (1, 4)),
    "bias_dp": ("qwen2-7b", 6, 2, (2, 4)),
    "no_pad": ("llama3.2-3b", 8, 2, (1, 4)),
    "raises": ("llama3.2-3b", 6, 3, (1, 4)),
}
j_value_and_grad = jax.jit(jax.value_and_grad(j_tf.lm_loss), static_argnums=2)


def _reference(arch_id: str, heads: int, kv: int, seed: int) -> dict:
    cfg = dataclasses.replace(j_get_arch(arch_id).SMOKE, n_heads=heads,
                              n_kv_heads=kv)
    jp = jax.jit(j_tf.init, static_argnums=1)(jax.random.PRNGKey(seed), cfg)
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab, (4, 32)).astype(np.int32)
    loss, grads = j_value_and_grad(jp, {"tokens": tokens}, cfg)
    opt = j_opt.adamw(lr=3e-4)
    new, _ = opt.update(jp, grads, opt.init(jp))
    logits, cache = j_tf.prefill(jp, jnp.asarray(tokens),
                                 j_tf.init_kv_cache(cfg, 4, 32), cfg)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return {"params": np_tree(jp), "tokens": tokens, "loss": float(loss),
            "grads": np_tree(grads), "new": np_tree(new),
            "logits": np.asarray(logits), "cache": np_tree(cache),
            "head_dim": cfg.head_dim}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("uneven")
    refs = {name: _reference(arch, h, kv, seed) for seed, (name, (
        arch, h, kv, _)) in enumerate(CASES.items()) if name != "raises"}

    def case(name):
        arch, h, kv, _ = CASES[name]
        ref = refs.get(name, refs["pad"])
        return {"arch_id": arch, "overrides": {"n_heads": h, "n_kv_heads": kv},
                "params": t_tf.params_from_reference(ref["params"],
                                                     device=CPU),
                "tokens": ref["tokens"]}

    out = {}
    for shape in sorted({c[3] for c in CASES.values()}):
        names = [n for n, c in CASES.items() if c[3] == shape]
        out[shape] = spawn(ranks.uneven_rank, int(np.prod(shape)),
                           backend="gloo", init_file=tmp / f"init-{shape}",
                           device="cpu",
                           args=({n: case(n) for n in names}, shape))
    return refs, out


def _rank_cases(results, name):
    refs, out = results
    shape = CASES[name][3]
    mesh = dict(zip(("data", "model"), shape))
    return refs.get(name), mesh, [(r["coords"], r["cases"][name])
                                  for r in out[shape]]


@pytest.mark.parametrize("name", ["pad", "bias_dp", "no_pad"])
def test_uneven_train_step_matches_reference(results, name):
    ref, mesh, cases = _rank_cases(results, name)
    arch, h, kv, _ = CASES[name]
    split = HeadSplit.of(arch, h, kv, mesh["model"])
    assert split.share == mesh["model"] // kv
    assert split.padded == (name != "no_pad")
    heads = (split, ref["head_dim"])
    specs = param_spec_tree(ArchKind.LM_DENSE, ref["params"])
    for c, case in cases:
        i = c["model"]
        assert case["q_heads"] == split.q_heads(i)
        assert case["kv_heads"] == split.kv_heads(i)
        close(case["loss"], ref["loss"], TOL)
        want = block(ref["grads"], specs, mesh, c, heads=heads)
        tree_map(lambda g, w: close(g, w, TOL), case["grads"], want)
        tree_map(lambda p, w, g: close(
            p, w, TOL, mask=np.abs(g) > 1e-3 * np.abs(g).max()),
            case["params"], block(ref["new"], specs, mesh, c, heads=heads),
            want)


@pytest.mark.parametrize("name", ["pad", "bias_dp"])
def test_padded_heads_stay_zero(results, name):
    """A padded q head's wq columns, bq entries and wo rows, and their
    optimizer moments, are exactly zero after the step, on every rank
    that holds one (and some rank does)."""
    ref, mesh, cases = _rank_cases(results, name)
    hd, padded = ref["head_dim"], 0
    for _, case in cases:
        pad = np.repeat(np.array(case["q_heads"]) < 0, hd)
        if not pad.any():
            continue
        padded += 1
        for tree in (case["params"], case["opt"]["m"], case["opt"]["v"]):
            attn = tree["blocks"]["attn"]
            assert not attn["wq"][..., pad].any()
            assert not attn["wo"][:, pad, :].any()
            if "bq" in attn:
                assert not attn["bq"][..., pad].any()
        assert not case["grads"]["blocks"]["attn"]["wo"][:, pad, :].any()
    assert padded == mesh["data"] * mesh["model"] // 2


@pytest.mark.parametrize("name", ["pad", "bias_dp", "no_pad"])
def test_replicated_kv_heads_bitwise_equal(results, name):
    """Every rank that holds a kv head holds the same bits of its wk, wv
    (bk, bv) and their moments after the step."""
    _, _, cases = _rank_cases(results, name)
    by_head: dict = {}
    for _, case in cases:
        by_head.setdefault(tuple(case["kv_heads"]), []).append(case)
    assert all(len(v) >= 2 for v in by_head.values())
    for copies in by_head.values():
        for tree in ("params", "grads"):
            for other in copies[1:]:
                a = copies[0][tree]["blocks"]["attn"]
                b = other[tree]["blocks"]["attn"]
                for k in ("wk", "wv", "bk", "bv"):
                    if k in a:
                        np.testing.assert_array_equal(a[k], b[k])
        for other in copies[1:]:
            for key in ("m", "v"):
                np.testing.assert_array_equal(
                    copies[0]["opt"][key]["blocks"]["attn"]["wk"],
                    other["opt"][key]["blocks"]["attn"]["wk"])


@pytest.mark.parametrize("name", ["pad", "bias_dp", "no_pad"])
def test_uneven_prefill_matches_reference(results, name):
    ref, mesh, cases = _rank_cases(results, name)
    dp = "data"
    for c, case in cases:
        close(case["logits"], block(ref["logits"], P(dp, "model"), mesh, c),
              TOL)
        for k, got in case["cache"].items():
            want = block(ref["cache"][k], P(None, dp, None, None, None),
                         mesh, c)[:, :, :, case["kv_heads"], :]
            close(got, want, TOL)


def test_heads_that_neither_split_nor_divide_raise(results):
    _, _, cases = _rank_cases(results, "raises")
    for _, case in cases:
        assert "3 kv_heads neither split over nor divide the 4 ranks" in \
            case["error"]
        assert case["error"].startswith("llama3.2-3b-smoke:")
