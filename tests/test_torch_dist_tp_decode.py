"""The decode cells on a mesh, tensor-parallel over "model" as the
reference's are, against the reference's single-device ``decode_step``.

A decode cell on a mesh holds this rank's block of every weight (whole
heads, ``HeadSplit``), its slice of the cache's sequence with every kv
head, and returns its vocabulary slice of the logits; each layer gathers
the token's q heads and new k/v rows over the heads' ranks in one
all-gather, runs K3's partials for all heads on the slice, merges them
over the seq group and keeps its own heads of the output (the slots'
mapping to global heads is held to ``HeadSplit`` alone, for the test's
splits and the production meshes').  Gloo ranks on the CPU
(``torch_dist_ranks.tp_decode_rank``), SMOKE configs (2 layers, S = 32),
float32:

- the uneven head splits of ``test_torch_dist_uneven.py``: 6 heads and 2
  kv heads on (data 1, model 4) (a kv head on 2 ranks, 3 q heads padded
  to 4), qwen2-7b's qkv bias with the same heads on (data 2, model 4),
  8 heads and 2 kv heads on 4 ranks (replicated, no padding); an even
  split, 8 heads and 4 kv heads on 4 ranks; olmoe-1b-7b SMOKE (8 experts
  over "model" 4) on (data 2, model 4); and 6 heads and 3 kv heads on 4
  ranks, which must still raise;
- both layouts: batch 4, long_500k's (the sequence over ("data",
  "model"), the batch replicated), and batch 16, decode_32k's (the batch
  over "data", the sequence over "model");
- f32 and int8 caches (random rows, int8 scales in [0.005, 0.02]);
- pos 13, inside a middle shard (through ``decode_step`` under the
  cell's binding), and S - 1 (the cell's own step, only the last shard
  writing).

Held: the ranks' vocabulary slices of the logits, gathered, within 2e-4
of the reference's (scaled by its largest, the mesh decode tests'
tolerance); the new token's row on exactly one rank of each batch block,
against the reference's new row (f32 at 2e-4, int8 codes at most one
apart and scales at 2e-4), every other row of every slice bitwise
unchanged; every K3 partials call over all the heads; a padded head's
attention output exactly zero; a dense model's collectives, one packed
all-gather and one merge a layer, two all-reduces a layer and the
embedding's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_ranks as ranks
from repro.configs.registry import get_arch as j_get_arch
from repro.models import transformer as j_tf
from repro_torch.dist.sharding import P
from repro_torch.launch.mesh import spawn
from repro_torch.models import transformer as t_tf
from torch_dist_train_util import assemble, close

TOL = 2e-4
CPU = __import__("torch").device("cpu")
S, MIDDLE = 32, 13
CASES = {  # name: (arch, overrides, mesh)
    "pad": ("llama3.2-3b", {"n_heads": 6, "n_kv_heads": 2}, (1, 4)),
    "bias_dp": ("qwen2-7b", {"n_heads": 6, "n_kv_heads": 2}, (2, 4)),
    "no_pad": ("llama3.2-3b", {"n_heads": 8, "n_kv_heads": 2}, (1, 4)),
    "even": ("llama3.2-3b", {"n_heads": 8, "n_kv_heads": 4}, (1, 4)),
    "moe": ("olmoe-1b-7b", {}, (2, 4)),
    "raises": ("llama3.2-3b", {"n_heads": 6, "n_kv_heads": 3}, (1, 4)),
}
LAYOUTS = {"long_500k": 4, "decode_32k": 16}  # layout: batch
KV = ("none", "int8")
STEPS = [(name, layout, kv, pos) for name in CASES if name != "raises"
         for layout in LAYOUTS for kv in KV for pos in (MIDDLE, S - 1)]
j_decode = jax.jit(j_tf.decode_step, static_argnums=4)


def _cfg(arch_id: str, overrides: dict, kv: str):
    return dataclasses.replace(j_get_arch(arch_id).SMOKE, kv_quant=kv,
                               **overrides)


def _cache(cfg, B: int, rng) -> dict:
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.kv_quant == "none":
        return {k: rng.standard_normal(shape).astype(np.float32)
                for k in ("k", "v")}
    out = {k: rng.integers(-127, 128, shape).astype(np.int8)
           for k in ("k", "v")}
    for k in ("ks", "vs"):
        out[k] = rng.uniform(0.005, 0.02, (*shape[:-1], 1)).astype(
            np.float32)
    return out


def _reference(seed: int, arch_id: str, overrides: dict) -> dict:
    """The parameters, and each step's inputs and the reference's logits
    and cache after it."""
    rng = np.random.default_rng(seed)
    cfg = _cfg(arch_id, overrides, "none")
    jp = jax.jit(j_tf.init, static_argnums=1)(jax.random.PRNGKey(seed), cfg)
    out = {"params": jax.tree.map(np.asarray, jp), "steps": {},
           "head_dim": cfg.head_dim, "n_layers": cfg.n_layers}
    for layout, B in LAYOUTS.items():
        for kv in KV:
            cfg = _cfg(arch_id, overrides, kv)
            cache = _cache(cfg, B, rng)
            token = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
            want = {}
            for pos in (MIDDLE, S - 1):
                logits, new = j_decode(jp, jnp.asarray(token), jax.tree.map(
                    jnp.asarray, cache), pos, cfg)
                want[pos] = (np.asarray(logits), jax.tree.map(np.asarray,
                                                              new))
            out["steps"][(layout, kv)] = {"token": token, "cache": cache,
                                          "positions": (MIDDLE, S - 1),
                                          "want": want}
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_decode")
    refs = {name: _reference(seed, arch, over) for seed, (name, (
        arch, over, _)) in enumerate(CASES.items()) if name != "raises"}

    def case(name):
        arch, over, _ = CASES[name]
        ref = refs.get(name, refs["pad"])
        steps = {k: {kk: vv for kk, vv in v.items() if kk != "want"}
                 for k, v in ref["steps"].items()}
        return {"arch_id": arch, "overrides": over, "steps": steps,
                "params": t_tf.params_from_reference(ref["params"],
                                                     device=CPU)}

    out = {}
    for shape in sorted({c[2] for c in CASES.values()}):
        names = [n for n, c in CASES.items() if c[2] == shape]
        out[shape] = spawn(ranks.tp_decode_rank, int(np.prod(shape)),
                           backend="gloo", init_file=tmp / f"init-{shape}",
                           device="cpu",
                           args=({n: case(n) for n in names}, shape))
    return refs, out


def _step(results, name, layout, kv, pos):
    refs, out = results
    mesh = dict(zip(("data", "model"), CASES[name][2]))
    ref = refs[name]
    want = ref["steps"][(layout, kv)]["want"][pos]
    got = [(r["coords"], r["cases"][name]["steps"][(layout, kv, pos)])
           for r in out[CASES[name][2]]]
    return ref, want, mesh, got


@pytest.mark.parametrize("name,layout,kv,pos", STEPS)
def test_logits_match_reference(results, name, layout, kv, pos):
    ref, (logits, _), mesh, got = _step(results, name, layout, kv, pos)
    dp = "data" if LAYOUTS[layout] >= 16 else None
    for c, g in got:
        assert g["rules"]["heads"] == "model"
        assert g["rules"]["kv_seq"] == (("model",) if dp else
                                        ("data", "model"))
        assert g["logits"].shape == (LAYOUTS[layout] // (mesh["data"] if dp
                                                         else 1),
                                     logits.shape[1] // mesh["model"])
    whole = assemble([g["logits"] for _, g in got], P(dp, "model"), mesh,
                     [c for c, _ in got])
    close(whole, logits, TOL)


@pytest.mark.parametrize("name,layout,kv,pos", STEPS)
def test_new_row_on_one_rank_others_unchanged(results, name, layout, kv,
                                              pos):
    """The new token's row is written on the one rank of each batch block
    whose slice holds pos, as the reference writes it; every other row of
    every rank's slice is bitwise the one before the step."""
    _, (_, new), mesh, got = _step(results, name, layout, kv, pos)
    dp = LAYOUTS[layout] >= 16
    owners = {}
    for c, g in got:
        s_loc = g["after"]["k"].shape[2]
        off = g["offset"]
        b = c["data"] if dp else 0
        B_loc = g["after"]["k"].shape[1]
        mine = off <= pos < off + s_loc
        for k, after in g["after"].items():
            before = g["before"][k]
            rows = [r for r in range(s_loc) if not mine or r != pos - off]
            np.testing.assert_array_equal(after[:, :, rows],
                                          before[:, :, rows])
            if not mine:
                continue
            want = new[k][:, b * B_loc:(b + 1) * B_loc, pos]
            row = after[:, :, pos - off]
            if k in ("k", "v") and kv == "int8":
                assert np.abs(row - want.astype(np.float32)).max() <= 1
            else:
                close(row, want, TOL)
        if mine:
            owners[b] = owners.get(b, 0) + 1
    blocks = mesh["data"] if dp else 1
    assert owners == {b: 1 for b in range(blocks)}


@pytest.mark.parametrize("name,layout,kv,pos", STEPS)
def test_attention_over_all_heads_padded_slots_zero(results, name, layout,
                                                    kv, pos):
    """Every K3 partials call takes all the heads; each rank's attention
    output holds its own heads, a padded slot exactly zero; a dense
    model's collectives are one packed gather and one merge a layer, and
    its two row-parallel all-reduces a layer and the embedding's."""
    ref, _, mesh, got = _step(results, name, layout, kv, pos)
    arch, over, _ = CASES[name]
    cfg = _cfg(arch, over, kv)
    L = ref["n_layers"]
    padded = 0
    for _, g in got:
        assert g["partial_heads"] == [cfg.n_heads] * L
        assert len(g["attn"]) == L
        pad = np.array(g["q_heads"]) < 0
        for a in g["attn"]:
            assert a.shape[2] == len(g["q_heads"])
            assert not a[:, :, pad].any()
            assert np.abs(a[:, :, ~pad]).max() > 0
        padded += int(pad.any())
        if cfg.moe is None:
            # the one token keeps the all-reduce form: no reduce-scatter
            # or sequence gather
            assert g["calls"] == {"all_gather": 2 * L,
                                  "all_reduce": 2 * L + 1,
                                  "reduce_scatter": 0, "gather": 0}
    assert padded == (mesh["data"] * mesh["model"] // 2
                      if name in ("pad", "bias_dp") else 0)


SPLITS = [(6, 2, 4), (8, 2, 4), (8, 4, 4), (16, 16, 4), (28, 4, 8),
          (24, 8, 16), (28, 4, 16), (64, 8, 16), (32, 8, 8)]


@pytest.mark.parametrize("n_heads,n_kv_heads,ranks", SPLITS)
def test_head_slots_map_to_global_heads(n_heads, n_kv_heads, ranks):
    """``whole_heads`` puts every rank's slots, gathered in rank order, in
    global head order by ``HeadSplit.q_heads`` / ``kv_heads`` (a padded
    slot dropped, a replicated kv head taken once); ``own_heads`` gives
    rank i its slots back, a padded one zero.  The test's small splits
    and the production meshes' (llama3.2-3b, qwen2-7b and deepseek-67b on
    16 ranks)."""
    import torch

    from repro_torch.dist.decode import own_heads, whole_heads
    from repro_torch.dist.sharding import HeadSplit

    split = HeadSplit.of("t", n_heads, n_kv_heads, ranks)

    def slots(heads_of, n_local):
        # a slot holds 1 + its head (0 for a pad), in rank order
        ids = [h + 1 for i in range(ranks) for h in heads_of(i)]
        assert len(ids) == ranks * n_local
        return torch.tensor(ids, dtype=torch.float32).reshape(1, 1, -1, 1)

    q = whole_heads(slots(split.q_heads, split.q_local), split)
    assert q.flatten().tolist() == list(range(1, n_heads + 1))
    kv = whole_heads(slots(split.kv_heads, split.kv_local), split, kv=True)
    assert kv.flatten().tolist() == list(range(1, n_kv_heads + 1))
    out = torch.arange(1, n_heads + 1, dtype=torch.float32).reshape(
        1, 1, -1, 1)
    for i in range(ranks):
        assert own_heads(out, split, i).flatten().tolist() == [
            h + 1 for h in split.q_heads(i)]


def test_heads_that_neither_split_nor_divide_raise(results):
    _, out = results
    for r in out[CASES["raises"][2]]:
        error = r["cases"]["raises"]["error"]
        assert "3 kv_heads neither split over nor divide the 4 ranks" in \
            error
        assert error.startswith("llama3.2-3b-smoke:")
