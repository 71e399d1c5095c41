"""The port's serving entry point (``repro_torch.launch.serve_recsys``):
on the CPU at a small size, every fused launch scores as the reference's
``dlrm.apply`` does on the same seeded batch, behind dlrm-rmc1's Hercules
schedule; mt-wnd, din and dien (vocabularies cut to 3,000 rows, widths
and DIN's 200-step history kept) behind their T7 schedules, a fused launch
against the reference's ``widedeep.apply`` / ``din.apply``; with the
default device it needs a card.

Logits use 1e-4: XLA-CPU and torch sum the matrix products in different
orders (for the new models scaled by the largest logit compared)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm_rm2 as j_rm2
from repro.configs import paper_models as j_pm
from repro.core.devices import SERVER_TYPES
from repro.core.gradient_search import gradient_search
from repro.data.clicklog import ClickLogGenerator
from repro.models import din as jdin
from repro.models import dlrm as jdlrm
from repro.models import widedeep as jwnd
from repro_torch.common.convert import tree_from_numpy
from repro_torch.configs import dlrm_rm2 as t_rm2
from repro_torch.configs import paper_models as t_pm
from repro_torch.kernels.embedding_bag import ops
from repro_torch.launch.serve_recsys import SERVABLE, main, serve
from repro_torch.models import din as tdin
from repro_torch.models import dlrm as tdlrm
from repro_torch.models import widedeep as twnd
from torch_recsys_util import cut_vocab

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def served():
    jparams = jdlrm.init(jax.random.PRNGKey(0), j_rm2.SMOKE)
    model = tdlrm.DLRM(t_rm2.SMOKE, tdlrm.params_from_reference(
        jax.tree.map(np.asarray, jparams), device=CPU))
    out = serve(t_rm2.SMOKE, t_pm.paper_profile("dlrm-rmc1"), "T2", device="cpu",
                n_queries=4, qps=2000.0, seed=0, model=model, keep_launches=64)
    return jparams, out


def test_serve_answers_queries_behind_the_schedule(served):
    _, out = served
    assert out["served_queries"] == 4 and len(out["latency_ms"]) == 4
    # the schedule is the reference's for dlrm-rmc1 on T2
    sizes = ClickLogGenerator(j_rm2.SMOKE, seed=1).query_sizes(300)
    ref = gradient_search(j_pm.paper_profile("dlrm-rmc1"), SERVER_TYPES["T2"],
                          sizes, o_grid=(1, 2))
    s = out["schedule"]
    assert (s["plan"], s["batch"], s["m"], s["o"], s["qps"]) == (
        ref.placement.plan, ref.sched.batch, ref.sched.m, ref.sched.o, ref.qps)
    # the query sizes the run drew, replayed from the same generator
    gen = ClickLogGenerator(j_rm2.SMOKE, seed=1)
    gen.query_sizes(300)
    gen.batch(s["batch"], with_labels=False)  # warm-up launch
    fused = 0
    for _ in range(4):
        q = int(gen.query_sizes(1)[0])
        fused += math.ceil(q / s["batch"])
        for _ in range(math.ceil(q / s["batch"])):
            gen.batch(s["batch"], with_labels=False)
    assert out["fused_launches"] == fused == len(out["kept"])
    assert out["k1_launches"] == 0  # CPU tensors: the plain version
    assert 0 < out["p50_ms"] <= out["p95_ms"] <= out["p99_ms"]


def test_every_fused_launch_matches_reference(served):
    jparams, out = served
    d = out["schedule"]["batch"]
    for batch, scores in out["kept"]:
        assert batch["sparse_ids"].shape[0] == d and scores.shape == (d,)
        want = jdlrm.apply(jparams, jax.tree.map(jnp.asarray, batch), j_rm2.SMOKE)
        np.testing.assert_allclose(scores, np.asarray(want), rtol=1e-4, atol=1e-4)


def test_serve_argument_checks():
    prof = t_pm.paper_profile("dlrm-rmc1")
    with pytest.raises(ValueError):
        serve(t_rm2.SMOKE, prof, device="cpu")
    with pytest.raises(ValueError):
        serve(t_rm2.SMOKE, prof, device="cpu", n_queries=2, seconds=1.0)


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve(t_rm2.SMOKE, t_pm.paper_profile("dlrm-rmc1"), n_queries=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--seconds", "0.1"])


def test_serve_on_card_launches_k1_per_fused_launch():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    ops.launches = 0
    out = serve(t_rm2.SMOKE, t_pm.paper_profile("dlrm-rmc1"), device="cuda",
                n_queries=3, qps=2000.0)
    assert out["k1_launches"] == ops.launches == out["fused_launches"] + 1


# ---------------------------------------------------------------------------
# MT-WnD, DIN and DIEN behind their T7 schedules (vocabularies cut)
# ---------------------------------------------------------------------------


def _cut(cfg):
    return cut_vocab(cfg, qr_features=())


PAPER_LIBS = {"mt-wnd": (jwnd, twnd.WideDeep), "din": (jdin, tdin.DIN),
              "dien": (jdin, tdin.DIN)}


@pytest.fixture(scope="module", params=sorted(PAPER_LIBS))
def served_paper(request):
    name = request.param
    jlib, cls = PAPER_LIBS[name]
    jcfg, tcfg = _cut(j_pm.PAPER_MODELS[name](True)), _cut(t_pm.PAPER_MODELS[name](True))
    jparams = jlib.init(jax.random.PRNGKey(0), jcfg)
    model = cls(tcfg, tree_from_numpy(jax.tree.map(np.asarray, jparams), CPU))
    ops.launches = 0
    out = serve(tcfg, t_pm.paper_profile(name), "T7", device="cpu",
                n_queries=2, qps=2000.0, seed=0, model=model, keep_launches=1)
    return name, jlib, jcfg, jparams, out


def test_paper_model_served_behind_t7_schedule(served_paper):
    name, jlib, jcfg, jparams, out = served_paper
    s = out["schedule"]
    sizes = ClickLogGenerator(jcfg, seed=1).query_sizes(300)
    ref = gradient_search(j_pm.paper_profile(name), SERVER_TYPES["T7"], sizes,
                          o_grid=(1, 2))
    assert (s["plan"], s["batch"], s["m"], s["o"]) == (
        ref.placement.plan, ref.sched.batch, ref.sched.m, ref.sched.o)
    assert out["served_queries"] == 2 and out["fused_launches"] >= 2
    assert out["k1_launches"] == ops.launches == 0  # CPU: the plain version
    batch, scores = out["kept"][0]
    d = s["batch"]
    assert scores.shape == ((d, 5) if name == "mt-wnd" else (d,))
    if name != "mt-wnd":
        assert batch["history_ids"].shape == (d, 200)
    want = jlib.apply(jparams, jax.tree.map(jnp.asarray, batch), jcfg)
    np.testing.assert_allclose(scores, np.asarray(want), rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


def test_main_takes_the_paper_models():
    assert set(SERVABLE) == set(t_pm.PAPER_MODELS)
    with pytest.raises(SystemExit):
        main(["--model", "no-such-model"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: main would serve on it")
    for name in ("mt-wnd", "din", "dien"):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--model", name, "--server", "T7", "--seconds", "0.1"])
