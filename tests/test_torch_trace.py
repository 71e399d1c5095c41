"""The port's own host spans (``repro_torch.common.trace``): a shared no-op
without a profiler, nested as the models call them under one, and no
change to what the models compute."""
import dataclasses

import pytest
import torch

from repro_torch.common import trace
from repro_torch.configs import dlrm_rm2, paper_models
from repro_torch.models import dlrm, widedeep

from torch_recsys_util import cut_vocab

B = 24


def _batch(cfg, seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    emb = cfg.embedding
    F, P = emb.num_features, max(emb.pooling)
    ids = torch.randint(0, min(emb.vocab_sizes), (B, F, P), generator=g,
                        dtype=torch.int32)
    pad = torch.rand((B, F, P), generator=g) < 0.3
    ids[pad] = -1
    return {"sparse_ids": ids,
            "dense": torch.randn((B, cfg.n_dense), generator=g)}


def _models():
    """(name, model, its batch, K1 launches a forward, MLP calls a
    forward)."""
    g = torch.Generator().manual_seed(0)
    cpu = torch.device("cpu")
    rm2 = dlrm_rm2.SMOKE
    mt = cut_vocab(paper_models.mt_wnd(False), rows=1000)
    return [
        ("dlrm", dlrm.init(rm2, generator=g, device=cpu), _batch(rm2, 1),
         1, 2),
        ("mt-wnd", widedeep.init(mt, generator=g, device=cpu),
         _batch(mt, 2), 2, 1 + mt.n_tasks),
    ]


MODELS = _models()
IDS = [m[0] for m in MODELS]


def test_span_is_a_shared_noop_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    for name in ("model", "sparse", "k1", "dense", "mlp", "anything"):
        assert trace.span(name) is trace._OFF
    with trace.span("k1"):
        pass


@pytest.mark.parametrize("case", MODELS, ids=IDS)
def test_no_span_recorded_without_a_profiler(case, monkeypatch):
    _, model, batch, _, _ = case
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    with torch.inference_mode():
        model(batch)
    assert opened == []


def _profiled(model, batch):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.inference_mode():
            out = model(batch)
    spans = [(e.name()[len(trace.PREFIX):], e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation() and e.name().startswith(trace.PREFIX)]
    return out, spans


def _within(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("case", MODELS, ids=IDS)
def test_spans_nest_under_a_profiler(case):
    _, model, batch, n_k1, n_mlp = case
    _, spans = _profiled(model, batch)
    by = {n: [s for s in spans if s[0] == n]
          for n in ("model", "sparse", "k1", "dense", "mlp")}
    assert {s[0] for s in spans} == set(by)
    (m,) = by["model"]
    (sparse,) = by["sparse"]
    (dense,) = by["dense"]
    assert _within(sparse, m) and _within(dense, m)
    assert sparse[2] <= dense[1]
    assert len(by["k1"]) == n_k1
    assert all(_within(k, sparse) for k in by["k1"])
    assert len(by["mlp"]) == n_mlp
    assert all(_within(x, dense) for x in by["mlp"])


@pytest.mark.parametrize("case", MODELS, ids=IDS)
def test_scores_bitwise_with_and_without_the_profiler(case):
    _, model, batch, _, _ = case
    with torch.inference_mode():
        off = model(batch)
    on, _ = _profiled(model, batch)
    assert torch.equal(off, on)


def test_k1_span_on_the_hot_entry_and_under_autograd():
    from repro_torch.kernels.embedding_bag import ops

    g = torch.Generator().manual_seed(3)
    table = torch.randn((50, 4), generator=g, requires_grad=True)
    ids = torch.randint(-1, 50, (6, 5), generator=g, dtype=torch.int32)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = ops.hot_embedding_bag(table, ids)
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()]
    assert names.count(trace.PREFIX + "k1") == 1
    out.sum().backward()
    assert table.grad is not None


def test_mlp_span_is_dtype_neutral():
    from repro_torch.models.layers import apply_mlp, init_mlp

    g = torch.Generator().manual_seed(4)
    params = init_mlp((8, 16, 4), generator=g, device=torch.device("cpu"),
                      dtype=torch.bfloat16)
    x = torch.randn((5, 8), generator=g).to(torch.bfloat16)
    off = apply_mlp(params, x, final_activation="sigmoid")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on = apply_mlp(params, x, final_activation="sigmoid")
    assert on.dtype == torch.bfloat16 and torch.equal(off, on)


def test_spans_on_a_config_without_dense_features():
    cfg = dataclasses.replace(dlrm_rm2.SMOKE, n_dense=0, bottom_mlp=())
    g = torch.Generator().manual_seed(5)
    model = dlrm.init(cfg, generator=g, device=torch.device("cpu"))
    _, spans = _profiled(model, _batch(cfg, 6))
    assert [s[0] for s in spans].count("mlp") == 1
