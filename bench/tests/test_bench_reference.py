"""The plain references agree with the port's models on the CPU at the
SMOKE widths, given the same weights and inputs, and import nothing of
the program."""
import ast
import dataclasses
from pathlib import Path

import pytest
import torch

from bench import gen
from bench.reference import common, dlrm, widedeep
from bench.tests.util import sizes_of

REF_DIR = Path(dlrm.__file__).parent
TRAFFIC = {"zipf_alpha": 1.05, "pooling_share": 0.6, "pooling_sigma": 0.6}


def _configs():
    from repro_torch.configs import dlrm_rm2, paper_models, wide_deep
    from repro_torch.models.embedding import EmbeddingConfig

    mt = paper_models.mt_wnd(False)
    mt = dataclasses.replace(mt, embedding=dataclasses.replace(
        mt.embedding, vocab_sizes=(3000,) * 26))
    rm2_bf16 = dataclasses.replace(
        dlrm_rm2.FULL, embedding=EmbeddingConfig(
            vocab_sizes=(3000,) * 26, dim=64, pooling=(64,) * 26,
            dtype=torch.bfloat16))
    return {"dlrm-rm2 smoke": (dlrm_rm2.SMOKE, "dlrm", "DLRM"),
            "wide-deep smoke": (wide_deep.SMOKE, "widedeep", "WideDeep"),
            "mt-wnd, 3,000 rows": (mt, "widedeep", "WideDeep"),
            "dlrm-rm2 bf16, 3,000 rows": (rm2_bf16, "dlrm", "DLRM")}


@pytest.mark.parametrize("name", list(_configs()))
def test_reference_matches_port(name, cpu):
    from repro_torch.models import RECSYS_MODELS

    cfg, family, cls = _configs()[name]
    sizes = sizes_of(cfg, family)
    ref = {"dlrm": dlrm, "widedeep": widedeep}[family]
    with torch.no_grad():
        params = ref.draw_params(sizes, gen.generator(4, cpu), cpu)
    batch = gen.draw_batch(sizes, TRAFFIC, 64, gen.generator(5, cpu), cpu)
    model = getattr(RECSYS_MODELS[cfg.interaction], cls)(cfg, params)
    with torch.inference_mode():
        got = model(batch).float()
        want = ref.scores(params, batch, sizes, "float32")
    assert got.shape == want.shape
    scale = want.abs().max()
    # float32 models: the same products in another order; bfloat16: the
    # port rounds every layer to bfloat16, the reference does not
    tol = 2e-2 if cfg.dtype == torch.bfloat16 else 1e-5
    assert float((got - want).abs().max() / scale) < tol


def test_port_takes_the_drawn_tensors(cpu):
    """The model is built on the benchmark's weights, not a copy."""
    from repro_torch.configs import dlrm_rm2
    from repro_torch.models.dlrm import DLRM

    sizes = sizes_of(dlrm_rm2.SMOKE, "dlrm")
    with torch.no_grad():
        params = dlrm.draw_params(sizes, gen.generator(1, cpu), cpu)
    model = DLRM(dlrm_rm2.SMOKE, params)
    assert model.table.data_ptr() == params["embedding"]["table"].data_ptr()


def test_draw_scales(cpu):
    sizes = {"vocab_sizes": [10000, 400], "pooling": [1, 1], "row_pad": 512,
             "table_dtype": "float32"}
    t = common.draw_table(sizes, 8, gen.generator(2, cpu), cpu)
    assert t.shape == (10752, 8)
    assert float(t[:10000].abs().max()) <= 0.01
    assert float(t[10000:10400].abs().max()) <= 0.05
    assert float(t[10400:].abs().max()) > 0.5          # padding U(-1, 1)


def test_precisions_round_as_stated():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-12, -3.0 - 2**-14])
    assert torch.equal(common._round_tf32(x),
                       torch.tensor([1.0, 1.0 + 2**-10, -3.0]))
    y = torch.linspace(-1, 1, 101)
    q = common.rounded(y, "fp8")
    assert 0 < float((q - y).abs().max()) <= 2**-4
    assert torch.equal(common.rounded(y, "float32"), y)


@pytest.mark.parametrize("path", sorted(REF_DIR.glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "contextlib", "math", "torch", "bench"}
