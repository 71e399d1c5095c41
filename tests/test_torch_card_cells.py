"""``chip_smoke.py``'s registry cells on one card, checked without a card.

(a) Its tables of where each registry cell runs on the card (``CARD_CELLS``
for the phases before ``cells``, ``CELL_CUTS`` for phase ``cells``) and of
the cells no cut puts on one card (``NOT_ON_ONE_CARD``), read by AST, name
every cell of ``repro_torch.configs.registry`` exactly once.  (b) Each LM
cut of ``CELL_CUTS`` is the deepest the dry run (``dryrun.trace_cell`` of
the cut on ``meta``) keeps within ``CUT_BUDGET``: its peak within, one
layer more past it.  (c) Each ``NOT_ON_ONE_CARD`` cell's one-device peak
at one layer and batch 1 is past the 80 GB card.  (d) At SMOKE widths on
the CPU, the bulk cells' row-block check (``held_rows``,
``row_block_check``) is the whole-batch comparison on those rows, and a
one-row fault fails it where it checks and not elsewhere.  (e) The bulk
cells' blocked click-log draw (``cell_batch_blocks``) is ``cell_batch``
of each block's rows from the block's seed, and the same on one thread
as on DRAW_WORKERS.  (f) ``common.init`` draws a leaf of another dtype than
float32 into the finished tensor in chunks (so a cell's largest leaves
find room on the card): the same numbers on the CPU as one float32 draw
cast, whatever the chunk.

Imports neither jax nor the reference."""
import ast
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.common import init
from repro_torch.configs.registry import get_arch, list_archs
from repro_torch.data import clicklog
from repro_torch.data.clicklog import cell_batch, cell_batch_blocks
from repro_torch.launch import dryrun
from repro_torch.launch.steps import build_cell

ROOT = Path(__file__).resolve().parents[1]
REGISTRY = [(a, s.name) for a in list_archs() for s in get_arch(a).SHAPES]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_module", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP = _chip_smoke()


def _tables() -> dict:
    """CARD_CELLS, CELL_CUTS and NOT_ON_ONE_CARD as the file writes them."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                getattr(node.targets[0], "id", None) in (
                    "CARD_CELLS", "CELL_CUTS", "NOT_ON_ONE_CARD"):
            out[node.targets[0].id] = ast.literal_eval(node.value)
    return out


def _named() -> list:
    t = _tables()
    return [tuple(c) for cells in t["CARD_CELLS"].values() for c in cells] \
        + list(t["CELL_CUTS"]) + list(t["NOT_ON_ONE_CARD"])


def test_tables_name_only_registry_cells():
    assert len(REGISTRY) == 40
    assert set(_named()) <= set(REGISTRY)


@pytest.mark.parametrize("cell", REGISTRY, ids=lambda c: f"{c[0]}-{c[1]}")
def test_every_registry_cell_named_once(cell):
    assert _named().count(cell) == 1


def _peak(arch: str, shape: str, **cut) -> int:
    return dryrun.trace_cell(build_cell(arch, shape, "meta", **cut))[
        "memory"]["peak_memory_bytes"]


LM_CUTS = [(a, s, cut) for (a, s), cut in _tables()["CELL_CUTS"].items()
           if s in ("long_500k", "train_4k")]


@pytest.mark.parametrize("arch,shape,cut", LM_CUTS,
                         ids=[f"{a}-{s}" for a, s, _ in LM_CUTS])
def test_lm_cut_is_the_deepest_within_budget(arch, shape, cut):
    budget = CHIP.CUT_BUDGET[shape]
    assert _peak(arch, shape, **cut) <= budget
    full = get_arch(arch).FULL.n_layers
    depth = cut.get("n_layers", full)
    if depth < full:
        assert _peak(arch, shape, **{**cut, "n_layers": depth + 1}) > budget


@pytest.mark.parametrize("cell", list(_tables()["NOT_ON_ONE_CARD"]),
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_not_on_one_card_past_80gb(cell):
    arch, shape = cell
    assert _peak(arch, shape, batch=1, n_layers=1) > CHIP.CARD_BYTES


BULK = [(a, s) for (a, s) in _tables()["CELL_CUTS"]
        if s in ("serve_bulk", "retrieval_cand")]
# rows of a block of the blocked draw at SMOKE (batches of 16 and 128
# rows: several blocks, the last one short)
BLOCK_ROWS = 5


@pytest.mark.parametrize("arch,shape", BULK,
                         ids=[f"{a}-{s}" for a, s in BULK])
def test_row_block_check_is_the_whole_batch_check(arch, shape, monkeypatch):
    monkeypatch.setattr(CHIP, "CHECK_BLOCK", 4)
    cpu = torch.device("cpu")
    cell = build_cell(arch, shape, cpu)
    assert CHIP.bulk_batch(cell)
    model = cell.init_state(torch.Generator().manual_seed(1))
    batch_np = cell_batch_blocks(cell.cfg, cell.batch_specs, 11, BLOCK_ROWS)
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    scores = cell.run(model, batch)["scores"]
    k1 = cell.cfg.interaction in ("dot", "concat")
    with CHIP.plain_k1():
        whole = cell.run(CHIP.cpu_copy(model), batch)["scores"].float()
    rows = CHIP.checked_candidates(cell.batch, seed=12)
    unchecked = np.setdiff1d(np.arange(cell.batch), rows)
    assert 0 < len(rows) and len(unchecked)
    want, against = CHIP.held_rows(cell, model, batch_np, rows, cpu, k1)
    assert against == ("K1's plain version" if k1 else "the CPU copy")
    # the rows alone give the whole batch's reference on them
    np.testing.assert_allclose(want.numpy(), whole[rows].numpy(), rtol=1e-6,
                               atol=1e-6 * float(whole.abs().max()))
    tol = CHIP.LOGIT_TOL
    err = CHIP.row_block_check("rows", scores, rows, want, tol)
    assert err == pytest.approx(CHIP.check(
        "whole", scores.float()[rows], whole[rows], tol),
        abs=1e-6 * float(whole.abs().max()))
    bad = scores.clone()
    bad[int(rows[0])] += 1.0
    with pytest.raises(AssertionError, match="past"):
        CHIP.row_block_check("rows", bad, rows, want, tol)
    elsewhere = scores.clone()
    elsewhere[int(unchecked[0])] += 1.0
    CHIP.row_block_check("rows", elsewhere, rows, want, tol)
    with pytest.raises(AssertionError):
        CHIP.check("whole", elsewhere.float(), whole, tol)


@pytest.mark.parametrize("arch,shape", BULK,
                         ids=[f"{a}-{s}" for a, s in BULK])
def test_block_draw_is_cell_batch_per_block(arch, shape, monkeypatch):
    cell = build_cell(arch, shape, torch.device("cpu"))
    specs = cell.batch_specs
    n = cell.batch
    assert n % BLOCK_ROWS and n > 2 * BLOCK_ROWS
    got = cell_batch_blocks(cell.cfg, specs, 11, BLOCK_ROWS)
    assert set(got) == set(specs)
    for k, v in got.items():
        assert v.shape == tuple(specs[k].shape)
    for i, lo in enumerate(range(0, n, BLOCK_ROWS)):
        rows = min(BLOCK_ROWS, n - lo)
        sub = {k: np.zeros((rows, *v.shape[1:])) for k, v in specs.items()}
        want = cell_batch(cell.cfg, sub, seed=(11, i))
        for k in specs:
            np.testing.assert_array_equal(got[k][lo:lo + rows], want[k])
    monkeypatch.setattr(clicklog, "DRAW_WORKERS", 1)
    one = cell_batch_blocks(cell.cfg, specs, 11, BLOCK_ROWS)
    for k in specs:
        np.testing.assert_array_equal(one[k], got[k])
    # another seed draws other rows
    other = cell_batch_blocks(cell.cfg, specs, 12, BLOCK_ROWS)
    assert any(not np.array_equal(other[k], got[k]) for k in specs)


@pytest.mark.parametrize("chunk", [16, 64, init.DRAW_CHUNK])
@pytest.mark.parametrize("shape", [(5,), (17,), (1000,), (3, 5, 7),
                                   (4, 64, 33), (2, 3, 100)],
                         ids=lambda s: "x".join(map(str, s)))
def test_chunked_init_is_one_draw(shape, chunk, monkeypatch):
    monkeypatch.setattr(init, "DRAW_CHUNK", chunk)
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for fn, draw in (
                (lambda g: init.normal_init(shape, generator=g, device="cpu",
                                            stddev=0.02, dtype=dtype),
                 lambda x, g: x.normal_(0.0, 0.02, generator=g)),
                (lambda g: init.uniform_init(shape, 0.5, generator=g,
                                             device="cpu", dtype=dtype),
                 lambda x, g: x.uniform_(-0.5, 0.5, generator=g))):
            got = fn(torch.Generator().manual_seed(3))
            want = draw(torch.empty(shape), torch.Generator().manual_seed(3))
            assert got.dtype == dtype and got.shape == shape
            assert torch.equal(got, want.to(dtype))
