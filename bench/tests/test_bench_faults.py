"""A run with the timed path broken underneath comes out not correct.

Each test skips the look for a card and drives the rest of a run on the
CPU, at the configuration's widths with the tables cut to a few thousand
rows: the weights and pool drawn from the seed, the warm-up, the window,
the check.  The faults are planted in the port's model class, so the
harness sees them only through the answers."""
import pytest
import torch

from bench import harness
from bench.tests.util import small_cell

CELLS = ["rm2.bulk", "mtwnd.bulk", "rm2.retrieval"]


def _stale(forward):
    """A step that returns its state unchanged: the previous step's
    scores."""
    last = {}

    def f(self, batch):
        out = forward(self, batch)
        prev = last.get("out")
        last["out"] = out
        return out if prev is None else prev
    return f


def _half(forward):
    """Half of the batch left out, the mean taken over the rest."""
    def f(self, batch):
        n = batch["sparse_ids"].shape[0]
        part = forward(self, {k: v[: n // 2] for k, v in batch.items()})
        rest = part.float().mean(dim=0, keepdim=True).to(part.dtype)
        return torch.cat([part, rest.expand(n - n // 2, *part.shape[1:])])
    return f


def _altered(forward):
    """An answer altered where it is produced: every 64th item's scores
    moved by the step's largest score."""
    def f(self, batch):
        out = forward(self, batch).clone()
        out[::64] += out.float().abs().max().to(out.dtype)
        return out
    return f


FAULTS = {"stale": _stale, "half_batch": _half, "altered": _altered}


def _run(name, cpu, seed=20240601):
    cell = small_cell(name)
    return harness.run_cell(cell, seed, 1.0, False, cpu)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, cpu):
    out = _run(name, cpu)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert list(out["checks"]) == ["score_gap", "answers_missing"]
    assert out["checks"]["answers_missing"]["value"] == 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, cpu, monkeypatch):
    from repro_torch.models import RECSYS_MODELS

    sizes = harness.load_cell(name).sizes
    cls = getattr(RECSYS_MODELS[sizes["interaction"]], sizes["port_model"])
    monkeypatch.setattr(cls, "forward", FAULTS[fault](cls.forward))
    out = _run(name, cpu)
    assert not out["correct"]
    assert out["failed"] > 0
    gap = out["checks"]["score_gap"]
    assert gap["value"] > gap["limit"]


def test_missing_answer_is_not_correct(cpu, monkeypatch):
    from repro_torch.models.dlrm import DLRM

    forward = DLRM.forward
    monkeypatch.setattr(DLRM, "forward",
                        lambda self, b: forward(self, b)[:, None])
    out = _run("rm2.bulk", cpu)
    assert not out["correct"]
    assert out["checks"]["answers_missing"]["value"] == out["attempted"]
