"""The comparison that decides ``correct``.

Every step of the window scored one pool batch and copied its scores to
the host, which kept the answers of a sample of the batch's rows drawn
from the seed (the same rows whenever that batch comes round).  After the
window the plain reference scores those rows of each pool batch that a
step used, in float32 with TF32 off, on the same weights and inputs.  A
step's gap is the largest distance between one of its answers and the
reference's score of the same item, over the largest reference score of
the sample in magnitude:

    gap = max |score - ref| / max |ref|

The run is correct when every step answered with the batch's shape and
the largest gap stays within the configuration's ``score_gap_limit``.  A
step whose answer is missing, of another shape, not finite, or past the
limit counts as failed.  The control (``control_gap``) puts the reference,
computed in the configuration's ``control`` precision, in the program's
place; it has to fail the limit.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from bench.reference import common

# bytes of float32 gathered rows a reference block may hold
REF_BLOCK_BYTES = 1 << 30


@dataclasses.dataclass
class Verdict:
    correct: bool
    failed: int
    checks: dict


def _take_rows(batch: dict, idx: torch.Tensor) -> dict:
    return {k: v[idx] for k, v in batch.items()}


def reference_scores(ref, params, batch: dict, rows: torch.Tensor,
                     sizes: dict, precision: str = "float32", *,
                     take=None) -> torch.Tensor:
    """The reference's scores of a batch's ``rows``, in blocks of rows, as
    a float32 tensor on the host.  ``take(batch, idx)`` gives the batch of
    items ``idx`` alone (the traffic loop's; else every tensor of the
    batch indexed by them), and the reference's ``item_bytes(sizes)`` the
    bytes an item holds in ``scores`` (else ``common.gather_bytes``)."""
    take = take or _take_rows
    device = next(v.device for v in batch.values()
                  if isinstance(v, torch.Tensor))
    idx = rows.to(device)
    per_item = (ref.item_bytes(sizes) if hasattr(ref, "item_bytes")
                else common.gather_bytes(sizes, sizes["embed_dim"]))
    block = max(1, REF_BLOCK_BYTES // per_item)
    out = []
    with torch.inference_mode(), common.precision_context(precision):
        for r0 in range(0, len(idx), block):
            part = take(batch, idx[r0:r0 + block])
            out.append(ref.scores(params, part, sizes, precision).cpu())
    return torch.cat(out)


def _gap(answer, want: torch.Tensor, scale: float) -> float:
    """A step's gap; infinite for an answer of another shape or not
    finite."""
    if not isinstance(answer, torch.Tensor) or answer.shape != want.shape:
        return math.inf
    d = (answer.float() - want).abs()
    d = torch.nan_to_num(d, nan=math.inf)
    return float(d.max()) / scale if d.numel() else 0.0


def compare(ref, params, pool: list[dict], sizes: dict, answers, *,
            take=None) -> Verdict:
    """Every step's kept answers (``answers.which[k]`` the pool batch of
    step k, ``answers.answer(k)`` the scores of that batch's
    ``answers.rows[j]``) against the reference's scores of those rows."""
    limit = sizes["score_gap_limit"]
    which = answers.which
    gaps = [math.inf] * len(which)
    for j in sorted(set(which)):
        want = reference_scores(ref, params, pool[j], answers.rows[j], sizes,
                                take=take)
        scale = max(float(want.abs().max()), 1e-30)
        for k, w in enumerate(which):
            if w == j:
                gaps[k] = _gap(answers.answer(k), want, scale)
    bad_shape = sum(1 for g in gaps if math.isinf(g))
    failed = sum(1 for g in gaps if not g <= limit)
    gap = max(gaps) if gaps else math.inf
    checks = {
        "score_gap": {"value": gap, "limit": limit},
        "answers_missing": {"value": bad_shape, "limit": 0},
    }
    correct = bool(gaps) and failed == 0
    return Verdict(correct=correct, failed=failed, checks=checks)


class _Kept:
    """Answers given whole, one a pool batch (the control's)."""

    def __init__(self, rows, answers):
        self.rows = rows
        self.which = list(range(len(answers)))
        self._answers = answers

    def answer(self, k: int) -> torch.Tensor:
        return self._answers[k]


def control_gap(ref, params, pool: list[dict], sizes: dict,
                rows: list[torch.Tensor], *, take=None) -> Verdict:
    """The control: the reference in the configuration's ``control``
    precision, in the program's place, once a pool batch."""
    answers = [reference_scores(ref, params, b, r, sizes, sizes["control"],
                                take=take)
               for b, r in zip(pool, rows)]
    return compare(ref, params, pool, sizes, _Kept(rows, answers), take=take)
