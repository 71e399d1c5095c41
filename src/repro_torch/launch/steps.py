"""Per-(architecture x shape) programs: the LM prefill and decode cells and
the recsys serve cells.

Counterpart of ``repro.launch.steps`` (``build_cell`` / ``CellProgram``) on
one device; training and the GNN cells wait.  The reference's mesh becomes
an explicit device:

- ``device="cpu"`` mirrors the reference's ``mesh=None`` smoke cell: the
  arch's ``SMOKE`` config, for an LM at batch 4 and sequence 32, for a
  recsys arch at batch 16 and 128 candidates;
- ``device="cuda"`` (the default) runs the ``FULL`` config at the shape's
  sizes and, for LM decode, with ``decode_impl="flash"`` (kernel K3), as
  the reference's device-placed cells do.  The batch is the shape's global
  batch unless the caller states a cut with ``batch=``; nothing shrinks it
  silently.

LM decode is one token at ``pos = S - 1`` against an S-long cache passed
in the batch; prefill fills a fresh cache from position 0.  A recsys serve
cell scores its batch (``serve_p99``, ``serve_bulk``); ``retrieval_cand``
scores one user's history against every candidate for DIN and MIND, and
scores the candidates as one bulk batch for the CTR rankers (Wide & Deep,
DLRM).  The recsys ``train_batch`` cell waits for K1's backward.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.common.types import ArchKind, ShapeSpec, TensorSpec, resolve_device
from repro_torch.configs.registry import get_arch
from repro_torch.models import RECSYS_MODELS
from repro_torch.models import transformer as tf_lib
from repro_torch.models.recsys_base import input_specs as recsys_input_specs

SMOKE_BATCH, SMOKE_SEQ = 4, 32  # the reference's mesh=None cut
SMOKE_RECSYS_BATCH, SMOKE_CANDIDATES = 16, 128  # its recsys cut


@dataclasses.dataclass
class CellProgram:
    arch_id: str
    shape: ShapeSpec
    kind: ArchKind
    cfg: Any               # LMConfig or RecsysConfig
    device: torch.device
    batch: int
    seq_len: int
    step_fn: Callable      # step(state, batch) -> outputs
    batch_specs: dict      # TensorSpec tree of the step's batch
    init_fn: Callable      # init(cfg, *, generator, device) -> state

    def init_state(self, generator: torch.Generator):
        """Random parameters on the cell's device (``generator`` lives
        there): the LM's parameter tree, or the recsys model."""
        return self.init_fn(self.cfg, generator=generator, device=self.device)

    def run(self, state, batch):
        with torch.inference_mode():
            return self.step_fn(state, batch)


def _lm_cell(arch, shape: ShapeSpec, device: torch.device,
             batch: int | None) -> CellProgram:
    on_card = device.type == "cuda"
    cfg = arch.FULL if on_card else arch.SMOKE
    B = shape["global_batch"] if on_card else SMOKE_BATCH
    S = shape["seq_len"] if on_card else SMOKE_SEQ
    if batch is not None:
        B = batch

    if shape.step == "prefill":
        batch_specs = {"tokens": TensorSpec((B, S), torch.int32)}

        def step(params, batch):
            cache = tf_lib.init_kv_cache(cfg, B, S, device=device)
            last, new_cache = tf_lib.prefill(params, batch["tokens"], cache, cfg)
            return {"logits": last, "cache": new_cache}

    elif shape.step == "decode":
        if on_card:
            cfg = dataclasses.replace(cfg, decode_impl="flash")
        batch_specs = {"token": TensorSpec((B, 1), torch.int32),
                       "cache": tf_lib.kv_cache_specs(cfg, B, S)}
        pos = S - 1

        def step(params, batch):
            logits, new_cache = tf_lib.decode_step(
                params, batch["token"], batch["cache"], pos, cfg)
            return {"logits": logits, "cache": new_cache}

    else:
        raise NotImplementedError(f"{shape.step} cells are not ported yet")

    return CellProgram(arch_id=arch.ARCH_ID, shape=shape, kind=arch.KIND,
                       cfg=cfg, device=device, batch=B, seq_len=S,
                       step_fn=step, batch_specs=batch_specs,
                       init_fn=tf_lib.init)


def _recsys_cell(arch, shape: ShapeSpec, device: torch.device,
                 batch: int | None) -> CellProgram:
    on_card = device.type == "cuda"
    cfg = arch.FULL if on_card else arch.SMOKE
    if shape.step == "train":
        raise NotImplementedError(
            "recsys train cells wait for K1's backward (the kernel's output "
            "carries no autograd graph)")
    B = shape["batch"] if on_card else SMOKE_RECSYS_BATCH
    n_cand = shape.get("n_candidates", 0)
    if n_cand and not on_card:
        n_cand = SMOKE_CANDIDATES
    if batch is not None:
        if n_cand:
            raise ValueError("retrieval_cand scores one query; it takes no "
                             "batch")
        B = batch

    if n_cand and cfg.interaction in ("target-attn", "multi-interest"):
        B = shape["batch"]  # always 1: the retrieval query
        specs = recsys_input_specs(cfg, B, n_candidates=n_cand)

        def step(model, batch):
            return {"scores": model.retrieval_scores(batch,
                                                     batch["candidate_ids"])}
    else:
        if n_cand:  # CTR rankers score the candidates as one bulk batch
            B = n_cand
        specs = recsys_input_specs(cfg, B)

        def step(model, batch):
            return {"scores": model(batch)}

    return CellProgram(
        arch_id=arch.ARCH_ID, shape=shape, kind=arch.KIND, cfg=cfg,
        device=device, batch=B, seq_len=cfg.seq_len, step_fn=step,
        batch_specs={k: TensorSpec(*v) for k, v in specs.items()},
        init_fn=RECSYS_MODELS[cfg.interaction].init)


def build_cell(arch_id: str, shape_name: str, device: str | torch.device = "cuda",
               *, batch: int | None = None) -> CellProgram:
    """The cell ``shape_name`` of ``arch_id`` on ``device``; ``batch``
    replaces the cell's batch (the cut a card needs)."""
    dev = resolve_device(device)
    arch = get_arch(arch_id)
    shape = next(s for s in arch.SHAPES if s.name == shape_name)
    if arch.KIND == ArchKind.RECSYS:
        return _recsys_cell(arch, shape, dev, batch)
    if arch.KIND not in (ArchKind.LM_DENSE, ArchKind.LM_MOE):
        raise NotImplementedError(f"{arch.KIND.value} cells are not ported yet")
    return _lm_cell(arch, shape, dev, batch)
