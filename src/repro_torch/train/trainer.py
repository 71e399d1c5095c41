"""Fault-tolerant training loop.

Counterpart of ``repro.train.trainer``: a step function wrapped with
periodic checkpoints written in the background, restart from the latest
commit (``resume_or_init``), and a crash hook that tests use to show each
step is done exactly once across a restart.  ``init_state_fn`` takes a
``torch.Generator`` in place of the reference's PRNG key, and ``batches``
is called with the first step to run and gives the batches from there, so
a resumed run sees at each step the batch an uninterrupted run sees.
"""
from __future__ import annotations

import dataclasses
import pathlib
import time
from typing import Callable, Iterator

import torch

from repro_torch.train.checkpoint import CheckpointManager

# where checkpoints go unless a directory is given (git-ignored)
ARTIFACTS = pathlib.Path(__file__).resolve().parents[3] / "artifacts"


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int
    ckpt_every: int = 50
    ckpt_dir: str = str(ARTIFACTS / "repro_ckpt")
    log_every: int = 10
    max_to_keep: int = 3


class Trainer:
    def __init__(self, step_fn: Callable, init_state_fn: Callable,
                 batches: Callable[[int], Iterator], cfg: TrainerConfig):
        self.step_fn = step_fn
        self.init_state_fn = init_state_fn
        self.batches = batches
        self.cfg = cfg
        self.ckpt = CheckpointManager(cfg.ckpt_dir, cfg.max_to_keep)
        self.history: list[dict] = []

    def resume_or_init(self, generator: torch.Generator):
        """A fresh state, restored from the latest commit if there is one;
        and the number of steps it has taken."""
        state = self.init_state_fn(generator)
        latest = self.ckpt.latest_step()
        if latest is None:
            return state, 0
        return self.ckpt.restore(latest, state), latest

    def run(self, generator: torch.Generator, *, crash_at: int | None = None):
        """Train to total_steps; ``crash_at`` simulates a node failure
        before that step (for the fault-tolerance tests).  Returns
        (state, history)."""
        state, start = self.resume_or_init(generator)
        batches = self.batches(start)
        saved = start       # the step whose state is committed (or initial)
        for step in range(start, self.cfg.total_steps):
            if crash_at is not None and step == crash_at:
                self.ckpt.wait()
                raise RuntimeError(f"injected crash at step {step}")
            batch = next(batches)
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            if (step + 1) % self.cfg.log_every == 0 or step == start:
                self.history.append({"step": step + 1, "loss": loss,
                                     "step_time_s": dt})
            if (step + 1) % self.cfg.ckpt_every == 0:
                self.ckpt.save(step + 1, state)
                saved = step + 1
        # the last state, unless the loop just committed it: a second
        # write of one step would rename onto a committed directory
        if saved != self.cfg.total_steps:
            self.ckpt.save(self.cfg.total_steps, state, blocking=True)
        self.ckpt.wait()
        return state, self.history
