"""End-to-end training on the port: a ~100M-parameter DLRM on the
synthetic click log for a few hundred steps, with fault-tolerant
checkpointing (kill it mid-run and run it again: it resumes from the last
commit).  Port of ``examples/train_dlrm.py``: the same ``dlrm-100m``
config, ``rowwise_adagrad(lr=0.02)``, batch 1024, 300 steps, a checkpoint
every 50.  The batch of step ``s`` is drawn from the seed ``(seed, s)``,
so a resumed run trains on the batches an uninterrupted one does.  On the
card the SparseNet runs K1's per-feature entry and its backward.

Run:  PYTHONPATH=src python -m repro_torch.launch.train_dlrm \\
          [--steps 300] [--batch 1024] [--ckpt-dir DIR] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.common.tree import tree_leaves
from repro_torch.common.types import ShapeSpec, resolve_device
from repro_torch.data.clicklog import ClickLogGenerator
from repro_torch.launch.steps import CellProgram, recsys_train_cell
from repro_torch.models.embedding import EmbeddingConfig
from repro_torch.models.recsys_base import RecsysConfig, batch_to_tensors
from repro_torch.train.trainer import ARTIFACTS, Trainer, TrainerConfig

CKPT_DIR = ARTIFACTS / "repro_dlrm_ckpt"
LR = 0.02  # examples/train_dlrm.py's rowwise AdaGrad


def make_model() -> RecsysConfig:
    """~100M params: dominated by 8 x 400k x 32 embedding tables."""
    return RecsysConfig(
        name="dlrm-100m",
        embedding=EmbeddingConfig(vocab_sizes=(400_000,) * 8, dim=32,
                                  pooling=(16,) * 8),
        n_dense=13,
        bottom_mlp=(256, 128, 32),
        top_mlp=(256, 128),
        interaction="dot",
    )


def train_cell(cfg: RecsysConfig, batch: int, device: torch.device
               ) -> CellProgram:
    """The DLRM's train step as a cell: ``rowwise_adagrad(lr=LR)`` on
    ``binary_ce``, state ``{"model", "opt"}``."""
    return recsys_train_cell(cfg, batch, device, lr=LR, arch_id=cfg.name,
                             shape=ShapeSpec("train", "train",
                                             {"batch": batch}))


def step_batches(cfg: RecsysConfig, batch: int, seed: int,
                 device: torch.device):
    """``batches(start)``: the click-log batches of steps start,
    start + 1, ..., each drawn from the seed ``(seed, step)``."""
    def batches(start: int):
        step = start
        while True:
            yield batch_to_tensors(ClickLogGenerator(
                cfg, seed=[seed, step]).batch(batch), device)
            step += 1
    return batches


def make_trainer(steps: int, batch: int, ckpt_dir, device: torch.device, *,
                 ckpt_every: int = 50, log_every: int = 20, seed: int = 0,
                 cfg: RecsysConfig | None = None) -> Trainer:
    cfg = cfg or make_model()
    cell = train_cell(cfg, batch, device)
    return Trainer(cell.run, cell.init_state,
                   step_batches(cfg, batch, seed, device),
                   TrainerConfig(total_steps=steps, ckpt_every=ckpt_every,
                                 ckpt_dir=str(ckpt_dir), log_every=log_every))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    trainer = make_trainer(args.steps, args.batch, args.ckpt_dir, dev,
                           seed=args.seed)
    state, hist = trainer.run(torch.Generator(dev).manual_seed(args.seed))
    n = sum(t.numel() for t in tree_leaves(state["model"].tree()))
    print(f"model: {n / 1e6:.1f}M parameters on {dev}")
    if not hist:
        print(f"{args.ckpt_dir} already holds step {args.steps}: nothing "
              "to train")
        return 0
    print("step  loss")
    for h in hist:
        print(f"{h['step']:5d}  {h['loss']:.4f}  "
              f"({h['step_time_s'] * 1e3:.0f} ms)")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise AssertionError("loss did not improve")
    print("final loss improved over initial — OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
