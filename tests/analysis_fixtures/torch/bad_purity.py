"""Known-bad corpus for the port's step-purity pass (parsed, never run)."""
import numpy as np
import torch
from torch import nn

from repro_torch.launch.steps import CellProgram


class Tower(nn.Module):
    def forward(self, x, n_items: int):
        print("batch", x.shape)  # expect: step-purity-print
        scale = x.abs().max().item()  # expect: step-purity-host-sync
        if bool(x):  # expect: step-purity-host-sync
            x = x / scale
        return x[:n_items]


class Head(Tower):
    def forward(self, x, w):
        return np.tanh(x) @ w.cpu()  # expect: step-purity-host-numpy, step-purity-host-sync


class _Scale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = float(s)  # expect: step-purity-host-sync
        return x * s

    @staticmethod
    def backward(ctx, grad):
        return grad.tolist(), None  # expect: step-purity-host-sync


def build(cfg):
    def step(model, batch):
        ids = batch["ids"].numpy()  # expect: step-purity-host-sync
        return {"scores": model(ids)}

    return CellProgram(cfg=cfg, step_fn=step,
                       loss_fn=lambda m, b: print(m(b)))  # expect: step-purity-print
