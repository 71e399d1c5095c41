"""Suppression-handling corpus for the port's passes: every finding here
carries a repro-ignore comment (the reference's syntax) and must land in
the suppressed list, except where the comment names another rule.

An expect-suppressed marker names what each line suppresses (asserted by
tests/test_torch_analysis.py).
"""
import numpy as np
import torch


def planted(n):
    a = np.random.rand(n)  # repro: ignore[determinism-global-rng]  # expect-suppressed: determinism-global-rng
    b = torch.randn(n)  # repro: ignore  # expect-suppressed: determinism-torch-global-rng
    c = torch.rand(n); d = np.random.rand(n)  # repro: ignore[determinism-torch-global-rng, determinism-global-rng]  # expect-suppressed: determinism-torch-global-rng, determinism-global-rng
    e = torch.rand(n)  # repro: ignore[determinism-wall-clock]  # expect: determinism-torch-global-rng
    return a, b, c, d, e


class Logged(torch.nn.Module):
    def forward(self, x):
        return x.sum().item()  # repro: ignore[step-purity-host-sync] the caller logs it once  # expect-suppressed: step-purity-host-sync
