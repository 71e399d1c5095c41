"""Known-bad corpus for the port's determinism pass (parsed, never run).

The fixture path contains ``analysis_fixtures``, which is inside the
pass's simulated-path scope (and its port scope) by construction.
"""
import random
import time

import numpy as np
import torch
from torch import nn


def unseeded_draws(n):
    a = np.random.rand(n)  # expect: determinism-global-rng
    random.shuffle(a)  # expect: determinism-stdlib-random
    return a, time.perf_counter()  # expect: determinism-wall-clock


def set_order_leak(ids):
    return [i for i in set(ids)]  # expect: determinism-set-order


def torch_global_stream(shape, w):
    torch.manual_seed(0)  # expect: determinism-torch-global-rng
    x = torch.randn(*shape)  # expect: determinism-torch-global-rng
    w.uniform_(-1.0, 1.0)  # expect: determinism-torch-global-rng
    nn.init.xavier_uniform_(w)  # expect: determinism-torch-global-rng
    perm = torch.randperm(shape[0], device=x.device)  # expect: determinism-torch-global-rng
    torch.cuda.manual_seed_all(1)  # expect: determinism-torch-global-rng
    return x[perm]
