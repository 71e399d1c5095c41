"""Clean counterpart for the port's determinism pass: zero findings.

Seeded numpy Generators and explicit torch Generators threaded through,
order-normalized sets: the discipline the port follows.
"""
import numpy as np
import torch


def seeded(seed, n, w):
    rng = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, generator=g)
    w.uniform_(-1.0, 1.0, generator=g)
    torch.nn.init.normal_(w, generator=g)
    perm = torch.randperm(n, generator=g)
    return rng.normal(size=n), x[perm]


def normalized_set_use(queries):
    ordered = sorted({q.model for q in queries})
    return ordered, "q7" in {q.qid for q in queries}
