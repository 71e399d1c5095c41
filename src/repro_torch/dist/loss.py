"""Cross entropy and mixed-precision gradient casting, single device.

Counterpart of ``repro.dist.loss``.  The reference writes the gold-logit
selection as a one-hot contraction so that vocab-sharded logits stay
sharded; on one device the vocabulary is whole, so the gold logit is a
``gather``: the same value, without a float32 [..., V] one-hot (2.10 GB a
sequence at llama3.2-3b's train_4k).  The vocab-parallel form comes with
the ``torch.distributed`` layer.
"""
from __future__ import annotations

import torch


def ce_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Token-mean cross entropy.  logits: [..., V] (any leading dims),
    targets: the matching integer tensor.  Computed in float32 whatever
    the logits' dtype, with a stable log-sum-exp (the max held constant,
    as the reference's ``stop_gradient`` does)."""
    x = logits.float()
    m = x.amax(dim=-1, keepdim=True).detach()
    logz = m.squeeze(-1) + torch.log(torch.exp(x - m).sum(dim=-1))
    gold = x.gather(-1, targets.long()[..., None]).squeeze(-1)
    return (logz - gold).mean()


def cast_grad(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32 for the loss, its gradient back in ``x``'s dtype
    (the reference's custom-vjp cast): ``Tensor.float()``'s backward
    already returns the gradient in the input's dtype, so bf16 gradients
    flow back through the model."""
    return x.float()
