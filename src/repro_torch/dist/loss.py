"""Cross entropy (vocab-parallel under a binding) and mixed-precision
gradient casting.

Counterpart of ``repro.dist.loss``.  On one device the vocabulary is whole
and the gold logit is a ``gather``: the reference's one-hot contraction's
value, without a float32 [..., V] one-hot (2.10 GB a sequence at
llama3.2-3b's train_4k).

With "vocab" bound (the lm_head column-sharded) the logits' last dimension
is this rank's slice [v0, v1) of the vocabulary, and the reference's
GSPMD-inserted psums become the Megatron vocab-parallel loss written out:
the local max and an ``all_reduce`` MAX, the local sum of ``exp(x - m)``
and an ``all_reduce`` SUM, the gold logit gathered where the target falls
in [v0, v1) (0 elsewhere) and an ``all_reduce`` SUM.  With "batch" bound
(either way) the token mean is over every data rank's tokens: the local
sum over the global count, summed over the batch group.  Everything is float32, and no
[.., V] tensor is ever gathered.
"""
from __future__ import annotations

import torch

from repro_torch.dist import collectives, logical


def ce_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Token-mean cross entropy.  logits: [..., V] (any leading dims; V
    this rank's vocabulary slice when "vocab" is bound), targets: the
    matching integer tensor of global ids.  Computed in float32 whatever
    the logits' dtype, with a stable log-sum-exp (the max held constant,
    as the reference's ``stop_gradient`` does)."""
    x = logits.float()
    vocab_axes = logical.bound_axes("vocab")
    if not vocab_axes:
        m = x.amax(dim=-1, keepdim=True).detach()
        logz = m.squeeze(-1) + torch.log(torch.exp(x - m).sum(dim=-1))
        gold = x.gather(-1, targets.long()[..., None]).squeeze(-1)
        batch_axes = logical.bound_axes("batch") if x.dim() >= 2 else ()
        return collectives.block_mean((logz - gold).mean(), batch_axes)
    mesh = logical.current_mesh()
    group = logical.group(vocab_axes)
    v_local = x.shape[-1]
    v0 = logical.shard_index(mesh, vocab_axes) * v_local
    m = collectives.all_reduce(x.detach().amax(dim=-1, keepdim=True), group,
                               op="max")
    sumexp = collectives.all_reduce(torch.exp(x - m).sum(dim=-1), group)
    local = targets.long() - v0
    mine = (local >= 0) & (local < v_local)
    gold = x.gather(-1, local.clamp(0, v_local - 1)[..., None]).squeeze(-1)
    gold = collectives.all_reduce(gold * mine.to(gold.dtype), group)
    per_token = m.squeeze(-1) + torch.log(sumexp) - gold
    batch_axes = logical.bound_axes("batch") if x.dim() >= 2 else ()
    if not batch_axes:
        return per_token.mean()
    total = collectives.all_reduce(per_token.sum().reshape(1),
                                   logical.group(batch_axes))
    return total[0] / (per_token.numel() * logical.shards(batch_axes, mesh))


def cast_grad(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32 for the loss, its gradient back in ``x``'s dtype
    (the reference's custom-vjp cast): ``Tensor.float()``'s backward
    already returns the gradient in the input's dtype, so bf16 gradients
    flow back through the model."""
    return x.float()
