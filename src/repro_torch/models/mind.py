"""MIND — Multi-Interest Network with Dynamic routing (arXiv:1904.08030).

Counterpart of ``repro.models.mind``.  History item embeddings are routed
into K interest capsules by B2I dynamic routing (behaviour to interest);
serving scores a candidate item against the interest that responds most
(label-aware attention, a hard max at serving, as in the paper).  The
retrieval form scores one user's K interests against N candidate items
with one ``[K, D] x [D, N]`` product.

Item rows come from ``embedding.feature_rows`` (the quotient-remainder rule
for a QR item table, where the reference adds ``row_offsets[0]`` to the
raw id).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.common.convert import tree_from_numpy
from repro_torch.common.init import normal_init
from repro_torch.models import embedding as emb_lib
from repro_torch.models.din import item_rows
from repro_torch.models.layers import MLP, apply_mlp, init_mlp
from repro_torch.models.recsys_base import RecsysConfig


def squash(x: torch.Tensor, dim: int = -1, eps: float = 1e-9) -> torch.Tensor:
    n2 = x.square().sum(dim=dim, keepdim=True)
    return (n2 / (1.0 + n2)) * x / torch.sqrt(n2 + eps)


def interest_capsules(params, history_ids: torch.Tensor, cfg: RecsysConfig
                      ) -> torch.Tensor:
    """[B, T] history -> [B, K, D] interest capsules by dynamic routing."""
    mask = history_ids >= 0                                    # [B, T]
    e = item_rows(params["embedding"]["table"], history_ids, cfg)  # [B, T, D]
    e = e * mask[..., None].to(e.dtype)
    u = e @ params["S"]                                  # behaviour -> routing space
    B, T, D = u.shape
    K = cfg.n_interests
    # the routing logits b are fixed (not trained) and start at zero
    b = u.new_zeros((B, T, K))
    caps = u.new_zeros((B, K, D))
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(torch.where(mask[..., None], b, -1e30), dim=1)  # over T
        caps = squash(torch.einsum("btk,btd->bkd", w, u))
        b = b + torch.einsum("bkd,btd->btk", caps, u)
    # the head MLP, applied to each capsule
    return apply_mlp(params["head"], caps.reshape(B * K, D)).reshape(B, K, D)


def apply(params, batch, cfg: RecsysConfig) -> torch.Tensor:
    """Ranking form: one target a user -> [B] logits."""
    caps = interest_capsules(params, batch["history_ids"], cfg)   # [B, K, D]
    target = item_rows(params["embedding"]["table"], batch["target_id"], cfg)
    scores = torch.einsum("bkd,bd->bk", caps, target)
    return scores.amax(dim=-1)  # label-aware hard attention at serving


def retrieval_scores(params, batch, candidate_ids: torch.Tensor,
                     cfg: RecsysConfig) -> torch.Tensor:
    """Retrieval form: [B] users x [N] candidates -> [B, N] scores."""
    caps = interest_capsules(params, batch["history_ids"], cfg)   # [B, K, D]
    cand = item_rows(params["embedding"]["table"], candidate_ids, cfg)  # [N, D]
    scores = torch.einsum("bkd,nd->bkn", caps, cand)
    return scores.amax(dim=1)                                     # [B, N]


class MIND(nn.Module):
    """MIND holding the reference's parameter pytree."""

    def __init__(self, cfg: RecsysConfig, params):
        super().__init__()
        self.cfg = cfg
        self.table = nn.Parameter(params["embedding"]["table"])
        # the shared routing map S trains (the routing logits b do not)
        self.S = nn.Parameter(params["S"])
        self.head = MLP(params["head"])

    def tree(self):
        """The parameters as the reference's pytree (the same tensors)."""
        return {"embedding": {"table": self.table}, "S": self.S,
                "head": self.head.layers()}

    def forward(self, batch) -> torch.Tensor:
        return apply(self.tree(), batch, self.cfg)

    def retrieval_scores(self, batch, candidate_ids: torch.Tensor
                         ) -> torch.Tensor:
        return retrieval_scores(self.tree(), batch, candidate_ids, self.cfg)


def init(cfg: RecsysConfig, *, generator: torch.Generator,
         device: torch.device,
         row_shard: tuple[int, int] | None = None) -> MIND:
    """A MIND with random weights drawn on ``device`` from ``generator`` (the
    reference's init scales). ``row_shard=(i, n)``: only row block i of n
    of the embedding tables (``init_embedding``), a rank's state under a
    row-sharded "model" axis."""
    d = cfg.embed_dim
    return MIND(cfg, {
        "embedding": emb_lib.init_embedding(cfg.embedding, generator=generator,
                                            device=device,
                                            row_shard=row_shard),
        # the shared bilinear routing map S (B2I routing shares one S)
        "S": normal_init((d, d), generator=generator, device=device,
                         stddev=0.05, dtype=cfg.dtype),
        # the per-interest projection head (an FC after the capsules)
        "head": init_mlp((d, 2 * d, d), generator=generator, device=device,
                         dtype=cfg.dtype),
    })


def params_from_reference(tree, *, device: torch.device):
    """The reference ``mind.init`` pytree (numpy leaves) as tensors on
    ``device``, ready for ``MIND(cfg, params)``."""
    return tree_from_numpy(tree, device)
