"""DLRM family (Facebook, arXiv:1906.00091): RMC1 / RMC2 / RMC3 / dlrm-rm2.

Counterpart of ``repro.models.dlrm``.  Dense features -> Bottom-MLP;
sparse features -> EmbeddingBag (SparseNet, through kernel K1); pairwise
dot-product interaction; Top-MLP -> CTR logit.  ``apply_sparse`` is the
paper's `G_s` and ``apply_dense_given_pooled`` its `G_d`, with the pooled
[B, F, D] tensor between them.

Parameters follow the reference's pytree (``{"embedding": {"table"},
"bottom_mlp": [{"w", "b"}...], "top_mlp": [...]}``, weights [in, out]),
so ``params_from_reference`` carries reference weights across unchanged.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.common import trace
from repro_torch.common.convert import tree_from_numpy
from repro_torch.models import embedding as emb_lib
from repro_torch.models.layers import MLP, init_mlp
from repro_torch.models.recsys_base import RecsysConfig


def _mlp_sizes(cfg: RecsysConfig) -> tuple[tuple[int, ...], tuple[int, ...]]:
    d = cfg.embed_dim
    if cfg.n_dense and cfg.bottom_mlp[-1] != d:
        raise ValueError("bottom MLP must project dense features to embed_dim")
    n_vec = cfg.embedding.num_features + (1 if cfg.n_dense else 0)
    top_in = n_vec * (n_vec - 1) // 2 + (d if cfg.n_dense else 0)
    return (cfg.n_dense, *cfg.bottom_mlp), (top_in, *cfg.top_mlp, 1)


def dot_interaction(vectors: torch.Tensor) -> torch.Tensor:
    """Pairwise dots among n feature vectors: [B, n, D] -> [B, n(n-1)/2],
    pairs in the row-major order of ``jnp.triu_indices(n, k=1)``."""
    n = vectors.shape[1]
    z = torch.bmm(vectors, vectors.transpose(1, 2))
    iu, ju = torch.triu_indices(n, n, offset=1, device=vectors.device)
    return z[:, iu, ju]


class DLRM(nn.Module):
    """A DLRM holding the reference's parameter pytree as module state."""

    def __init__(self, cfg: RecsysConfig, params):
        super().__init__()
        self.cfg = cfg
        self.table = nn.Parameter(params["embedding"]["table"])
        self.bottom_mlp = MLP(params["bottom_mlp"]) if cfg.n_dense else None
        self.top_mlp = MLP(params["top_mlp"])

    def tree(self):
        """The parameters as the reference's pytree (the same tensors)."""
        tree = {"embedding": {"table": self.table}}
        if self.cfg.n_dense:
            tree["bottom_mlp"] = self.bottom_mlp.layers()
        tree["top_mlp"] = self.top_mlp.layers()
        return tree

    def apply_sparse(self, batch) -> torch.Tensor:
        """G_s: the SparseNet — multi-hot EmbeddingBag -> pooled [B, F, D]."""
        with trace.span("sparse"):
            return emb_lib.embedding_bag(
                {"table": self.table}, batch["sparse_ids"],
                self.cfg.embedding)

    def apply_dense_given_pooled(self, batch, pooled: torch.Tensor
                                 ) -> torch.Tensor:
        """G_d: DenseNet given pooled embeddings [B, F, D] -> logit [B]."""
        cfg = self.cfg
        with trace.span("dense"):
            feats = [pooled]
            if cfg.n_dense:
                dense_v = self.bottom_mlp(batch["dense"].to(cfg.dtype),
                                          final_activation="relu")
                feats.insert(0, dense_v[:, None, :])
            vectors = torch.cat(feats, dim=1)  # [B, n_vec, D]
            inter = dot_interaction(vectors)
            top_in = (torch.cat([dense_v, inter], dim=-1) if cfg.n_dense
                      else inter)
            return self.top_mlp(top_in)[:, 0]

    def forward(self, batch) -> torch.Tensor:
        with trace.span("model"):
            return self.apply_dense_given_pooled(batch,
                                                 self.apply_sparse(batch))


def init(cfg: RecsysConfig, *, generator: torch.Generator,
         device: torch.device,
         row_shard: tuple[int, int] | None = None) -> DLRM:
    """A DLRM with random weights drawn on ``device`` from ``generator`` (the
    reference's init scales; ``jax.random``'s numbers differ).
    ``row_shard=(i, n)``: only row block i of n of the embedding tables
    (``init_embedding``), a rank's state under a row-sharded "model" axis."""
    bottom, top = _mlp_sizes(cfg)
    params = {"embedding": emb_lib.init_embedding(
        cfg.embedding, generator=generator, device=device,
        row_shard=row_shard)}
    if cfg.n_dense:
        params["bottom_mlp"] = init_mlp(bottom, generator=generator,
                                        device=device, dtype=cfg.dtype)
    params["top_mlp"] = init_mlp(top, generator=generator, device=device,
                                 dtype=cfg.dtype)
    return DLRM(cfg, params)


def params_from_reference(tree, *, device: torch.device):
    """The reference ``dlrm.init`` pytree (leaves as numpy arrays, or
    anything ``np.asarray`` takes) as the same pytree of tensors on
    ``device``, ready for ``DLRM(cfg, params)``."""
    return tree_from_numpy(tree, device)
