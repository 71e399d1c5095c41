"""Wide & Deep (arXiv:1606.07792) and MT-WnD (multi-task, arXiv RecSys'19).

Counterpart of ``repro.models.widedeep``.  Wide: a generalized linear part
over the sparse features (dim-1 embedding bags, i.e. one scalar weight a
id) plus the dense features.  Deep: the concatenated embeddings and dense
features through an MLP.  MT-WnD (``cfg.n_tasks > 1``): N task towers,
each its own predict MLP (the paper's "N x (1024-512-256)" Predict-FC).

``apply_sparse`` (the paper's `G_s`) pools both tables through kernel K1's
per-feature entry, two launches a batch: the deep ``[B, F, D]`` table and
the wide ``[B, F, 1]`` one.  Parameters follow the reference's pytree
(``{"embedding": {"table"}, "wide": {"table"}, "wide_dense", "deep_mlp",
"towers"}``), so ``params_from_reference`` carries reference weights
across unchanged.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.common.convert import tree_from_numpy
from repro_torch.models import embedding as emb_lib
from repro_torch.models.embedding import EmbeddingConfig
from repro_torch.models.layers import MLP, init_mlp
from repro_torch.models.recsys_base import RecsysConfig


def _wide_cfg(cfg: RecsysConfig) -> EmbeddingConfig:
    """Dim-1 clone of the embedding config for the wide (linear) part."""
    return dataclasses.replace(cfg.embedding, dim=1)


class WideDeep(nn.Module):
    """Wide & Deep / MT-WnD holding the reference's parameter pytree."""

    def __init__(self, cfg: RecsysConfig, params):
        super().__init__()
        self.cfg = cfg
        self.wide_cfg = _wide_cfg(cfg)
        self.table = nn.Parameter(params["embedding"]["table"])
        self.wide = nn.Parameter(params["wide"]["table"])
        self.wide_dense = (nn.Parameter(params["wide_dense"])
                           if cfg.n_dense else None)
        self.deep_mlp = MLP(params["deep_mlp"])
        self.towers = nn.ModuleList(MLP(t) for t in params["towers"])

    def tree(self):
        """The parameters as the reference's pytree (the same tensors):
        ``wide`` is the reference's ``wide/table``."""
        tree = {"embedding": {"table": self.table},
                "wide": {"table": self.wide}}
        if self.cfg.n_dense:
            tree["wide_dense"] = self.wide_dense
        tree["deep_mlp"] = self.deep_mlp.layers()
        tree["towers"] = [t.layers() for t in self.towers]
        return tree

    def apply_sparse(self, batch) -> tuple[torch.Tensor, torch.Tensor]:
        """G_s: deep embeddings [B, F, D] and wide scalar sums [B, F, 1]."""
        ids = batch["sparse_ids"]
        deep = emb_lib.embedding_bag_local({"table": self.table}, ids,
                                           self.cfg.embedding)
        wide = emb_lib.embedding_bag_local({"table": self.wide}, ids,
                                           self.wide_cfg)
        return deep, wide

    def apply_dense_given_pooled(self, batch, pooled) -> torch.Tensor:
        """G_d: logits [B] (one task) or [B, n_tasks]."""
        cfg = self.cfg
        deep_emb, wide_emb = pooled
        deep_in = deep_emb.reshape(deep_emb.shape[0], -1)
        wide_logit = wide_emb.sum(dim=(1, 2))
        if cfg.n_dense:
            dense = batch["dense"].to(cfg.dtype)
            deep_in = torch.cat([deep_in, dense], dim=-1)
            wide_logit = wide_logit + dense @ self.wide_dense
        hidden = self.deep_mlp(deep_in, final_activation="relu")
        logits = torch.stack([t(hidden)[:, 0] for t in self.towers], dim=-1)
        logits = logits + wide_logit[:, None]
        return logits[:, 0] if cfg.n_tasks == 1 else logits

    def forward(self, batch) -> torch.Tensor:
        return self.apply_dense_given_pooled(batch, self.apply_sparse(batch))


def init(cfg: RecsysConfig, *, generator: torch.Generator,
         device: torch.device) -> WideDeep:
    """A Wide & Deep with random weights drawn on ``device`` from
    ``generator`` (the reference's init scales; ``jax.random``'s numbers
    differ)."""
    emb = cfg.embedding
    params = {
        "embedding": emb_lib.init_embedding(emb, generator=generator,
                                            device=device),
        "wide": emb_lib.init_embedding(_wide_cfg(cfg), generator=generator,
                                       device=device),
    }
    if cfg.n_dense:
        params["wide_dense"] = torch.zeros((cfg.n_dense,), dtype=cfg.dtype,
                                           device=device)
    deep_in = emb.num_features * emb.dim + cfg.n_dense
    params["deep_mlp"] = init_mlp((deep_in, *cfg.top_mlp), generator=generator,
                                  device=device, dtype=cfg.dtype)
    params["towers"] = [
        init_mlp((cfg.top_mlp[-1], 1), generator=generator, device=device,
                 dtype=cfg.dtype)
        for _ in range(cfg.n_tasks)]
    return WideDeep(cfg, params)


def params_from_reference(tree, *, device: torch.device):
    """The reference ``widedeep.init`` pytree (numpy leaves) as tensors on
    ``device``, ready for ``WideDeep(cfg, params)``."""
    return tree_from_numpy(tree, device)
