"""DIN (arXiv:1706.06978) and DIEN (arXiv:1809.03672).

Counterpart of ``repro.models.din``.  Embedding layout of the
behaviour-sequence models: feature 0 of the EmbeddingConfig is the ITEM
table (shared by ``history_ids`` and ``target_id``); features 1..F-1 are
1-hot profile/context tables looked up through ``batch["profile_ids"]``
[B, F-1].

DIN: a local activation unit, an MLP over ``[e_h, e_t, e_h - e_t, e_h *
e_t]`` per history item, weighs the history embeddings; their weighted sum
is the user's interest vector.

DIEN (``cfg.use_gru``): an interest-extractor GRU over the history, then an
AUGRU (the attention scales the update gate) driven by DIN's scores.  The
reference's ``lax.scan`` over T is a Python loop over T here.  Its cell is
the reference's, ``hh = tanh(x Wx + (r*h) Wh + b)`` and ``h' = (1-z) h +
z hh``, not ``nn.GRU``'s (which puts r outside the product and swaps the
roles of z), so it is written out.

Item and profile rows come from ``embedding.feature_rows``: a QR item table
(``din(True)``: 600 M ids in 74,692 stored rows) is looked up by the
quotient-remainder rule.  The reference adds ``row_offsets[0]`` to the raw
item id there, which reads other features' rows and past the table.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.common.convert import tree_from_numpy
from repro_torch.common.init import normal_init
from repro_torch.models import embedding as emb_lib
from repro_torch.models.layers import MLP, apply_mlp, init_mlp
from repro_torch.models.recsys_base import RecsysConfig

# Candidates scored at once by ``retrieval_scores``: the attention unit's
# activations are [chunk, T, 4D] and wider, about 3 GB at T = 100 and D = 18
# (1,000,000 candidates at once would need ~80 GB).  Each candidate's score
# is independent of the others, so the chunks give the scores of the whole.
RETRIEVAL_CHUNK = 32768


def item_rows(table: torch.Tensor, ids: torch.Tensor, cfg: RecsysConfig
              ) -> torch.Tensor:
    """Rows of the item table (feature 0) for ids of any shape; -1-padded
    ids read the feature's row 0 (the caller masks them)."""
    return emb_lib.feature_rows(table, ids, 0, cfg.embedding)


def profile_lookup(table: torch.Tensor, profile_ids: torch.Tensor,
                   cfg: RecsysConfig) -> torch.Tensor:
    """1-hot lookups of features 1..F-1 -> [B, (F-1)*D]."""
    return torch.cat([
        emb_lib.feature_rows(table, profile_ids[:, f - 1], f, cfg.embedding)
        for f in range(1, cfg.embedding.num_features)], dim=-1)


def attention_scores(params, hist_emb: torch.Tensor, target_emb: torch.Tensor,
                     mask: torch.Tensor, cfg: RecsysConfig) -> torch.Tensor:
    """DIN local activation unit -> [B, T] weights (not normalized, as in
    the paper; masked positions get zero weight)."""
    B, T, d = hist_emb.shape
    t = target_emb[:, None, :].expand(B, T, d)
    feat = torch.cat([hist_emb, t, hist_emb - t, hist_emb * t], dim=-1)
    logit = apply_mlp(params["attn_mlp"], feat)[..., 0]  # [B, T]
    return torch.where(mask, logit, 0.0)


def _init_gru(in_dim: int, hidden: int, *, generator: torch.Generator,
              device: torch.device, dtype: torch.dtype = torch.float32):
    def gate():
        return {
            "wx": normal_init((in_dim, hidden), generator=generator,
                              device=device, stddev=0.05, dtype=dtype),
            "wh": normal_init((hidden, hidden), generator=generator,
                              device=device, stddev=0.05, dtype=dtype),
            "b": torch.zeros((hidden,), dtype=dtype, device=device),
        }
    return {"r": gate(), "z": gate(), "h": gate()}


def _gru_cell(p, h: torch.Tensor, x: torch.Tensor,
              update_scale: torch.Tensor | None = None) -> torch.Tensor:
    """One step of the reference's cell (AUGRU when ``update_scale`` [B] is
    given: the attention scales the update gate)."""
    r = torch.sigmoid(x @ p["r"]["wx"] + h @ p["r"]["wh"] + p["r"]["b"])
    z = torch.sigmoid(x @ p["z"]["wx"] + h @ p["z"]["wh"] + p["z"]["b"])
    hh = torch.tanh(x @ p["h"]["wx"] + (r * h) @ p["h"]["wh"] + p["h"]["b"])
    if update_scale is not None:
        z = z * update_scale[:, None]
    return (1.0 - z) * h + z * hh


def _gru_states(p, xs: torch.Tensor, att: torch.Tensor | None = None
                ) -> list[torch.Tensor]:
    """The cell of ``_gru_cell`` over xs [B, T, D] from h = 0 -> the T
    hidden states, each [B, H].

    The input projections of all T steps (and the biases) are one matmul
    before the loop; a step is then one product for r and z together, one
    for the candidate state, and four elementwise launches (five for the
    AUGRU).  f32 sums in another order than the cell's, within 1e-6."""
    B, T, D = xs.shape
    H = p["r"]["wh"].shape[0]
    xt = xs.transpose(0, 1).reshape(T * B, D)
    x_rz = torch.addmm(torch.cat([p["r"]["b"], p["z"]["b"]]), xt,
                       torch.cat([p["r"]["wx"], p["z"]["wx"]], dim=1)
                       ).view(T, B, 2 * H)
    x_h = torch.addmm(p["h"]["b"], xt, p["h"]["wx"]).view(T, B, H)
    w_rz = torch.cat([p["r"]["wh"], p["z"]["wh"]], dim=1)   # [H, 2H]
    w_h = p["h"]["wh"]
    scale = None if att is None else att.t().contiguous()[..., None]  # [T, B, 1]
    h = xs.new_zeros((B, H))
    states = []
    for t in range(T):
        rz = torch.sigmoid(torch.addmm(x_rz[t], h, w_rz))
        r, z = rz[:, :H], rz[:, H:]
        hh = torch.tanh(torch.addmm(x_h[t], r * h, w_h))
        if scale is not None:
            z = z * scale[t]
        h = torch.lerp(h, hh, z)  # (1 - z) * h + z * hh
        states.append(h)
    return states


def _run_gru(p, xs: torch.Tensor, att: torch.Tensor | None = None
             ) -> torch.Tensor:
    """xs [B, T, D] -> all hidden states [B, T, H] (the reference's
    ``lax.scan`` over T)."""
    return torch.stack(_gru_states(p, xs, att), dim=1)


def apply(params, batch, cfg: RecsysConfig) -> torch.Tensor:
    """CTR logits [B] of ``target_id`` given ``history_ids`` (and
    ``profile_ids``)."""
    table = params["embedding"]["table"]
    hist = batch["history_ids"]                                 # [B, T]
    mask = hist >= 0
    hist_emb = item_rows(table, hist, cfg) * mask[..., None].to(cfg.dtype)
    target_emb = item_rows(table, batch["target_id"], cfg)     # [B, D]

    if cfg.use_gru:  # DIEN
        states = _run_gru(params["gru"], hist_emb)              # interest extractor
        att = attention_scores(params, states, target_emb, mask, cfg)
        att = torch.softmax(torch.where(mask, att, -1e30), dim=-1)
        interest = _gru_states(params["augru"], states, att=att)[-1]
    else:  # DIN
        att = attention_scores(params, hist_emb, target_emb, mask, cfg)
        interest = torch.einsum("bt,btd->bd", att, hist_emb)

    feats = [interest, target_emb]
    if cfg.embedding.num_features > 1 and "profile_ids" in batch:
        feats.append(profile_lookup(table, batch["profile_ids"], cfg))
    return apply_mlp(params["top_mlp"], torch.cat(feats, dim=-1))[:, 0]


def retrieval_scores(params, batch, candidate_ids: torch.Tensor,
                     cfg: RecsysConfig) -> torch.Tensor:
    """Score one user's history against N candidate items -> [N].

    DIN's attention depends on the target, so each candidate re-attends over
    the history; the history embeddings are gathered once and broadcast,
    and the N x T attention unit is the honest cost.  Candidates go through
    in chunks of ``RETRIEVAL_CHUNK``."""
    table = params["embedding"]["table"]
    hist = batch["history_ids"][0]                              # [T]
    mask = hist >= 0
    hist_emb = item_rows(table, hist, cfg) * mask[:, None].to(cfg.dtype)
    T, D = hist_emb.shape
    prof = None
    if cfg.embedding.num_features > 1 and "profile_ids" in batch:
        prof = profile_lookup(table, batch["profile_ids"], cfg)  # [1, (F-1)D]
    out = []
    chunk = RETRIEVAL_CHUNK
    for s in range(0, candidate_ids.shape[0], chunk):
        cand_emb = item_rows(table, candidate_ids[s:s + chunk], cfg)  # [n, D]
        n = cand_emb.shape[0]
        h = hist_emb[None].expand(n, T, D)
        att = attention_scores(params, h, cand_emb, mask[None].expand(n, T),
                               cfg)
        feats = [torch.einsum("nt,ntd->nd", att, h), cand_emb]
        if prof is not None:
            feats.append(prof.expand(n, prof.shape[-1]))
        out.append(apply_mlp(params["top_mlp"], torch.cat(feats, dim=-1))[:, 0])
    return torch.cat(out)


class GRU(nn.Module):
    """The ``{"r", "z", "h"} x {"wx", "wh", "b"}`` gates as parameters;
    ``tree()`` gives the reference's pytree back."""

    def __init__(self, params):
        super().__init__()
        self.gates = nn.ParameterDict({
            f"{g}_{k}": nn.Parameter(params[g][k])
            for g in "rzh" for k in ("wx", "wh", "b")})

    def tree(self):
        return {g: {k: self.gates[f"{g}_{k}"] for k in ("wx", "wh", "b")}
                for g in "rzh"}


class DIN(nn.Module):
    """DIN / DIEN holding the reference's parameter pytree."""

    def __init__(self, cfg: RecsysConfig, params):
        super().__init__()
        self.cfg = cfg
        self.table = nn.Parameter(params["embedding"]["table"])
        self.attn_mlp = MLP(params["attn_mlp"])
        self.top_mlp = MLP(params["top_mlp"])
        if cfg.use_gru:
            self.gru = GRU(params["gru"])
            self.augru = GRU(params["augru"])

    def tree(self):
        """The parameters as the reference's pytree (the same tensors)."""
        tree = {"embedding": {"table": self.table},
                "attn_mlp": self.attn_mlp.layers(),
                "top_mlp": self.top_mlp.layers()}
        if self.cfg.use_gru:
            tree["gru"] = self.gru.tree()
            tree["augru"] = self.augru.tree()
        return tree

    def forward(self, batch) -> torch.Tensor:
        return apply(self.tree(), batch, self.cfg)

    def retrieval_scores(self, batch, candidate_ids: torch.Tensor
                         ) -> torch.Tensor:
        return retrieval_scores(self.tree(), batch, candidate_ids, self.cfg)


def init(cfg: RecsysConfig, *, generator: torch.Generator,
         device: torch.device) -> DIN:
    """A DIN (DIEN if ``cfg.use_gru``) with random weights drawn on
    ``device`` from ``generator`` (the reference's init scales)."""
    d = cfg.embed_dim
    n_profile = cfg.embedding.num_features - 1
    params = {
        "embedding": emb_lib.init_embedding(cfg.embedding, generator=generator,
                                            device=device),
        # attention unit input: [e_h, e_t, e_h - e_t, e_h * e_t]
        "attn_mlp": init_mlp((4 * d, *cfg.attn_mlp, 1), generator=generator,
                             device=device, dtype=cfg.dtype),
        # [interest, e_target, profiles]
        "top_mlp": init_mlp((2 * d + n_profile * d, *cfg.top_mlp, 1),
                            generator=generator, device=device,
                            dtype=cfg.dtype),
    }
    if cfg.use_gru:
        for name in ("gru", "augru"):
            params[name] = _init_gru(d, d, generator=generator, device=device,
                                     dtype=cfg.dtype)
    return DIN(cfg, params)


def params_from_reference(tree, *, device: torch.device):
    """The reference ``din.init`` pytree (numpy leaves) as tensors on
    ``device``, ready for ``DIN(cfg, params)``."""
    return tree_from_numpy(tree, device)
