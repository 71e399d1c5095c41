"""Synthetic click-log generator for recsys training/serving.

Reproduces the production distributions the paper characterizes (Fig. 2):

- **Ids are power-law (Zipf) distributed and frequency-ranked**: id 0 is the
  hottest row of each table. This ranked layout is what makes the paper's
  locality-aware hot/cold partition a simple ``id < hot_rows`` test
  (repro_torch.models.embedding) and is how production tables are laid out after
  frequency remapping.
- **Pooling factors are lognormal with a heavy tail** (Fig. 2c): per-lookup
  multi-hot counts vary widely around the table's nominal pooling factor.
- **Query sizes (items-to-rank per request) are lognormal between ~10 and
  ~1000** (Fig. 2b).

Everything is numpy (host-side input pipeline); batches convert to jnp at
the step boundary.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.models.embedding import EmbeddingConfig
from repro_torch.models.recsys_base import RecsysConfig


@dataclasses.dataclass
class ClickLogConfig:
    zipf_alpha: float = 1.05          # id popularity skew (alpha -> 1: heavier)
    pooling_sigma: float = 0.6        # lognormal sigma around nominal pooling
    query_size_mu: float = np.log(64) # Fig 2b: median query ~ tens of items
    query_size_sigma: float = 1.1
    query_size_max: int = 1024


class ClickLogGenerator:
    """Stateful numpy generator of recsys batches for one model config."""

    def __init__(self, cfg: RecsysConfig, seed: int = 0,
                 log_cfg: ClickLogConfig | None = None):
        self.cfg = cfg
        self.log = log_cfg or ClickLogConfig()
        self.rng = np.random.default_rng(seed)

    # -- low-level samplers ------------------------------------------------

    def _zipf_ids(self, vocab: int, size) -> np.ndarray:
        """Frequency-ranked power-law ids in [0, vocab): id 0 hottest.

        Log-uniform construction (Zipf with exponent ~1): id = V^u - 1 for
        u ~ U(0,1), so pmf(id) ∝ 1/(id+1). ``zipf_alpha`` > 1 sharpens the
        head by raising u to a power."""
        u = self.rng.random(size) ** self.log.zipf_alpha
        ids = np.floor(np.power(float(vocab), u)) - 1.0
        return np.clip(ids, 0, vocab - 1).astype(np.int64)

    def _pooling_counts(self, nominal: int, size) -> np.ndarray:
        """Heavy-tailed per-bag lookup counts, clipped to [1, nominal]."""
        if nominal <= 1:
            return np.ones(size, np.int64)
        ln = self.rng.lognormal(np.log(max(nominal, 2) * 0.6),
                                self.log.pooling_sigma, size)
        return np.clip(ln.astype(np.int64), 1, nominal)

    def query_sizes(self, n: int) -> np.ndarray:
        """Items-to-rank per inference query (Fig. 2b)."""
        s = self.rng.lognormal(self.log.query_size_mu, self.log.query_size_sigma, n)
        return np.clip(s.astype(np.int64), 1, self.log.query_size_max)

    # -- batch builders ----------------------------------------------------

    def sparse_ids(self, batch: int) -> np.ndarray:
        """[B, F, Pmax] int32, -1-padded multi-hot ids."""
        emb = self.cfg.embedding
        F, P = emb.num_features, emb.max_pooling
        out = np.full((batch, F, P), -1, np.int32)
        for f in range(F):
            p_nom = emb.pooling[f]
            counts = self._pooling_counts(p_nom, batch)
            total = int(counts.sum())
            ids = self._zipf_ids(emb.vocab_sizes[f], total)
            pos = 0
            for b in range(batch):
                c = counts[b]
                out[b, f, :c] = ids[pos : pos + c]
                pos += c
        return out

    def batch(self, batch_size: int, *, with_labels: bool = True) -> dict:
        """One model batch matching recsys_base.input_specs."""
        cfg = self.cfg
        emb = cfg.embedding
        b: dict[str, np.ndarray] = {}
        if cfg.n_dense:
            b["dense"] = self.rng.normal(size=(batch_size, cfg.n_dense)).astype(np.float32)
        if cfg.interaction in ("dot", "concat"):
            b["sparse_ids"] = self.sparse_ids(batch_size)
        if cfg.seq_len:
            item_vocab = emb.vocab_sizes[0]
            hist = self._zipf_ids(item_vocab, (batch_size, cfg.seq_len)).astype(np.int32)
            lengths = np.clip(
                self.rng.lognormal(np.log(cfg.seq_len * 0.5), 0.5, batch_size),
                1, cfg.seq_len,
            ).astype(np.int64)
            mask = np.arange(cfg.seq_len)[None, :] < lengths[:, None]
            b["history_ids"] = np.where(mask, hist, -1).astype(np.int32)
            b["target_id"] = self._zipf_ids(item_vocab, batch_size).astype(np.int32)
            if emb.num_features > 1:
                b["profile_ids"] = np.stack(
                    [
                        self._zipf_ids(emb.vocab_sizes[f], batch_size)
                        for f in range(1, emb.num_features)
                    ],
                    axis=1,
                ).astype(np.int32)
        if with_labels:
            shape = (batch_size,) if cfg.n_tasks == 1 else (batch_size, cfg.n_tasks)
            b["label"] = (self.rng.random(shape) < 0.03).astype(np.float32)  # CTR ~3%
        return b

    def access_frequencies(self, n_queries: int = 512) -> list[np.ndarray]:
        """Per-feature id access histograms from a sampled trace — the input
        to the paper's locality-aware hot-set sizing (Fig. 10a)."""
        emb = self.cfg.embedding
        freqs = []
        ids = self.sparse_ids(n_queries) if self.cfg.interaction in ("dot", "concat") else None
        for f in range(emb.num_features):
            if ids is None:
                freqs.append(np.ones(1))
                continue
            col = ids[:, f, :].reshape(-1)
            col = col[col >= 0]
            freqs.append(np.bincount(col, minlength=emb.vocab_sizes[f]).astype(np.float64))
        return freqs
