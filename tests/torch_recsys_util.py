"""Helpers shared by the port's recsys tests (imports neither jax nor the
reference, so the card tests may use it too)."""
import dataclasses


def cut_vocab(cfg, rows=3000, **emb):
    """``cfg`` (the reference's or the port's RecsysConfig) with every
    vocabulary cut to at most ``rows`` ids and the embedding fields in
    ``emb`` replaced."""
    e = dataclasses.replace(
        cfg.embedding, vocab_sizes=tuple(min(v, rows) for v in
                                         cfg.embedding.vocab_sizes), **emb)
    return dataclasses.replace(cfg, embedding=e)
