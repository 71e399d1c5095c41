"""Synthetic LM token stream (structured, learnable): a tiny mixture of
Markov chains over the vocab so a ~100M model trained a few hundred steps
shows a falling loss curve.

A numpy copy of ``repro.data.lm``: the same generator draws the same
tokens for the same seed."""
from __future__ import annotations

import numpy as np


class TokenStream:
    def __init__(self, vocab: int, seed: int = 0, order_states: int = 512):
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)
        self.states = order_states
        # sparse-ish transition structure: each state prefers 8 tokens
        self.pref = self.rng.integers(0, vocab, (order_states, 8))

    def batch(self, batch_size: int, seq_len: int) -> dict:
        toks = np.empty((batch_size, seq_len), np.int32)
        state = self.rng.integers(0, self.states, batch_size)
        for t in range(seq_len):
            choice = self.rng.integers(0, 8, batch_size)
            noise = self.rng.random(batch_size) < 0.1
            tok = self.pref[state, choice]
            tok = np.where(noise, self.rng.integers(0, self.vocab, batch_size), tok)
            toks[:, t] = tok
            state = (state * 31 + tok) % self.states
        return {"tokens": toks}
