"""Synthetic LM token streams, for seeded prompts.

A copy of ``TokenStream`` from ``repro/data/synthetic.py`` (pure
numpy): the same seed gives the same tokens in both packages.  The
ChEMBL-like MF data and ``make_lm_batch`` (training) are not here; the
port's MF data comes from ``core.sparse``, and training is a later
slice (ROADMAP A10).
"""
from __future__ import annotations

import numpy as np


class TokenStream:
    """Deterministic, seekable synthetic token stream.

    Markov-chain-ish tokens (a sparse bigram structure over a state
    space), so a model can learn from them; ``batch(step, ...)`` is a
    pure function of the seed and the step.
    """

    def __init__(self, vocab_size: int, seed: int = 0,
                 n_states: int = 64):
        self.vocab = vocab_size
        self.seed = seed
        rng = np.random.default_rng(seed)
        self._succ = rng.integers(0, vocab_size,
                                  size=(n_states, 8)).astype(np.int32)
        self.n_states = n_states

    def batch(self, step: int, batch: int, seq: int) -> np.ndarray:
        """(batch, seq + 1) int32 tokens of step ``step``."""
        rng = np.random.default_rng((self.seed, step))
        state = rng.integers(0, self.n_states, size=(batch,))
        out = np.empty((batch, seq + 1), np.int32)
        for t in range(seq + 1):
            choice = rng.integers(0, 8, size=(batch,))
            tok = self._succ[state, choice]
            out[:, t] = tok
            state = tok % self.n_states
        return out
