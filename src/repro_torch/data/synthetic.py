"""Synthetic data: ChEMBL-like MF data and LM token streams, for seeded
inputs.

Copies of ``chembl_like``, ``TokenStream``, ``make_lm_batch`` and
``lm_batches`` from ``repro/data/synthetic.py`` (pure numpy): the same
seed gives the same arrays in both packages, bitwise.  ``chembl_like``
returns the port's ``SparseMatrix`` and the LM batches their tensors on
the device asked for (the card by default).
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..core.sparse import SparseMatrix, from_coo


def chembl_like(seed: int, n_compounds: int = 2000, n_proteins: int = 200,
                density: float = 0.02, rank: int = 16,
                noise: float = 0.4, n_features: int = 128,
                feature_noise: float = 0.5, device: DeviceLike = None,
                ) -> Tuple[SparseMatrix, Tuple, np.ndarray]:
    """Synthetic compound-activity data: (train ``SparseMatrix`` on
    ``device``, (i, j, v) test triplets, fingerprints F).

    A planted rank-``rank`` product plus Gaussian noise, with power-law
    row occupancy (like real assay data); the fingerprints are binarized
    projections of the true compound factors, so side information
    helps.
    """
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(n_compounds, rank)).astype(np.float32)
    V = rng.normal(size=(n_proteins, rank)).astype(np.float32)

    # power-law tests a compound
    w = (1.0 / np.arange(1, n_compounds + 1) ** 0.7)
    w = w[rng.permutation(n_compounds)]
    p_row = w / w.sum()
    nnz = int(density * n_compounds * n_proteins)
    i = rng.choice(n_compounds, size=3 * nnz, p=p_row)
    j = rng.integers(0, n_proteins, size=3 * nnz)
    ij = np.unique(np.stack([i, j], 1), axis=0)
    ij = ij[rng.permutation(len(ij))[:nnz]]
    i, j = ij[:, 0], ij[:, 1]
    v = np.einsum("ek,ek->e", U[i], V[j]) + noise * rng.normal(
        size=len(i)).astype(np.float32)

    # ECFP-like binary fingerprints correlated with the latent factors
    proj = rng.normal(size=(rank, n_features)).astype(np.float32)
    F = (U @ proj + feature_noise * rng.normal(
        size=(n_compounds, n_features)) > 0).astype(np.float32)

    n_test = max(1, nnz // 10)
    test = (i[:n_test], j[:n_test], v[:n_test].astype(np.float32))
    tr = slice(n_test, None)
    mat = from_coo(i[tr], j[tr], v[tr].astype(np.float32),
                   (n_compounds, n_proteins), device=device)
    return mat, test, F


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


def make_lm_batch(stream: TokenStream, step: int, batch: int, seq: int,
                  frontend_tokens: int = 0, d_model: int = 0,
                  enc_frames: int = 0, device: DeviceLike = None
                  ) -> Dict[str, torch.Tensor]:
    """One training batch on ``device``: ``tokens`` and ``labels``
    (batch, seq) int64, the stream's step ``step`` shifted by one, and
    the stub modality embeddings (``frontend`` (batch, frontend_tokens,
    d_model), ``enc_frames`` (batch, enc_frames, d_model), fp32) where
    asked for; the reference's values, bitwise."""
    dev = resolve_device(device)
    toks = torch.from_numpy(stream.batch(step, batch, seq).astype(np.int64))
    out = {"tokens": toks[:, :-1].contiguous().to(dev),
           "labels": toks[:, 1:].contiguous().to(dev)}
    if frontend_tokens:
        rng = np.random.default_rng((stream.seed, step, 7))
        out["frontend"] = torch.from_numpy(
            rng.normal(size=(batch, frontend_tokens, d_model))
            .astype(np.float32)).to(dev)
    if enc_frames:
        rng = np.random.default_rng((stream.seed, step, 11))
        out["enc_frames"] = torch.from_numpy(
            rng.normal(size=(batch, enc_frames, d_model))
            .astype(np.float32)).to(dev)
    return out


def lm_batches(stream: TokenStream, start_step: int, batch: int, seq: int,
               **kw) -> Iterator[Dict[str, torch.Tensor]]:
    """``make_lm_batch`` of steps ``start_step``, ``start_step + 1``, ..."""
    step = start_step
    while True:
        yield make_lm_batch(stream, step, batch, seq, **kw)
        step += 1
