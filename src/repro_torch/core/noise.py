"""Gaussian noise models (paper Table 1, col 3).

The counterpart of ``repro/core/noise.py`` for the slice the port
covers: ``FixedGaussian`` and ``AdaptiveGaussian``.  ``ProbitNoise`` is
still to be ported (ROADMAP A3).

Each noise model owns a tiny state dict and two hooks used by the Gibbs
sweep:

* ``sample_state(key, state, pred, vals, mask)`` -- resample the noise
  state from residuals at the observed entries.
* ``augment(key, state, pred, vals, mask)`` -- return the effective
  (values, precision) the factor update regresses on; for Gaussian
  noise the values themselves.

Hyper-parameters stay Python floats, so the dataclasses are the same
values as the reference's and compare equal to them field by field.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import random


@dataclasses.dataclass(frozen=True)
class FixedGaussian:
    precision: float = 5.0

    def init(self, device) -> dict:
        return {"alpha": torch.tensor(self.precision, dtype=torch.float32,
                                      device=device)}

    def sample_state(self, key, state, pred, vals, mask):
        return state

    def augment(self, key, state, pred, vals, mask):
        return vals, state["alpha"]


@dataclasses.dataclass(frozen=True)
class AdaptiveGaussian:
    """alpha ~ Gamma(a0 + nnz/2, b0 + SSE/2), resampled every sweep.

    ``sn_init`` seeds alpha; ``sn_max`` caps it.
    """

    sn_init: float = 1.0
    sn_max: float = 1e4
    a0: float = 0.5
    b0: float = 0.5

    def init(self, device) -> dict:
        return {"alpha": torch.tensor(self.sn_init, dtype=torch.float32,
                                      device=device)}

    def sample_state(self, key, state, pred, vals, mask):
        resid = (vals - pred) * mask
        sse = torch.sum(resid * resid)
        nnz = torch.sum(mask)
        a_post = self.a0 + 0.5 * nnz
        b_post = self.b0 + 0.5 * sse
        alpha = random.gamma(key, a_post) / b_post
        alpha = torch.clamp(alpha, 1e-6, self.sn_max)
        # an all-masked block has no residuals to learn from: keep the
        # previous alpha instead of drawing from the data-free Gamma
        return {"alpha": torch.where(nnz > 0, alpha, state["alpha"])}

    def augment(self, key, state, pred, vals, mask):
        return vals, state["alpha"]
