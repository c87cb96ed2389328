"""Noise models (paper Table 1, col 3).

The counterpart of ``repro/core/noise.py``:

* ``FixedGaussian``    -- fixed precision alpha;
* ``AdaptiveGaussian`` -- alpha ~ Gamma conditional on the residual SSE;
* ``ProbitNoise``      -- binary data through truncated-normal latent
                          augmentation (unit precision on the latents).

Each noise model owns a tiny state dict and two hooks used by the Gibbs
sweep:

* ``sample_state(key, state, pred, vals, mask, sse=None, nnz=None)``
  -- resample the noise state from residuals at the observed entries;
  ``sse``/``nnz`` replace the local sums (the distributed sweep passes
  them all-reduced over the row shards).
* ``augment(key, state, pred, vals, mask, row_offset=0)`` -- return the
  effective (values, precision) the factor update regresses on; for
  Gaussian noise the values themselves, for probit the truncated-normal
  latents drawn around ``pred``.

Hyper-parameters stay Python floats, so the dataclasses are the same
values as the reference's and compare equal to them field by field.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import random

_SQRT2 = float(np.float32(1.4142135623730951))
# XLA divides by the constant sqrt(2) as a multiply by its float32
# reciprocal
_RSQRT2 = float(np.float32(1.0) / np.float32(1.4142135623730951))
_EPS = 1e-7


@dataclasses.dataclass(frozen=True)
class FixedGaussian:
    precision: float = 5.0

    def init(self, device) -> dict:
        return {"alpha": torch.tensor(self.precision, dtype=torch.float32,
                                      device=device)}

    def sample_state(self, key, state, pred, vals, mask, sse=None,
                     nnz=None):
        return state

    def augment(self, key, state, pred, vals, mask, row_offset=0):
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

    def sample_state(self, key, state, pred, vals, mask, sse=None,
                     nnz=None):
        """``sse``/``nnz`` override the local residual sums: the
        distributed sweep all-reduces them over the row shards first, so
        every rank draws the same alpha from the same key."""
        if sse is None:
            resid = (vals - pred) * mask
            sse = torch.sum(resid * resid)
        if nnz is None:
            nnz = torch.sum(mask)
        a_post = self.a0 + 0.5 * nnz
        b_post = self.b0 + 0.5 * sse
        alpha = random.gamma(key, a_post) / b_post
        alpha = torch.clamp(alpha, 1e-6, self.sn_max)
        # an all-masked block has no residuals to learn from: keep the
        # previous alpha instead of drawing from the data-free Gamma
        return {"alpha": torch.where(nnz > 0, alpha, state["alpha"])}

    def augment(self, key, state, pred, vals, mask, row_offset=0):
        return vals, state["alpha"]


# XLA's single-precision erf (chlo.erf's f32 lowering): x clamped to
# +-erfinv(1 - 2**-23), then an odd/even rational polynomial
_ERF_CLAMP = float(np.float32(3.7439211627767994))
_ERF_ALPHA = (0.00022905065861350646, 0.0034082910107109506,
              0.050955695062380861, 0.18520832239976145, 1.128379143519084)
_ERF_BETA = (-1.1791602954361697e-7, 0.000023547966471313185,
             0.0010179625278914885, 0.014070470171167667,
             0.11098505178285362, 0.49746925110067538, 1.0)


def erf(x: torch.Tensor) -> torch.Tensor:
    """Single-precision error function, XLA's polynomial with its fused
    multiply-adds: bitwise ``jax.lax.erf`` on the CPU (``torch.erf``
    differs from it by up to 3 ulps)."""
    x = torch.clamp(x, -_ERF_CLAMP, _ERF_CLAMP)
    x2 = (x * x).double()
    p = torch.full_like(x, float(np.float32(_ERF_ALPHA[0])))
    for c in _ERF_ALPHA[1:]:
        p = random._fma(p, x2, float(np.float32(c)))
    q = torch.full_like(x, float(np.float32(_ERF_BETA[0])))
    for c in _ERF_BETA[1:]:
        q = random._fma(q, x2, float(np.float32(c)))
    return (x * p) / q


def _truncnorm_from_u(u, mean, lower_tail):
    """Inverse-CDF truncated-normal transform of uniforms ``u``.

    z ~ N(mean, 1) truncated to z > 0 where ``lower_tail`` > 0, else
    z < 0, with u in the open interval (0, 1).  Elementwise, so a row
    slice of (u, mean, lower_tail) yields the matching slice of z.
    """
    # P(z < 0) = Phi(-mean)
    p0 = 0.5 * (1.0 + erf(-mean * _RSQRT2))
    p0 = torch.clamp(p0, _EPS, 1.0 - _EPS)
    # positive side: U ~ (p0, 1); negative side: U ~ (0, p0)
    uu = torch.where(lower_tail > 0, random._fma(u, (1.0 - p0).double(), p0),
                     u * p0)
    z = random._fma(random.erf_inv(2.0 * uu - 1.0), _SQRT2, mean)
    return torch.clamp(z, min=mean - 8.0, max=mean + 8.0)


@dataclasses.dataclass(frozen=True)
class ProbitNoise:
    """Binary matrices: P(r = 1) = Phi(u.v); Albert-Chib augmentation.

    ``augment`` replaces each observed binary value with a latent
    z ~ TruncNormal(pred, 1) whose sign matches the observation, and
    fixes the regression precision at 1.  The uniforms behind the draws
    are counter-based per row (``gibbs.row_uniforms``): row i of a
    (R, T) operand draws from ``fold_in(key, row_offset + i)``.
    """

    threshold: float = 0.5  # vals > threshold count as positive

    def init(self, device) -> dict:
        return {"alpha": torch.tensor(1.0, dtype=torch.float32,
                                      device=device)}

    def sample_state(self, key, state, pred, vals, mask, sse=None,
                     nnz=None):
        return state

    def augment(self, key, state, pred, vals, mask, row_offset=0):
        # deferred import: gibbs imports this module at load time
        from .gibbs import row_uniforms
        pos = (vals > self.threshold).to(torch.float32)
        u = row_uniforms(key, vals.shape[0], vals.shape[1], row_offset,
                         minval=_EPS, maxval=1.0 - _EPS)
        z = _truncnorm_from_u(u, pred, pos)
        return z * mask, state["alpha"]
