"""The Normal prior with a Normal-Wishart hyperprior (BPMF).

The counterpart of the ``NormalPrior`` part of ``repro/core/priors.py``
(``chol_solve``, ``sample_mvn_from_precision``, ``sample_wishart``,
``NormalPrior``).  ``torch.linalg.cholesky`` and ``solve_triangular``
stand in for ``jax.lax.linalg``, which the reference also runs outside
any Pallas kernel.  ``FixedNormalPrior``, ``MacauPrior`` and
``SpikeAndSlabPrior`` are still to be ported (ROADMAP A3).

Each prior exposes:

* ``init(key, n_rows, device)``          -> hyper-state dict
* ``sample_hyper(key, F, hyper)``        -> new hyper-state given the
                                            current factor matrix
* ``precision_term(hyper)``              -> Lambda_p (K, K)
* ``mean_term(hyper, n_rows)``           -> b_p (K,)
"""
from __future__ import annotations

import dataclasses

import torch

from .. import random


def cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, batched.  Like ``jax.lax.linalg.cholesky``
    it does not stop on a matrix that is not positive definite (no
    host sync on the info flag); the factor then holds non-finite
    values, which the callers' finiteness checks see."""
    return torch.linalg.cholesky_ex(A).L


def solve_lower(L: torch.Tensor, B: torch.Tensor,
                transpose: bool = False) -> torch.Tensor:
    """Solve ``L X = B`` (or ``L^T X = B``) for lower-triangular L."""
    if transpose:
        return torch.linalg.solve_triangular(L.mT, B, upper=True)
    return torch.linalg.solve_triangular(L, B, upper=False)


def chol_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) x = b for batched lower-triangular L.

    L (..., K, K), b (..., K)  ->  x (..., K)
    """
    y = solve_lower(L, b[..., None])
    return solve_lower(L, y, transpose=True)[..., 0]


def sample_mvn_from_precision(key, L_prec: torch.Tensor,
                              mean: torch.Tensor) -> torch.Tensor:
    """x ~ N(mean, Lambda^{-1}) given L_prec = chol(Lambda), batched."""
    z = random.normal(key, tuple(mean.shape))
    dz = solve_lower(L_prec, z[..., None], transpose=True)[..., 0]
    return mean + dz


def sample_wishart(key, L_scale: torch.Tensor, df) -> torch.Tensor:
    """Draw Lambda ~ Wishart(scale, df) via the Bartlett decomposition.

    L_scale = chol(scale matrix), K x K.  Returns L A (L A)^T with A the
    Bartlett factor: chi2(df - i) on the diagonal, N(0, 1) below.
    """
    K = L_scale.shape[-1]
    kn, kg = random.split(key)
    i = torch.arange(K, dtype=torch.float32, device=L_scale.device)
    # chi2(df - i) = 2 * gamma((df - i) / 2)
    c = torch.sqrt(2.0 * random.gamma(kg, (df - i) / 2.0))
    n = random.normal(kn, (K, K))
    A = torch.tril(n, -1) + torch.diag(c)
    LA = L_scale @ A
    return LA @ LA.T


@dataclasses.dataclass(frozen=True)
class NormalPrior:
    """mu, Lambda ~ Normal-Wishart(mu0, b0, W0 = I, df = K)."""

    num_latent: int
    b0: float = 2.0
    mu0: float = 0.0

    def init(self, key, n_rows: int, device) -> dict:
        K = self.num_latent
        return {"mu": torch.zeros(K, dtype=torch.float32, device=device),
                "Lambda": torch.eye(K, dtype=torch.float32, device=device)}

    def sample_hyper(self, key, F: torch.Tensor, hyper) -> dict:
        """Conditional NW update given the factor matrix F (N, K)."""
        return self.sample_hyper_moments(key, hyper, F_sum=F.sum(dim=0),
                                         F_cov=F.T @ F, n_rows=F.shape[0])

    def sample_hyper_moments(self, key, hyper, *, F_sum: torch.Tensor,
                             F_cov: torch.Tensor, n_rows) -> dict:
        """NW update from the sufficient statistics F^T 1 and F^T F."""
        K = self.num_latent
        dev = F_sum.device
        N = torch.tensor(n_rows, dtype=torch.float32, device=dev)
        fbar = F_sum / N
        # scatter matrix sum_i (f_i - fbar)(f_i - fbar)^T
        SS = F_cov - N * torch.outer(fbar, fbar)

        mu0 = torch.full((K,), self.mu0, dtype=torch.float32, device=dev)
        b_star = self.b0 + N
        df_star = K + N
        mu_star = (self.b0 * mu0 + N * fbar) / b_star
        dv = fbar - mu0
        eye = torch.eye(K, dtype=torch.float32, device=dev)
        Winv = eye + SS + (self.b0 * N / b_star) * torch.outer(dv, dv)
        # scale = Winv^{-1}: invert through the Cholesky of Winv
        Lw = cholesky(Winv)
        W = solve_lower(Lw, solve_lower(Lw, eye), transpose=True)
        Ls = cholesky((W + W.T) / 2.0)

        k1, k2 = random.split(key)
        Lam = sample_wishart(k1, Ls, df_star)
        Llam = cholesky(Lam * b_star)
        mu = sample_mvn_from_precision(k2, Llam, mu_star)
        return {"mu": mu, "Lambda": Lam}

    def precision_term(self, hyper) -> torch.Tensor:
        return hyper["Lambda"]

    def mean_term(self, hyper, n_rows: int) -> torch.Tensor:
        """Lambda_p @ prior-mean, shared by all rows -> (K,)."""
        return hyper["Lambda"] @ hyper["mu"]
