"""Prior distributions over the factor matrices (paper Table 1, col 2).

The counterpart of ``repro/core/priors.py``:

* ``NormalPrior``       -- multivariate Normal with a Normal-Wishart
                           hyperprior (BPMF);
* ``FixedNormalPrior``  -- fixed N(0, I), GFA's prior on the samples;
* ``MacauPrior``        -- NormalPrior + side information through a
                           sampled link matrix beta;
* ``SpikeAndSlabPrior`` -- per-(row, component) spike-and-slab for
                           group-sparse factors (GFA).

``torch.linalg.cholesky`` and ``solve_triangular`` stand in for
``jax.lax.linalg``, which the reference also runs outside any Pallas
kernel.  Each prior exposes:

* ``init(key, n_rows, device)``          -> hyper-state dict
* ``sample_hyper(key, F, hyper, ...)``   -> new hyper-state given the
                                            current factor matrix
* ``precision_term(hyper)``              -> Lambda_p (K, K)
* ``mean_term(hyper, n_rows, ...)``      -> b_p (K,), or (n_rows, K)
                                            for Macau

``FixedNormalPrior`` holds no state, so its two terms take the device.
Every matrix product is fp32 (TF32 stays off: the port never enables
it).
"""
from __future__ import annotations

import dataclasses

import torch

from typing import Optional

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


@dataclasses.dataclass(frozen=True)
class FixedNormalPrior:
    """Fixed z_i ~ N(0, I), no hyper-sampling: GFA's prior on the shared
    sample factor, which pins its scale so that the spike-and-slab
    loadings can switch unused components off."""

    num_latent: int

    def init(self, key, n_rows: int, device) -> dict:
        return {}

    def sample_hyper(self, key, F, hyper) -> dict:
        return hyper

    def precision_term(self, hyper, device=None) -> torch.Tensor:
        return torch.eye(self.num_latent, dtype=torch.float32,
                         device=device)

    def mean_term(self, hyper, n_rows: int, device=None) -> torch.Tensor:
        return torch.zeros(self.num_latent, dtype=torch.float32,
                           device=device)


@dataclasses.dataclass(frozen=True)
class MacauPrior:
    """NormalPrior whose per-row mean is shifted by beta^T f_i.

    u_i ~ N(mu + beta^T f_i, Lambda^{-1}),
    beta ~ MatrixNormal(0, (beta_precision)^{-1} I_D, Lambda^{-1}).

    ``side`` F is the (N, D) feature matrix of the entity (``MFData.sides``).
    """

    num_latent: int
    num_features: int
    b0: float = 2.0
    mu0: float = 0.0
    beta_precision: float = 5.0
    sample_beta_precision: bool = True

    @property
    def _normal(self) -> NormalPrior:
        return NormalPrior(self.num_latent, self.b0, self.mu0)

    def init(self, key, n_rows: int, device) -> dict:
        h = self._normal.init(key, n_rows, device)
        h["beta"] = torch.zeros((self.num_features, self.num_latent),
                                dtype=torch.float32, device=device)
        h["beta_prec"] = torch.tensor(self.beta_precision,
                                      dtype=torch.float32, device=device)
        return h

    def sample_hyper(self, key, F: torch.Tensor, hyper,
                     side: Optional[torch.Tensor] = None,
                     FtF: Optional[torch.Tensor] = None) -> dict:
        """NW update on (U - side beta), then the beta conditional.
        ``FtF`` is side^T side, computed once with the data
        (``gibbs.with_side_grams``) where the reference recomputes it
        in every call."""
        if side is None or FtF is None:
            raise ValueError("MacauPrior.sample_hyper needs side= and its "
                             "side^T side, FtF=")
        U_centered = F - side @ hyper["beta"]
        return self.sample_hyper_moments(
            key, hyper, F_sum=U_centered.sum(dim=0),
            F_cov=U_centered.T @ U_centered, n_rows=F.shape[0],
            StF=side.T @ F, s_side=side.sum(dim=0),
            FtF=FtF)

    def sample_hyper_moments(self, key, hyper, *, F_sum, F_cov, n_rows,
                             StF, s_side, FtF) -> dict:
        """Macau hyper-sample from sufficient statistics: ``F_sum`` and
        ``F_cov`` of the centered factor, ``StF`` = side^T U (D, K),
        ``s_side`` the column sums of side (D,), ``FtF`` (D, D)."""
        k_nw, k_b, k_prec = random.split(key, 3)
        h = self._normal.sample_hyper_moments(k_nw, hyper, F_sum=F_sum,
                                              F_cov=F_cov, n_rows=n_rows)
        # beta | U, Lambda ~ MN(mean, A^{-1}, Lambda^{-1}),
        # A = side^T side + beta_prec * I
        D, K = self.num_features, self.num_latent
        eye = torch.eye(D, dtype=torch.float32, device=FtF.device)
        La = cholesky(FtF + hyper["beta_prec"] * eye)
        # side^T (U - mu 1^T), decomposed into sums
        FtU = StF - torch.outer(s_side, h["mu"])           # (D, K)
        mean_b = solve_lower(La, solve_lower(La, FtU), transpose=True)
        # sample: mean + La^{-T} Z Llam^{-1}
        Z = random.normal(k_b, (D, K))
        Zr = solve_lower(La, Z, transpose=True)
        Llam = cholesky(h["Lambda"])
        beta = mean_b + _mn_col_mix(Zr, Llam)
        if self.sample_beta_precision:
            # beta has D*K entries, weighted by Lambda across components
            sse = torch.trace(beta @ h["Lambda"] @ beta.T)
            a_post = 0.5 * (D * K) + 1.0
            b_post = 0.5 * sse + 1.0
            h["beta_prec"] = random.gamma(k_prec, a_post) / b_post
        else:
            h["beta_prec"] = hyper["beta_prec"]
        h["beta"] = beta
        return h

    def precision_term(self, hyper) -> torch.Tensor:
        return hyper["Lambda"]

    def mean_term(self, hyper, n_rows: int,
                  side: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(N, K): Lambda @ (mu + beta^T f_i) per row."""
        if side is None:
            raise ValueError("MacauPrior.mean_term needs side=")
        m = hyper["mu"][None, :] + side @ hyper["beta"]
        return m @ hyper["Lambda"].T

    def predict_factor(self, hyper, F_new) -> torch.Tensor:
        """Latent rows for unseen entities through the sampled link:
        ``mu + beta^T f`` with the posterior sample in ``hyper``.
        F_new (M, D) -> (M, K), on the device of ``hyper``."""
        F_new = torch.as_tensor(F_new, dtype=torch.float32,
                                device=hyper["beta"].device)
        return hyper["mu"][None, :] + F_new @ hyper["beta"]


def _mn_col_mix(Zr: torch.Tensor, Llam: torch.Tensor) -> torch.Tensor:
    """Zr @ Llam^{-1}: the column mixing of MN(0, A^{-1}, Lambda^{-1})
    noise, solved as Llam^T X^T = Zr^T."""
    return solve_lower(Llam, Zr.T, transpose=True).T


@dataclasses.dataclass(frozen=True)
class SpikeAndSlabPrior:
    """v_ik ~ (1 - rho_k) delta_0 + rho_k N(0, 1 / tau_k).

    rho_k ~ Beta(a, b) and tau_k ~ Gamma(c, d) are resampled each sweep;
    the factor update itself is ``gibbs._sample_sns_factor``.
    """

    num_latent: int
    rho_a: float = 1.0
    rho_b: float = 1.0
    tau_c: float = 1.0
    tau_d: float = 1.0

    def init(self, key, n_rows: int, device) -> dict:
        K = self.num_latent
        return {"rho": torch.full((K,), 0.5, dtype=torch.float32,
                                  device=device),
                "tau": torch.ones(K, dtype=torch.float32, device=device)}

    def sample_hyper(self, key, F: torch.Tensor, hyper) -> dict:
        """F (N, K); zeros mark excluded entries."""
        s = (F.abs() > 0).to(torch.float32)     # inclusion indicators
        return self.sample_hyper_moments(key, hyper, n_incl=s.sum(dim=0),
                                         sumsq=(F * F).sum(dim=0),
                                         n_rows=F.shape[0])

    def sample_hyper_moments(self, key, hyper, *, n_incl, sumsq,
                             n_rows) -> dict:
        """SnS hyper-sample from the per-component count of included
        entries ``n_incl`` (K,) and their sum of squares ``sumsq``."""
        N = torch.tensor(n_rows, dtype=torch.float32, device=n_incl.device)
        kr, kt1, kt2 = random.split(key, 3)
        # rho_k ~ Beta(a + n_incl, b + N - n_incl)
        g1 = random.gamma(kr, self.rho_a + n_incl)
        g2 = random.gamma(kt1, self.rho_b + N - n_incl)
        rho = g1 / (g1 + g2)
        # tau_k ~ Gamma(c + n_incl / 2, d + sum v^2 / 2)
        tau = (random.gamma(kt2, self.tau_c + 0.5 * n_incl)
               / (self.tau_d + 0.5 * sumsq))
        return {"rho": torch.clamp(rho, 1e-4, 1.0 - 1e-4), "tau": tau}

    def precision_term(self, hyper) -> torch.Tensor:
        return torch.diag(hyper["tau"])

    def mean_term(self, hyper, n_rows: int) -> torch.Tensor:
        return torch.zeros(self.num_latent, dtype=torch.float32,
                           device=hyper["tau"].device)
