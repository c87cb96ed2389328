"""Convergence diagnostics for multi-chain MCMC — split-R-hat and bulk-ESS.

A copy of ``repro/core/diagnostics.py`` (importing it would pull in
``repro.core`` and JAX).  Pure numpy, host-side, deterministic (no RNG,
no wall clock).  The estimators
follow Vehtari, Gelman, Simpson, Carpenter, Bürkner (2021), "Rank-
normalization, folding, and localization: an improved R-hat for
assessing convergence of MCMC":

* ``split_rhat`` — each chain is split in half (2C half-chains of
  length N//2, the middle draw dropped when N is odd), then the classic
  Gelman-Rubin potential scale reduction factor sqrt(var_hat / W) is
  computed over the half-chains.  Splitting makes a single non-
  stationary chain flag itself.
* ``bulk_ess`` — effective sample size of the rank-normalized split
  chains, with per-chain autocovariances combined as in Stan and the
  autocorrelation sum truncated by Geyer's initial monotone positive
  sequence.

Both take draws shaped ``(C, N)`` (chains x draws) and return a float;
with fewer than 4 draws per chain (or a constant trace) they return
``nan`` rather than a misleading number.

The session layer records one trace per monitored quantity — per-block
``rmse_train_<b>`` / ``alpha_<b>`` and per-entity factor RMS norms over
the post-burnin sweeps — and stores the resulting :class:`Diagnostics`
next to the sample store as ``diagnostics.json``, where
``PredictSession(require_converged=True)`` gates on it before serving.
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

DIAGNOSTICS_FILE = "diagnostics.json"
_FORMAT = "repro-mf-diagnostics-v1"

# Default convergence threshold for split-R-hat.  Vehtari et al. (2021)
# recommend 1.01 for publication-grade inference; 1.05 is the common
# serving-gate compromise (classic Gelman-Rubin used 1.1).
DEFAULT_RHAT_THRESHOLD = 1.05

MIN_DRAWS = 4


def _as_chain_matrix(x) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        x = x[None, :]
    if x.ndim != 2:
        raise ValueError(
            f"expected draws shaped (chains, draws), got shape {x.shape}")
    return x


def split_chains(x) -> np.ndarray:
    """(C, N) draws -> (2C, N//2) half-chains (odd middle draw dropped)."""
    x = _as_chain_matrix(x)
    half = x.shape[1] // 2
    return np.concatenate([x[:, :half], x[:, x.shape[1] - half:]], axis=0)


def split_rhat(x) -> float:
    """Split potential scale reduction factor over ``(C, N)`` draws."""
    x = _as_chain_matrix(x)
    if x.shape[1] < MIN_DRAWS or not np.all(np.isfinite(x)):
        return float("nan")
    z = split_chains(x)
    m, n = z.shape
    means = z.mean(axis=1)
    variances = z.var(axis=1, ddof=1)
    w = variances.mean()
    b = n * means.var(ddof=1)
    if w <= 0.0:
        # all half-chains constant: identical means -> converged by
        # definition; differing constants -> no within-variance to
        # shrink to, report nan (undefined, flagged by the gate)
        return 1.0 if b <= 0.0 else float("nan")
    var_hat = (n - 1) / n * w + b / n
    return float(math.sqrt(var_hat / w))


def _ndtri(p: np.ndarray) -> np.ndarray:
    """Inverse standard-normal CDF (Acklam's rational approximation,
    |rel err| < 1.15e-9) — numpy has no ndtri and scipy is not a
    dependency of this package."""
    p = np.asarray(p, dtype=np.float64)
    a = [-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425
    out = np.empty_like(p)

    lo = p < plow
    hi = p > phigh
    mid = ~(lo | hi)

    q = np.sqrt(-2 * np.log(np.where(lo, p, 0.5)))
    out_lo = ((((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4])
               * q + c[5])
              / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1))
    q = np.sqrt(-2 * np.log(np.where(hi, 1 - p, 0.5)))
    out_hi = -((((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4])
                * q + c[5])
               / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1))
    q = np.where(mid, p, 0.5) - 0.5
    r = q * q
    out_mid = ((((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4])
                * r + a[5]) * q
               / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4])
                  * r + 1))
    out[lo] = out_lo[lo]
    out[hi] = out_hi[hi]
    out[mid] = out_mid[mid]
    return out


def rank_normalize(x) -> np.ndarray:
    """Rank-normalize draws jointly across chains.

    Average ranks for ties, then the fractional rank ``(r - 3/8) /
    (S + 1/4)`` is pushed through the inverse normal CDF (Blom's
    offset), as in Vehtari et al. (2021) eq. 14.  Shape-preserving.
    """
    x = _as_chain_matrix(x)
    flat = x.ravel()
    order = np.argsort(flat, kind="stable")
    ranks = np.empty(flat.size, dtype=np.float64)
    ranks[order] = np.arange(1, flat.size + 1, dtype=np.float64)
    # average ranks over ties so identical draws get identical z-scores
    uniq, inv, counts = np.unique(flat, return_inverse=True,
                                  return_counts=True)
    if uniq.size != flat.size:
        sums = np.zeros(uniq.size)
        np.add.at(sums, inv, ranks)
        ranks = (sums / counts)[inv]
    z = _ndtri((ranks - 0.375) / (flat.size + 0.25))
    return z.reshape(x.shape)


def _combined_autocorr(z: np.ndarray) -> np.ndarray:
    """Multi-chain autocorrelation estimate rho_t (Stan's combination):

        rho_t = 1 - (W - mean_c s_t^c) / var_hat

    with ``s_t^c`` the per-chain biased autocovariance at lag t and
    ``var_hat`` the split-R-hat total-variance estimate.
    """
    m, n = z.shape
    means = z.mean(axis=1, keepdims=True)
    centered = z - means
    # per-chain biased autocovariances, s_t^c = (1/n) sum x_i x_{i+t}
    acov = np.empty((m, n))
    for c in range(m):
        full = np.correlate(centered[c], centered[c], mode="full")
        acov[c] = full[n - 1:] / n
    chain_var = acov[:, 0] * n / (n - 1.0)
    w = chain_var.mean()
    b_over_n = z.mean(axis=1).var(ddof=1) if m > 1 else 0.0
    var_hat = (n - 1.0) / n * w + b_over_n
    if var_hat <= 0.0:
        return np.full(n, np.nan)
    return 1.0 - (w - acov.mean(axis=0)) / var_hat


def ess(x) -> float:
    """Effective sample size of ``(C, N)`` draws (no rank-normalization;
    use :func:`bulk_ess` for the gate metric).

    Geyer's initial positive sequence: pair sums ``P_t = rho_{2t} +
    rho_{2t+1}`` are accumulated while positive, then made monotone
    non-increasing; ``tau = 1 + 2 sum rho`` and ``ess = C*N / tau``.
    """
    x = _as_chain_matrix(x)
    m, n = x.shape
    if n < MIN_DRAWS or not np.all(np.isfinite(x)):
        return float("nan")
    if np.allclose(x, x.flat[0]):
        return float("nan")
    rho = _combined_autocorr(x)
    if not np.all(np.isfinite(rho[:2])):
        return float("nan")
    # Geyer pairs (rho_0 + rho_1), (rho_2 + rho_3), ...: keep while
    # positive, clip monotone non-increasing
    pair_sums = []
    prev = np.inf
    t = 0
    while 2 * t + 1 < n:
        p = rho[2 * t] + rho[2 * t + 1]
        if not np.isfinite(p) or p < 0.0:
            break
        p = min(p, prev)
        pair_sums.append(p)
        prev = p
        t += 1
    tau = -rho[0] + 2.0 * float(np.sum(pair_sums)) if pair_sums else 1.0
    tau = max(tau, 1.0 / math.log10(max(m * n, 10)))
    return float(m * n / tau)


def bulk_ess(x) -> float:
    """Bulk-ESS: ESS of the rank-normalized split chains."""
    x = _as_chain_matrix(x)
    if x.shape[1] < MIN_DRAWS or not np.all(np.isfinite(x)):
        return float("nan")
    if np.allclose(x, x.flat[0]):
        return float("nan")
    return ess(rank_normalize(split_chains(x)))


@dataclass
class Diagnostics:
    """Per-quantity convergence summary for one multi-chain run."""

    n_chains: int
    n_draws: int
    rhat: Dict[str, float] = field(default_factory=dict)
    ess: Dict[str, float] = field(default_factory=dict)

    @property
    def max_rhat(self) -> float:
        finite = [v for v in self.rhat.values() if math.isfinite(v)]
        return max(finite) if finite else float("nan")

    def failing(self, threshold: float = DEFAULT_RHAT_THRESHOLD
                ) -> Dict[str, float]:
        """Quantities whose R-hat exceeds ``threshold`` or is nan/absent
        of evidence (non-finite with >= MIN_DRAWS draws is a failure —
        an undefined diagnostic must not pass a convergence gate)."""
        out = {}
        for name, v in self.rhat.items():
            if not math.isfinite(v) or v > threshold:
                out[name] = v
        return out

    def converged(self, threshold: float = DEFAULT_RHAT_THRESHOLD) -> bool:
        return bool(self.rhat) and not self.failing(threshold)

    def to_dict(self) -> dict:
        return {
            "format": _FORMAT,
            "n_chains": int(self.n_chains),
            "n_draws": int(self.n_draws),
            "rhat": {k: float(v) for k, v in self.rhat.items()},
            "ess": {k: float(v) for k, v in self.ess.items()},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Diagnostics":
        return cls(n_chains=int(d["n_chains"]), n_draws=int(d["n_draws"]),
                   rhat={k: float(v) for k, v in d.get("rhat", {}).items()},
                   ess={k: float(v) for k, v in d.get("ess", {}).items()})


def compute_diagnostics(traces: Dict[str, np.ndarray]) -> Diagnostics:
    """Split-R-hat + bulk-ESS for every monitored trace.

    ``traces`` maps quantity name -> draws shaped ``(C, N)`` (a 1-D
    trace is treated as one chain).  All traces must share C and N.
    """
    n_chains = n_draws = 0
    rhat, ess_ = {}, {}
    for name, tr in traces.items():
        tr = _as_chain_matrix(tr)
        n_chains, n_draws = tr.shape
        rhat[name] = split_rhat(tr)
        ess_[name] = bulk_ess(tr)
    return Diagnostics(n_chains=n_chains, n_draws=n_draws,
                       rhat=rhat, ess=ess_)


def save_diagnostics(save_dir: str, diag: Diagnostics) -> str:
    path = os.path.join(save_dir, DIAGNOSTICS_FILE)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(diag.to_dict(), f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def load_diagnostics(save_dir: str) -> Optional[Diagnostics]:
    path = os.path.join(save_dir, DIAGNOSTICS_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        d = json.load(f)
    return Diagnostics.from_dict(d)
