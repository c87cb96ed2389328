"""Priors and noise models of the port against ``repro.core``: with the
same key and the same factor matrix, the same hyper-sample.

Tolerance rtol 1e-4 / atol 1e-5: both sides are fp32 but differ by the
few-ulp normal and gamma draws and by LAPACK's Cholesky and triangular
solves in another summation order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import noise as jnoise
from repro.core import priors as jpriors
from repro_torch import random as trandom
from repro_torch.core import noise as tnoise
from repro_torch.core import priors as tpriors
from torch_threads import _one_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-4, atol=1e-5)


def _keys(seed):
    return jax.random.PRNGKey(seed), trandom.PRNGKey(seed)


def test_chol_solve_matches():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(5, 6, 6)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + 6 * np.eye(6, dtype=np.float32)
    b = rng.normal(size=(5, 6)).astype(np.float32)
    want = jpriors.chol_solve(jax.lax.linalg.cholesky(jnp.asarray(A)),
                              jnp.asarray(b))
    got = tpriors.chol_solve(tpriors.cholesky(torch.from_numpy(A)),
                             torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("seed,df", [(0, 12.0), (7, 60.0)])
def test_sample_wishart_matches(seed, df):
    rng = np.random.default_rng(seed)
    S = rng.normal(size=(4, 4)).astype(np.float32)
    L = np.linalg.cholesky(S @ S.T + 4 * np.eye(4)).astype(np.float32)
    jk, tk = _keys(seed)
    with jax.threefry_partitionable(False):
        want = jpriors.sample_wishart(jk, jnp.asarray(L), jnp.float32(df))
    got = tpriors.sample_wishart(tk, torch.from_numpy(L),
                                 torch.tensor(df, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("seed,N,K", [(0, 48, 4), (3, 200, 8),
                                      (9, 30, 16)])
def test_normal_prior_sample_hyper_matches(seed, N, K):
    F = np.random.default_rng(seed).normal(size=(N, K)).astype(np.float32)
    jp, tp = jpriors.NormalPrior(K), tpriors.NormalPrior(K)
    jk, tk = _keys(seed)
    with jax.threefry_partitionable(False):
        want = jp.sample_hyper(jk, jnp.asarray(F), jp.init(jk, N))
    got = tp.sample_hyper(tk, torch.from_numpy(F), tp.init(tk, N, "cpu"))
    for name in ("mu", "Lambda"):
        np.testing.assert_allclose(got[name].numpy(),
                                   np.asarray(want[name]), **TOL)
    np.testing.assert_allclose(tp.mean_term(got, N).numpy(),
                               np.asarray(jp.mean_term(want, N)), **TOL)


def _residuals(seed, n):
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=n).astype(np.float32)
    pred = (vals + 0.4 * rng.normal(size=n)).astype(np.float32)
    mask = (rng.random(n) > 0.2).astype(np.float32)
    return vals, pred, mask


@pytest.mark.parametrize("seed,n", [(0, 50), (1, 3000)])
def test_adaptive_gaussian_matches(seed, n):
    vals, pred, mask = _residuals(seed, n)
    jn = jnoise.AdaptiveGaussian()
    tn = tnoise.AdaptiveGaussian()
    jk, tk = _keys(seed)
    with jax.threefry_partitionable(False):
        want = jn.sample_state(jk, jn.init(), jnp.asarray(pred),
                               jnp.asarray(vals), jnp.asarray(mask))
    got = tn.sample_state(tk, tn.init("cpu"), torch.from_numpy(pred),
                          torch.from_numpy(vals), torch.from_numpy(mask))
    np.testing.assert_allclose(float(got["alpha"]), float(want["alpha"]),
                               **TOL)


def test_adaptive_gaussian_keeps_alpha_without_data():
    vals, pred, _ = _residuals(2, 20)
    tn = tnoise.AdaptiveGaussian(sn_init=3.0)
    got = tn.sample_state(trandom.PRNGKey(0), tn.init("cpu"),
                          torch.from_numpy(pred), torch.from_numpy(vals),
                          torch.zeros(20))
    assert float(got["alpha"]) == 3.0


def test_fixed_gaussian_is_identity():
    vals, pred, mask = _residuals(4, 10)
    tn = tnoise.FixedGaussian(2.5)
    st = tn.init("cpu")
    assert tn.sample_state(None, st, pred, vals, mask) is st
    v, alpha = tn.augment(None, st, None, vals, mask)
    assert v is vals and float(alpha) == 2.5
    assert float(st["alpha"]) == float(jnoise.FixedGaussian(2.5).init()[
        "alpha"])
