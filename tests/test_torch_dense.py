"""Dense blocks, and the shared-precision factor draw, against
``repro``.

* ``dense_block``: the reference's ``fully`` rule (an all-ones mask is
  no mask); a fully observed block holds its masks as broadcast views;
  ``from_dense`` gives the reference's padded arrays;
* ``_dense_contrib`` (fully observed: one (K, K) Gram; masked: a Gram
  per row; both orientations) at rtol 1e-5 / atol 1e-5, and
  ``_dense_chunk_contrib`` summed over uneven chunks equal to the
  monolithic moments at rtol 1e-5 / atol 1e-5 (f32 summation order);
* an entity that no block touches takes the reference's shared branch,
  one (K, K) Cholesky: its draw at rtol 1e-5 / atol 1e-6;
* chains of 4 sweeps (masked dense, fully observed dense through
  ``TrainSession``, and dense plus sparse blocks sharing an entity) at
  the golden-chain tolerance rtol 1e-3 / atol 1e-5.

Every JAX call runs inside ``jax.threefry_partitionable(False)``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
from repro.core import gibbs as jgibbs
from repro_torch import random as trandom
from repro_torch import core as tc
from repro_torch.core import gibbs as tgibbs
from torch_threads import _one_thread  # noqa: F401 (autouse)

CHAIN_TOL = dict(rtol=1e-3, atol=1e-5)
MOMENT_TOL = dict(rtol=1e-5, atol=1e-5)


def _dense(R, C, seed, masked):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(R, C)).astype(np.float32)
    M = (rng.random((R, C)) > 0.3).astype(np.float32) if masked else None
    return X, M


def test_dense_block_layout():
    X, M = _dense(6, 4, 0, True)
    full = tc.dense_block(X, device="cpu")
    ones = tc.dense_block(X, np.ones_like(X), device="cpu")
    masked = tc.dense_block(X, M, device="cpu")
    assert full.fully and ones.fully and not masked.fully
    assert full.mask.stride() == (0, 0) and full.maskT.stride() == (0, 0)
    assert torch.equal(full.mask, torch.ones(6, 4))
    assert full.XT.is_contiguous() and torch.equal(full.XT, full.X.T)
    assert torch.equal(masked.maskT, torch.from_numpy(M.T))
    assert full.shape == (6, 4) and float(masked.nnz) == M.sum()
    assert full.oriented(False)[0] is full.XT


def test_from_dense_matches_reference():
    X, _ = _dense(7, 5, 1, False)
    X[X < 0] = 0.0
    for keep in (False, True):
        want = jc.sparse.from_dense(X, keep_zeros=keep)
        got = tc.sparse.from_dense(X, keep_zeros=keep, device="cpu")
        for name in ("coo_i", "coo_j", "coo_v", "coo_mask"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)))
        np.testing.assert_array_equal(got.rows.idx.numpy(),
                                      np.asarray(want.rows.idx))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("as_row", [True, False])
def test_dense_contrib_matches_reference(masked, as_row):
    R, C, K = 18, 13, 4
    X, M = _dense(R, C, 2, masked)
    rng = np.random.default_rng(3)
    fixed = rng.normal(size=(C if as_row else R, K)).astype(np.float32)
    jn, tn = jc.FixedGaussian(2.5), tc.FixedGaussian(2.5)
    want = jgibbs._dense_contrib(jc.dense_block(X, M), as_row,
                                 jnp.asarray(fixed), None, jn, jn.init(),
                                 None)
    got = tgibbs._dense_contrib(tc.dense_block(X, M, device="cpu"), as_row,
                                torch.from_numpy(fixed), None, tn,
                                tn.init("cpu"), None)
    assert (got[0] is None) == masked and (got[1] is None) != masked
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       **MOMENT_TOL)


@pytest.mark.parametrize("fully", [True, False])
@pytest.mark.parametrize("cuts", [(0, 13), (0, 1, 13), (0, 5, 6, 11, 13)])
def test_dense_chunk_contrib_sums_over_uneven_chunks(fully, cuts):
    R, C, K = 9, 13, 3
    X, M = _dense(R, C, 4, not fully)
    m = np.ones_like(X) if fully else M
    fixed = np.random.default_rng(5).normal(size=(C, K)).astype(np.float32)
    tsum = [None, None, None]
    jsum = [None, None, None]
    for a, b in zip(cuts[:-1], cuts[1:]):
        tparts = tgibbs._dense_chunk_contrib(
            torch.from_numpy(X), torch.from_numpy(m), fully,
            torch.from_numpy(fixed[a:b]), a)
        jparts = jgibbs._dense_chunk_contrib(
            jnp.asarray(X), jnp.asarray(m), fully, jnp.asarray(fixed[a:b]),
            a)
        for acc, parts in ((tsum, tparts), (jsum, jparts)):
            for n, p in enumerate(parts):
                if p is not None:
                    p = np.asarray(p)
                    acc[n] = p if acc[n] is None else acc[n] + p
    tn = tc.FixedGaussian(1.0)
    whole = tgibbs._dense_contrib(tc.dense_block(X, None if fully else M,
                                                 device="cpu"),
                                  True, torch.from_numpy(fixed), None, tn,
                                  tn.init("cpu"), None)
    for t, j, w in zip(tsum, jsum, whole):
        assert (t is None) == (j is None) == (w is None)
        if t is not None:
            np.testing.assert_allclose(t, w.numpy(), **MOMENT_TOL)
            np.testing.assert_allclose(t, j, **MOMENT_TOL)


def test_entity_without_blocks_takes_the_shared_branch():
    """No block touches entity 2: one Cholesky of Lambda_p, the mean
    term through matrix solves, as ``repro``'s shared branch does."""
    n, m, lone, K = 12, 9, 7, 3
    rng = np.random.default_rng(6)
    flat = rng.choice(n * m, size=50, replace=False)
    i, j = np.divmod(flat, m)
    v = rng.normal(size=50).astype(np.float32)
    models = {}
    for pkg, kw in ((jc, {}), (tc, {"device": "cpu"})):
        b = pkg.ModelBuilder(K, **kw)
        b.add_entity("r", n).add_entity("c", m).add_entity("lone", lone)
        b.add_block("r", "c", pkg.from_coo(i, j, v, (n, m), **kw))
        models[pkg] = b.build()
    jm, jdata, _ = models[jc]
    tm, tdata, _ = models[tc]
    with jax.threefry_partitionable(False):
        st = jgibbs.init_state(jm, jdata, seed=1)
        st, _ = jgibbs.gibbs_step(jm, jdata, st)
        want, _ = jgibbs._entity_update(jm, jdata, jax.random.PRNGKey(4), 2,
                                        st.factors, st.hypers, st.noises)
    ts = tc.init_state(tm, tdata, seed=1)
    ts, _ = tc.gibbs_step(tm, tdata, ts)
    got, _ = tgibbs._entity_update(tm, tdata, trandom.PRNGKey(4), 2,
                                   ts.factors, ts.hypers, ts.noises)
    assert got.shape == (lone, K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    # the shared branch itself, on the same precision and rhs
    rng = np.random.default_rng(7)
    A = rng.normal(size=(K, K)).astype(np.float32)
    lam = (A @ A.T + K * np.eye(K)).astype(np.float32)
    rhs = rng.normal(size=(lone, K)).astype(np.float32)
    bp = rng.normal(size=K).astype(np.float32)
    with jax.threefry_partitionable(False):
        jd = jgibbs._sample_normal_factor(jax.random.PRNGKey(2),
                                          jnp.asarray(lam), None,
                                          jnp.asarray(rhs),
                                          jnp.zeros((K, K)), jnp.asarray(bp))
    td = tgibbs._sample_normal_factor(trandom.PRNGKey(2),
                                      torch.from_numpy(rhs),
                                      torch.from_numpy(bp),
                                      Lam_shared=torch.from_numpy(lam))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-6)


def _run(pkg, build, sweeps, seed, **kw):
    model, data, _ = build(pkg, **kw)
    st = pkg.init_state(model, data, seed=seed)
    trace = []
    for _ in range(sweeps):
        st, m = pkg.gibbs_step(model, data, st)
        trace.append({k: float(v) for k, v in m.items()})
    return trace, st


def _chains_match(build, sweeps=4, seed=2):
    with jax.threefry_partitionable(False):
        jtrace, jst = _run(jc, build, sweeps, seed)
    ttrace, tst = _run(tc, build, sweeps, seed, device="cpu")
    for s, (jt, tt) in enumerate(zip(jtrace, ttrace)):
        assert set(jt) == set(tt)
        for key, want in jt.items():
            np.testing.assert_allclose(tt[key], want, **CHAIN_TOL,
                                       err_msg=f"sweep {s} {key}")
    for a, b in zip(jst.factors, tst.factors):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **CHAIN_TOL)


def test_masked_dense_chain_matches_reference():
    X, M = _dense(20, 15, 8, True)

    def build(pkg, **kw):
        b = pkg.ModelBuilder(3, **kw).add_entity("r", 20).add_entity("c", 15)
        b.add_block("r", "c", X, mask=M, noise=pkg.AdaptiveGaussian())
        return b.build()

    _chains_match(build)


def test_fully_observed_train_session_matches_reference():
    X, _ = _dense(24, 10, 9, False)
    runs = []
    for pkg, kw in ((jc, {}), (tc, {"device": "cpu"})):
        sess = pkg.TrainSession(num_latent=3, burnin=2, nsamples=2, seed=4,
                                **kw)
        sess.add_train_and_test(X, noise=pkg.AdaptiveGaussian())
        if pkg is jc:
            with jax.threefry_partitionable(False):
                runs.append(sess.run())
        else:
            runs.append(sess.run())
    np.testing.assert_allclose(runs[1].rmse_train_trace,
                               runs[0].rmse_train_trace, **CHAIN_TOL)


def test_dense_and_sparse_blocks_sharing_an_entity_match_reference():
    """Entity "r" takes a per-row Gram from a sparse block, a shared Gram
    from a fully observed block and a per-row Gram from a masked one:
    the reference's ``gram_rows + (gram_shared + Lambda_p)``."""
    n, m = 16, 11
    rng = np.random.default_rng(10)
    flat = rng.choice(n * m, size=70, replace=False)
    i, j = np.divmod(flat, m)
    v = rng.normal(size=70).astype(np.float32)
    Xf, _ = _dense(n, 6, 11, False)
    Xm, Mm = _dense(n, 5, 12, True)

    def build(pkg, **kw):
        b = pkg.ModelBuilder(3, **kw)
        for name, size in (("r", n), ("s", m), ("f", 6), ("d", 5)):
            b.add_entity(name, size)
        b.add_block("r", "s", pkg.from_coo(i, j, v, (n, m), **kw),
                    noise=pkg.AdaptiveGaussian())
        b.add_block("r", "f", Xf, noise=pkg.FixedGaussian(2.0))
        b.add_block("d", "r", Xm.T, mask=Mm.T, noise=pkg.AdaptiveGaussian())
        return b.build()

    _chains_match(build)
