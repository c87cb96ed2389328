"""Probit noise and the gathered SDDMM entry of the port against
``repro``.

* ``row_uniforms`` and ``row_bernoulli``: bitwise (threefry bits and
  ``uniform`` are bitwise);
* ``noise.erf``: bitwise ``jax.lax.erf`` (XLA's f32 polynomial with its
  fused multiply-adds);
* ``ProbitNoise.augment``: within 1e-5 plus 16 ulps of the uniform
  carried through the inverse CDF, ``sqrt(2 pi) exp((z - pred)^2 / 2)``
  times 16 * 2^-23.  The truncated normal's inverse CDF is steep in its
  tails, where the few-ulp difference of ``random.erf_inv`` (torch's
  ``log1p`` is not XLA's) grows by that factor; where it stays below
  1e-3, the latents also take their observation's sign and 99% of them
  agree within 1e-5;
* the probit contributions to the factor update (sparse and dense
  blocks, predictions of realistic size) at rtol 1e-4 / atol 1e-4, the
  golden ``probit`` chain and a probit session at the golden-chain
  tolerance rtol 1e-3 / atol 1e-5;
* ``ops.gathered_sddmm`` on the CPU: bitwise ``index_select`` +
  ``sddmm_ref``, the pipeline it replaces; ``ops.gathered_sddmm_padded``
  (probit's padded predictions) bitwise that pipeline over the slot
  rows, and against the reference's padded prediction (``einsum`` over
  the gathered slab) and its ``ops.sddmm`` (jnp oracle and Pallas in
  interpret mode) at rtol 1e-5 of the sum of the terms' magnitudes plus
  atol 1e-5: fp32 sums in another order;
* the probe operands of ``ops.KERNELS["sddmm_gathered"]``: sorted runs
  of the asked lengths over distinct rows.

Every JAX call runs inside ``jax.threefry_partitionable(False)``.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
from repro.core import gibbs as jgibbs
from repro.core import noise as jnoise
from repro.kernels import ops as jops
from repro_torch import random as trandom
from repro_torch import core as tc
from repro_torch.core import gibbs as tgibbs
from repro_torch.core import noise as tnoise
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from torch_threads import _one_thread  # noqa: F401 (autouse)

FIXTURE = os.path.join(os.path.dirname(__file__), "..", "results",
                       "golden_chains.json")
CHAIN_TOL = dict(rtol=1e-3, atol=1e-5)
CONTRIB_TOL = dict(rtol=1e-4, atol=1e-4)
EPS = 1e-7


@pytest.mark.parametrize("n,width,offset", [(1, 1, 0), (7, 9, 3),
                                            (33, 64, 1000)])
def test_row_uniforms_are_bitwise(n, width, offset):
    with jax.threefry_partitionable(False):
        want = np.asarray(jgibbs.row_uniforms(
            jax.random.PRNGKey(5), n, width, offset, minval=EPS,
            maxval=1.0 - EPS))
    got = tgibbs.row_uniforms(trandom.PRNGKey(5), n, width, offset,
                              minval=EPS, maxval=1.0 - EPS).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("shape,offset", [((9,), 0), ((6, 4), 2),
                                          ((40, 1), 7)])
def test_row_bernoulli_is_bitwise(shape, offset):
    p = np.random.default_rng(0).random(shape).astype(np.float32)
    with jax.threefry_partitionable(False):
        want = np.asarray(jgibbs.row_bernoulli(jax.random.PRNGKey(8),
                                               jnp.asarray(p), offset))
    got = tgibbs.row_bernoulli(trandom.PRNGKey(8), torch.from_numpy(p),
                               offset).numpy()
    assert np.array_equal(got, want)


def test_erf_is_bitwise_xla():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=100_000) * 2,
                        rng.uniform(-6, 6, 100_000),
                        np.linspace(-5, 5, 20_001),
                        [0.0, -0.0, 3.7439211, 3.7439213, 1e30, -1e30]]
                       ).astype(np.float32)
    want = np.asarray(jax.lax.erf(jnp.asarray(x)))
    got = tnoise.erf(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want)


def _augment_inputs(R, T, seed):
    rng = np.random.default_rng(seed)
    pred = (rng.normal(size=(R, T)) * 2).astype(np.float32)
    vals = (rng.random((R, T)) > 0.5).astype(np.float32)
    mask = (rng.random((R, T)) > 0.2).astype(np.float32)
    return pred, vals, mask


@pytest.mark.parametrize("R,T,offset", [(50, 16, 4), (300, 40, 0)])
def test_probit_augment_matches_reference(R, T, offset):
    pred, vals, mask = _augment_inputs(R, T, R)
    jn = jnoise.ProbitNoise()
    with jax.threefry_partitionable(False):
        zj, aj = jn.augment(jax.random.PRNGKey(5), jn.init(),
                            jnp.asarray(pred), jnp.asarray(vals),
                            jnp.asarray(mask), row_offset=offset)
    tn = tnoise.ProbitNoise()
    zt, at = tn.augment(trandom.PRNGKey(5), tn.init("cpu"),
                        torch.from_numpy(pred), torch.from_numpy(vals),
                        torch.from_numpy(mask), row_offset=offset)
    zj, zt = np.asarray(zj), zt.numpy()
    assert float(at) == float(aj) == 1.0
    assert np.all(zt[mask == 0] == 0)
    # 16 ulps of the uniform through the inverse CDF's slope
    slope = np.sqrt(2 * np.pi) * np.exp(
        np.minimum((zj.astype(np.float64) - pred) ** 2 / 2, 700))
    tol = 1e-5 + 16 * 2.0 ** -23 * slope
    diff = np.abs(zt - zj)
    assert np.all(diff <= tol), np.max(diff - tol)
    tame = (tol < 1e-3) & (mask == 1)
    assert np.all((zt > 0)[tame] == (vals > 0.5)[tame])
    assert np.mean(diff[tame] <= 1e-5) >= 0.99


@pytest.mark.parametrize("as_row", [True, False])
def test_probit_sparse_contrib_matches_reference(as_row):
    """The latents drawn around the gathered-sddmm predictions at every
    padded slot, then the Gram at alpha = 1."""
    n, m, K = 40, 25, 5
    rng = np.random.default_rng(2)
    flat = rng.choice(n * m, size=300, replace=False)
    i, j = np.divmod(flat, m)
    v = (rng.random(300) > 0.5).astype(np.float32)
    # factor rows of scale 0.5: predictions of about N(0, 1.25)
    fixed = (0.5 * rng.normal(size=(m if as_row else n, K))).astype(
        np.float32)
    u = (0.5 * rng.normal(size=(n if as_row else m, K))).astype(np.float32)
    jm = jc.ModelDef((jc.EntityDef("r", n, jc.NormalPrior(K)),
                      jc.EntityDef("c", m, jc.NormalPrior(K))),
                     (jc.BlockDef(0, 1, jc.ProbitNoise(), sparse=True),),
                     K, False)
    jn, tn = jnoise.ProbitNoise(), tnoise.ProbitNoise()
    with jax.threefry_partitionable(False):
        jg, jr = jgibbs._sparse_contrib(
            jm, jc.from_coo(i, j, v, (n, m)), as_row, jnp.asarray(fixed),
            jnp.asarray(u), jn, jn.init(), jax.random.PRNGKey(3))
    tg, tr = tgibbs._sparse_contrib(
        tc.from_coo(i, j, v, (n, m), device="cpu"), as_row,
        torch.from_numpy(fixed), tn, tn.init("cpu"), trandom.PRNGKey(3),
        u_cur=torch.from_numpy(u))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **CONTRIB_TOL)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **CONTRIB_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_probit_dense_contrib_matches_reference(masked):
    R, C, K = 20, 14, 3
    rng = np.random.default_rng(4)
    X = (rng.random((R, C)) > 0.5).astype(np.float32)
    M = (rng.random((R, C)) > 0.3).astype(np.float32) if masked else None
    fixed = (0.5 * rng.normal(size=(C, K))).astype(np.float32)
    u = (0.5 * rng.normal(size=(R, K))).astype(np.float32)
    jn, tn = jnoise.ProbitNoise(), tnoise.ProbitNoise()
    with jax.threefry_partitionable(False):
        want = jgibbs._dense_contrib(jc.dense_block(X, M), True,
                                     jnp.asarray(fixed), jnp.asarray(u), jn,
                                     jn.init(), jax.random.PRNGKey(6))
    got = tgibbs._dense_contrib(tc.dense_block(X, M, device="cpu"), True,
                                torch.from_numpy(fixed),
                                torch.from_numpy(u), tn, tn.init("cpu"),
                                trandom.PRNGKey(6))
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       **CONTRIB_TOL)


@pytest.mark.parametrize("E,K,n_u,n_v", [(0, 8, 3, 3), (1, 1, 1, 1),
                                         (1025, 200, 97, 61),
                                         (4096, 128, 4096, 4096)])
def test_gathered_sddmm_cpu_is_the_pipeline_bitwise(E, K, n_u, n_v):
    rng = np.random.default_rng(E)
    U = torch.from_numpy(rng.normal(size=(n_u, K)).astype(np.float32))
    V = torch.from_numpy(rng.normal(size=(n_v, K)).astype(np.float32))
    i = torch.from_numpy(rng.integers(0, n_u, E).astype(np.int32))
    j = torch.from_numpy(rng.integers(0, n_v, E).astype(np.int32))
    got = tops.gathered_sddmm(U, V, i, j)
    want = tref.sddmm_ref(U.index_select(0, i), V.index_select(0, j))
    assert got.shape == (E,)
    assert torch.equal(got, want)


@pytest.mark.parametrize("R,T,K,n", [(5, 1, 33, 9), (7, 64, 128, 300),
                                     (3, 1144, 16, 100), (4, 0, 8, 3)])
def test_gathered_sddmm_padded_cpu_matches_jax_and_the_pipeline(R, T, K, n):
    rng = np.random.default_rng(R * T + K)
    u = rng.normal(size=(R, K)).astype(np.float32)
    fixed = rng.normal(size=(n, K)).astype(np.float32)
    idx = rng.integers(0, n, (R, T)).astype(np.int32)
    tu, tf, ti = (torch.from_numpy(a) for a in (u, fixed, idx))
    got = tops.gathered_sddmm_padded(tu, tf, ti)
    assert got.shape == (R, T)
    rows = tref.slot_rows(R, T, "cpu")
    assert torch.equal(rows, torch.from_numpy(
        np.repeat(np.arange(R, dtype=np.int32), T)))
    want = tref.sddmm_ref(tu.index_select(0, rows),
                          tf.index_select(0, ti.reshape(-1))).reshape(R, T)
    assert torch.equal(got, want)
    scale = np.einsum("rtk,rk->rt", np.abs(fixed)[idx], np.abs(u))
    i, j = rows.numpy(), idx.reshape(-1)
    with jax.threefry_partitionable(False):
        refs = [jnp.einsum("rtk,rk->rt", jnp.asarray(fixed)[idx],
                           jnp.asarray(u))]
        if R * T:
            refs += [jnp.reshape(jops.sddmm(
                jnp.asarray(u)[i], jnp.asarray(fixed)[j],
                use_pallas=pallas, interpret=True), (R, T))
                for pallas in (False, True)]
    for w in refs:
        assert np.all(np.abs(got.numpy() - np.asarray(w))
                      <= 1e-5 + 1e-5 * scale)


@pytest.mark.parametrize("label", list(tops.KERNELS["sddmm_gathered"]))
def test_gathered_sddmm_probe_operands(label):
    E, K, n_u, n_v, runs = tops.KERNELS["sddmm_gathered"][label]
    U, V, i, j = tops.gathered_sddmm_probe(E, K, n_u, n_v, runs, "cpu")
    assert U.shape == (n_u, K) and V.shape == (n_v, K)
    assert i.shape == j.shape == (E,)
    assert i.dtype == j.dtype == torch.int32
    assert 0 <= int(i.min()) and int(i.max()) < n_u
    assert 0 <= int(j.min()) and int(j.max()) < n_v
    rows, lengths = torch.unique_consecutive(i, return_counts=True)
    if runs is not None:
        lo, hi = (runs, runs) if isinstance(runs, int) else runs
        assert bool((rows[1:] > rows[:-1]).all())
        assert lo <= int(lengths[:-1].min()) and int(lengths.max()) <= hi
        if lo != hi:    # runs that end inside the kernel's 32-entry tiles
            ends = lengths.cumsum(0)[:-1] % 32
            assert bool((ends != 0).any())
    got = tops.gathered_sddmm(U, V, i, j)
    assert torch.equal(got, tref.sddmm_ref(U.index_select(0, i),
                                           V.index_select(0, j)))


def _probit_models(n, m, K):
    jm = jc.ModelDef((jc.EntityDef("r", n, jc.NormalPrior(K)),
                      jc.EntityDef("c", m, jc.NormalPrior(K))),
                     (jc.BlockDef(0, 1, jc.ProbitNoise(), sparse=True),),
                     K, False)
    tm = tc.ModelDef((tc.EntityDef("r", n, tc.NormalPrior(K)),
                      tc.EntityDef("c", m, tc.NormalPrior(K))),
                     (tc.BlockDef(0, 1, tc.ProbitNoise(), sparse=True),),
                     K, device="cpu")
    return jm, tm


def test_golden_probit_chain_replays_fixture_and_live_jax():
    with open(FIXTURE) as f:
        golden = json.load(f)
    seed, sweeps = golden["seed"], golden["sweeps"]
    jm, tm = _probit_models(48, 32, 4)
    jmat, _, _ = jc.sparse.random_sparse(seed, (48, 32), 0.3, rank=3,
                                         binary=True)
    tmat, _, _ = tc.random_sparse(seed, (48, 32), 0.3, rank=3, binary=True,
                                  device="cpu")
    jdata = jc.MFData((jmat,), (None, None))
    tdata = tc.MFData((tmat,), (None, None))
    live, got = {"rmse_train": [], "alpha": []}, {"rmse_train": [],
                                                  "alpha": []}
    with jax.threefry_partitionable(False):
        st = jgibbs.init_state(jm, jdata, seed=seed)
        for _ in range(sweeps):
            st, m = jgibbs.gibbs_step(jm, jdata, st)
            live["rmse_train"].append(float(m["rmse_train_0"]))
            live["alpha"].append(float(m["alpha_0"]))
    ts = tc.init_state(tm, tdata, seed=seed)
    for _ in range(sweeps):
        ts, m = tc.gibbs_step(tm, tdata, ts)
        got["rmse_train"].append(float(m["rmse_train_0"]))
        got["alpha"].append(float(m["alpha_0"]))
    for key in ("rmse_train", "alpha"):
        np.testing.assert_allclose(got[key], golden["chains"]["probit"][key],
                                   **CHAIN_TOL, err_msg=f"fixture {key}")
        np.testing.assert_allclose(got[key], live[key], **CHAIN_TOL,
                                   err_msg=f"live {key}")
    for a, b in zip(st.factors, ts.factors):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **CHAIN_TOL)


def test_probit_train_session_matches_reference():
    """TrainSession with probit noise and a test set: train trace, test
    RMSE and the test AUC (reported for probit blocks only)."""
    n, m = 40, 30
    rng = np.random.default_rng(9)
    flat = rng.choice(n * m, size=500, replace=False)
    i, j = np.divmod(flat, m)
    v = (rng.random(500) > 0.5).astype(np.float32)
    test = (i[:60], j[:60], v[:60])
    runs = []
    for pkg, kw in ((jc, {}), (tc, {"device": "cpu"})):
        mat = pkg.from_coo(i[60:], j[60:], v[60:], (n, m), **kw)
        sess = pkg.TrainSession(num_latent=4, burnin=3, nsamples=3, seed=1,
                                **kw)
        sess.add_train_and_test(mat, test, noise=pkg.ProbitNoise())
        if pkg is jc:
            with jax.threefry_partitionable(False):
                runs.append(sess.run())
        else:
            runs.append(sess.run())
    jr, tr = runs
    np.testing.assert_allclose(tr.rmse_train_trace, jr.rmse_train_trace,
                               **CHAIN_TOL)
    np.testing.assert_allclose(tr.rmse_test, jr.rmse_test, **CHAIN_TOL)
    assert jr.auc_test is not None
    np.testing.assert_allclose(tr.auc_test, jr.auc_test, **CHAIN_TOL)
