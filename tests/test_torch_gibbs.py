"""The port's Gibbs sweep against ``repro.core.gibbs``.

* conditional parity: on a shared fixed factor, the per-row Gram, rhs
  and posterior mean equal a dense per-row loop and the reference's
  (as ``tests/test_gibbs_reference.py`` does for the JAX package);
* one sweep from a state carried across by ``repro_torch.convert``:
  factors at rtol 1e-4 (fp32 Cholesky and solves in another order, and
  the few-ulp normal draws);
* the golden ``gaussian`` chain, against ``results/golden_chains.json``
  and against a live JAX run, at the golden-chain tolerance rtol 1e-3 /
  atol 1e-5.

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
from repro_torch import convert
from repro_torch import core as tc
from repro_torch import random as trandom
from repro_torch.core import gibbs as tgibbs
from torch_threads import _one_thread  # noqa: F401 (autouse)

FIXTURE = os.path.join(os.path.dirname(__file__), "..", "results",
                       "golden_chains.json")
CHAIN_TOL = dict(rtol=1e-3, atol=1e-5)


def _coo(n, m, nnz, seed):
    rng = np.random.default_rng(seed)
    flat = rng.choice(n * m, size=nnz, replace=False)
    i, j = np.divmod(flat, m)
    return i, j, rng.normal(size=nnz).astype(np.float32)


def _models(n, m, K, noise_j, noise_t):
    jm = jc.ModelDef((jc.EntityDef("rows", n, jc.NormalPrior(K)),
                      jc.EntityDef("cols", m, jc.NormalPrior(K))),
                     (jc.BlockDef(0, 1, noise_j, sparse=True),), K, False)
    tm = tc.ModelDef((tc.EntityDef("rows", n, tc.NormalPrior(K)),
                      tc.EntityDef("cols", m, tc.NormalPrior(K))),
                     (tc.BlockDef(0, 1, noise_t, sparse=True),), K,
                     device="cpu")
    return jm, tm


@pytest.mark.parametrize("as_row", [True, False])
def test_conditional_gram_rhs_and_mean_match(as_row):
    n, m, K, alpha = 40, 25, 5, 2.0
    i, j, v = _coo(n, m, 300, 0)
    jmat = jc.from_coo(i, j, v, (n, m))
    tmat = tc.from_coo(i, j, v, (n, m), device="cpu")
    rng = np.random.default_rng(1)
    fixed = rng.normal(size=(m if as_row else n, K)).astype(np.float32)
    jm, tm = _models(n, m, K, jc.FixedGaussian(alpha),
                     tc.FixedGaussian(alpha))
    jn, tn = jm.blocks[0].noise, tm.blocks[0].noise
    jg, jr = jgibbs._sparse_contrib(jm, jmat, as_row, jnp.asarray(fixed),
                                    None, jn, jn.init(),
                                    jax.random.PRNGKey(0))
    tg, tr = tgibbs._sparse_contrib(tmat, as_row, torch.from_numpy(fixed),
                                    tn, tn.init("cpu"), trandom.PRNGKey(0))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5,
                               atol=1e-5)
    ids, other = (i, j) if as_row else (j, i)
    eye = np.eye(K, dtype=np.float32)
    means = tc.priors.chol_solve(
        tc.priors.cholesky(tg + torch.from_numpy(eye)), tr).numpy()
    for r in range(tg.shape[0]):
        sel = ids == r
        vs = fixed[other[sel]]
        A = alpha * (vs.T @ vs) + eye
        b = alpha * (v[sel] @ vs)
        np.testing.assert_allclose(tg[r].numpy(), alpha * (vs.T @ vs),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(means[r], np.linalg.solve(A, b),
                                   rtol=1e-3, atol=1e-4)


def test_init_state_matches():
    K = 6
    jm, tm = _models(20, 15, K, jc.AdaptiveGaussian(),
                     tc.AdaptiveGaussian())
    with jax.threefry_partitionable(False):
        js = jgibbs.init_state(jm, None, seed=4)
    ts = tgibbs.init_state(tm, None, seed=4)
    assert np.array_equal(np.asarray(js.key).astype(np.int64),
                          ts.key.numpy())
    for a, b in zip(js.factors, ts.factors):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)
    assert float(ts.noises[0]["alpha"]) == float(js.noises[0]["alpha"])
    assert ts.step == 0


def test_one_sweep_from_carried_state_matches():
    n, m, K = 36, 28, 4
    i, j, v = _coo(n, m, 400, 2)
    jm, tm = _models(n, m, K, jc.AdaptiveGaussian(), tc.AdaptiveGaussian())
    jdata = jc.MFData((jc.from_coo(i, j, v, (n, m)),), (None, None))
    with jax.threefry_partitionable(False):
        st = jgibbs.init_state(jm, jdata, seed=9)
        # move the reference chain away from its initial state first
        st, _ = jgibbs.gibbs_step(jm, jdata, st)
        want, wm = jgibbs.gibbs_step(jm, jdata, st)
    tstate = convert.state_from_reference(
        st.key, st.factors, st.hypers, st.noises, st.step, device="cpu")
    tdata = convert.data_from_reference(jdata.blocks, jdata.sides,
                                        device="cpu")
    got, gm = tgibbs.gibbs_step(tm, tdata, tstate)
    for a, b in zip(want.factors, got.factors):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-5)
    for name in ("mu", "Lambda"):
        for a, b in zip(want.hypers, got.hypers):
            np.testing.assert_allclose(b[name].numpy(),
                                       np.asarray(a[name]), rtol=1e-4,
                                       atol=1e-5)
    assert np.array_equal(np.asarray(want.key).astype(np.int64),
                          got.key.numpy())
    assert got.step == int(want.step)
    for name in ("rmse_train_0", "alpha_0"):
        np.testing.assert_allclose(float(gm[name]), float(wm[name]),
                                   rtol=1e-4)


def _golden_port_chain(sweeps, seed):
    mat, _, _ = tc.random_sparse(seed, (48, 32), 0.3, rank=3, device="cpu")
    _, tm = _models(48, 32, 4, jc.AdaptiveGaussian(), tc.AdaptiveGaussian())
    data = tc.MFData((mat,), (None, None))
    state = tc.init_state(tm, data, seed=seed)
    state, trace = tc.run_sweeps(tm, data, state, sweeps)
    assert state.step == sweeps
    return {"rmse_train": trace["rmse_train_0"].tolist(),
            "alpha": trace["alpha_0"].tolist()}


def test_golden_gaussian_chain_replays_fixture_and_live_jax():
    with open(FIXTURE) as f:
        golden = json.load(f)
    seed, sweeps = golden["seed"], golden["sweeps"]
    got = _golden_port_chain(sweeps, seed)
    mat, _, _ = jc.sparse.random_sparse(seed, (48, 32), 0.3, rank=3)
    jm, _ = _models(48, 32, 4, jc.AdaptiveGaussian(), tc.AdaptiveGaussian())
    jdata = jc.MFData((mat,), (None, None))
    live = {"rmse_train": [], "alpha": []}
    with jax.threefry_partitionable(False):
        st = jgibbs.init_state(jm, jdata, seed=seed)
        for _ in range(sweeps):
            st, m = jgibbs.gibbs_step(jm, jdata, st)
            live["rmse_train"].append(float(m["rmse_train_0"]))
            live["alpha"].append(float(m["alpha_0"]))
    for key in ("rmse_train", "alpha"):
        np.testing.assert_allclose(got[key], golden["chains"]["gaussian"][
            key], **CHAIN_TOL, err_msg=f"fixture {key}")
        np.testing.assert_allclose(got[key], live[key], **CHAIN_TOL,
                                   err_msg=f"live {key}")


def test_two_blocks_sharing_an_entity_match_reference():
    """Three entities and two sparse blocks that share the row entity:
    its update runs the gathered Gram twice, the second with the first
    block's Gram as acc and Lambda_p folded in.  Four sweeps from the
    same seed on both sides, metrics and factors at the golden-chain
    tolerance."""
    n, m1, m2, K = 30, 22, 17, 4
    blocks = []
    for (m, nnz, seed) in ((m1, 200, 5), (m2, 150, 6)):
        i, j, v = _coo(n, m, nnz, seed)
        blocks.append((i, j, v, m))
    jents = (jc.EntityDef("rows", n, jc.NormalPrior(K)),
             jc.EntityDef("c1", m1, jc.NormalPrior(K)),
             jc.EntityDef("c2", m2, jc.NormalPrior(K)))
    tents = (tc.EntityDef("rows", n, tc.NormalPrior(K)),
             tc.EntityDef("c1", m1, tc.NormalPrior(K)),
             tc.EntityDef("c2", m2, tc.NormalPrior(K)))
    jm = jc.ModelDef(jents, (jc.BlockDef(0, 1, jc.AdaptiveGaussian(),
                                         sparse=True),
                             jc.BlockDef(0, 2, jc.AdaptiveGaussian(),
                                         sparse=True)), K, False)
    tm = tc.ModelDef(tents, (tc.BlockDef(0, 1, tc.AdaptiveGaussian(),
                                         sparse=True),
                             tc.BlockDef(0, 2, tc.AdaptiveGaussian(),
                                         sparse=True)), K, device="cpu")
    jdata = jc.MFData(tuple(jc.from_coo(i, j, v, (n, m))
                            for i, j, v, m in blocks), (None,) * 3)
    tdata = tc.MFData(tuple(tc.from_coo(i, j, v, (n, m), device="cpu")
                            for i, j, v, m in blocks), (None,) * 3)
    sweeps = 4
    with jax.threefry_partitionable(False):
        st = jgibbs.init_state(jm, jdata, seed=3)
        jtrace = []
        for _ in range(sweeps):
            st, mt = jgibbs.gibbs_step(jm, jdata, st)
            jtrace.append({k: float(v) for k, v in mt.items()})
    ts = tc.init_state(tm, tdata, seed=3)
    for s in range(sweeps):
        ts, mt = tgibbs.gibbs_step(tm, tdata, ts)
        for key, want in jtrace[s].items():
            np.testing.assert_allclose(float(mt[key]), want, **CHAIN_TOL,
                                       err_msg=f"sweep {s} {key}")
    for a, b in zip(st.factors, ts.factors):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **CHAIN_TOL)
