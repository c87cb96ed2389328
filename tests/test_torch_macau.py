"""The Macau prior (side information) of the port against ``repro``.

* ``MacauPrior.sample_hyper`` from the same key, factor, side matrix and
  hyper-state: mu, Lambda, beta and beta_prec at rtol 1e-4 / atol 1e-5
  (fp32 Cholesky and solves in another order, few-ulp gamma and normal
  draws); ``mean_term``, ``predict_factor`` and ``_mn_col_mix`` at
  rtol 1e-5 / atol 1e-6;
* a 4-sweep Macau chain through ``ModelBuilder(side_info=)`` at the
  golden-chain tolerance rtol 1e-3 / atol 1e-5, and one sweep from a
  state carried over by ``repro_torch.convert`` (side information and
  Macau's ``beta``/``beta_prec`` included) at rtol 1e-4;
* side^T side computed once a session gives the chain of the per-sweep
  product bitwise;
* a Macau store written by either package loads in the other, and
  ``predict_new``/``cold_rows`` agree within the store tolerance rtol
  1e-5 / atol 1e-6; ``RecommendServer`` answers ``features=`` requests
  bitwise as sequential ``recommend(features=)`` calls do.

Every JAX call runs inside ``jax.threefry_partitionable(False)``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
from repro.core import gibbs as jgibbs
from repro.core import priors as jpriors
from repro_torch import convert
from repro_torch import random as trandom
from repro_torch import core as tc
from repro_torch.core import gibbs as tgibbs
from repro_torch.core import priors as tpriors
from repro_torch.launch.serve import RecommendServer
from torch_threads import _one_thread  # noqa: F401 (autouse)

CHAIN_TOL = dict(rtol=1e-3, atol=1e-5)
HYPER_TOL = dict(rtol=1e-4, atol=1e-5)
PRED_TOL = dict(rtol=1e-5, atol=1e-6)
N, M, D, K = 40, 30, 12, 4


def _side(n, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((n, d)) > 0.6).astype(np.float32)


def _coo(seed, n=N, m=M, nnz=300):
    rng = np.random.default_rng(seed)
    flat = rng.choice(n * m, size=nnz, replace=False)
    i, j = np.divmod(flat, m)
    return i, j, rng.normal(size=nnz).astype(np.float32)


def _hyper(seed, d=D, k=K):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(k, k)).astype(np.float32)
    return {"mu": rng.normal(size=k).astype(np.float32),
            "Lambda": (A @ A.T / k + np.eye(k)).astype(np.float32),
            "beta": (0.3 * rng.normal(size=(d, k))).astype(np.float32),
            "beta_prec": np.float32(3.5)}


def _j(h):
    return {k: jnp.asarray(v) for k, v in h.items()}


def _t(h):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in h.items()}


@pytest.mark.parametrize("sample_beta_precision", [True, False])
def test_macau_sample_hyper_matches_reference(sample_beta_precision):
    rng = np.random.default_rng(1)
    F = rng.normal(size=(N, K)).astype(np.float32)
    side = _side(N, D, 2)
    h = _hyper(3)
    jp = jpriors.MacauPrior(K, D,
                            sample_beta_precision=sample_beta_precision)
    tp = tpriors.MacauPrior(K, D,
                            sample_beta_precision=sample_beta_precision)
    with jax.threefry_partitionable(False):
        want = jp.sample_hyper(jax.random.PRNGKey(7), jnp.asarray(F), _j(h),
                               side=jnp.asarray(side))
    S = torch.from_numpy(side)
    got = tp.sample_hyper(trandom.PRNGKey(7), torch.from_numpy(F), _t(h),
                          side=S, FtF=S.T @ S)
    assert set(got) == set(want) == {"mu", "Lambda", "beta", "beta_prec"}
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   **HYPER_TOL, err_msg=name)


def test_macau_mean_term_predict_factor_and_col_mix_match():
    h = _hyper(4)
    side = _side(N, D, 5)
    F_new = _side(7, D, 6)
    jp, tp = jpriors.MacauPrior(K, D), tpriors.MacauPrior(K, D)
    np.testing.assert_allclose(
        tp.mean_term(_t(h), N, side=torch.from_numpy(side)).numpy(),
        np.asarray(jp.mean_term(_j(h), N, side=jnp.asarray(side))),
        **PRED_TOL)
    np.testing.assert_allclose(
        tp.predict_factor(_t(h), F_new).numpy(),
        np.asarray(jp.predict_factor(_j(h), F_new)), **PRED_TOL)
    L = np.linalg.cholesky(h["Lambda"]).astype(np.float32)
    Z = np.random.default_rng(8).normal(size=(D, K)).astype(np.float32)
    np.testing.assert_allclose(
        tpriors._mn_col_mix(torch.from_numpy(Z), torch.from_numpy(L)).numpy(),
        np.asarray(jpriors._mn_col_mix(jnp.asarray(Z), jnp.asarray(L))),
        **PRED_TOL)


def test_macau_init_and_mean_term_need_side():
    tp = tpriors.MacauPrior(K, D)
    h = tp.init(trandom.PRNGKey(0), N, "cpu")
    assert h["beta"].shape == (D, K) and float(h["beta_prec"]) == 5.0
    with pytest.raises(ValueError, match="side"):
        tp.mean_term(h, N)
    with pytest.raises(ValueError, match="side"):
        tp.sample_hyper(trandom.PRNGKey(0), torch.zeros(N, K), h)
    with pytest.raises(ValueError, match="FtF"):
        tp.sample_hyper(trandom.PRNGKey(0), torch.zeros(N, K), h,
                        side=torch.zeros(N, D))


def _builder(pkg, side, seed=5, **kw):
    i, j, v = _coo(seed)
    b = pkg.ModelBuilder(K, **kw)
    b.add_entity("compound", N, side_info=side, beta_precision=4.0)
    b.add_entity("protein", M)
    b.add_block("compound", "protein", pkg.from_coo(i, j, v, (N, M), **kw),
                noise=pkg.AdaptiveGaussian(), test=(i[:40], j[:40], v[:40]))
    return b


def test_macau_chain_matches_reference():
    side = _side(N, D, 9)
    sweeps = 4
    jm, jdata, _ = _builder(jc, side).build()
    tm, tdata, _ = _builder(tc, side, device="cpu").build()
    assert isinstance(tm.entities[0].prior, tpriors.MacauPrior)
    assert tm.entities[0].prior.beta_precision == 4.0
    with jax.threefry_partitionable(False):
        st = jgibbs.init_state(jm, jdata, seed=2)
        jtrace = []
        for _ in range(sweeps):
            st, m = jgibbs.gibbs_step(jm, jdata, st)
            jtrace.append({k: float(v) for k, v in m.items()})
    ts = tgibbs.init_state(tm, tdata, seed=2)
    for s in range(sweeps):
        ts, m = tgibbs.gibbs_step(tm, tdata, ts)
        for key, want in jtrace[s].items():
            np.testing.assert_allclose(float(m[key]), want, **CHAIN_TOL,
                                       err_msg=f"sweep {s} {key}")
    for a, b in zip(st.factors, ts.factors):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **CHAIN_TOL)
    for name in ("beta", "beta_prec", "mu", "Lambda"):
        np.testing.assert_allclose(ts.hypers[0][name].numpy(),
                                   np.asarray(st.hypers[0][name]),
                                   **CHAIN_TOL, err_msg=name)


def test_side_grams_are_held_with_the_data():
    """side^T side is computed once, where the data are made (the
    builder, ``data_from_reference``), and a sweep over side
    information without it raises rather than recomputing it."""
    side = _side(N, D, 10)
    S = torch.from_numpy(side)
    model, data, _ = _builder(tc, side, device="cpu").build()
    jdata = _builder(jc, side).build()[1]
    carried = convert.data_from_reference(jdata.blocks, jdata.sides,
                                          device="cpu")
    for d in (data, carried):
        assert d.side_grams[1] is None
        assert torch.equal(d.side_grams[0], S.T @ S)
    state = tgibbs.init_state(model, data, seed=1)
    with pytest.raises(ValueError, match="with_side_grams"):
        tgibbs.gibbs_step(model, data._replace(side_grams=None), state)


def test_one_sweep_from_carried_macau_state_matches():
    side = _side(N, D, 11)
    jm, jdata, _ = _builder(jc, side).build()
    tm, _, _ = _builder(tc, side, device="cpu").build()
    with jax.threefry_partitionable(False):
        st = jgibbs.init_state(jm, jdata, seed=4)
        for _ in range(2):
            st, _ = jgibbs.gibbs_step(jm, jdata, st)
        want, _ = jgibbs.gibbs_step(jm, jdata, st)
    tstate = convert.state_from_reference(st.key, st.factors, st.hypers,
                                          st.noises, st.step, device="cpu")
    tdata = convert.data_from_reference(jdata.blocks, jdata.sides,
                                        device="cpu")
    assert torch.equal(tdata.sides[0], torch.from_numpy(side))
    assert torch.equal(tstate.hypers[0]["beta"],
                       torch.from_numpy(np.asarray(st.hypers[0]["beta"])))
    got, _ = tgibbs.gibbs_step(tm, tdata, tstate)
    for a, b in zip(want.factors, got.factors):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-5)
    for name in ("beta", "beta_prec"):
        np.testing.assert_allclose(got.hypers[0][name].numpy(),
                                   np.asarray(want.hypers[0][name]),
                                   rtol=1e-4, atol=1e-5)


def test_builder_side_info_errors_match_reference():
    side = _side(N, D, 1)
    for call in (
            lambda pkg, kw: pkg.ModelBuilder(K, **kw).add_entity(
                "c", N, prior="spikeandslab", side_info=side),
            lambda pkg, kw: pkg.ModelBuilder(K, **kw).add_entity(
                "c", N + 1, side_info=side),
            lambda pkg, kw: pkg.TrainSession(**kw).add_side_info(2, side)):
        with pytest.raises(ValueError) as je:
            call(jc, {})
        with pytest.raises(ValueError) as te:
            call(tc, {"device": "cpu"})
        assert str(te.value) == str(je.value)


def _train_store(pkg, d, side, **kw):
    i, j, v = _coo(12)
    sess = pkg.TrainSession(num_latent=K, burnin=2, nsamples=5, seed=3,
                            save_freq=1, save_dir=str(d), **kw)
    sess.add_train_and_test(pkg.from_coo(i, j, v, (N, M), **kw))
    sess.add_side_info(0, side, beta_precision=2.0)
    if pkg is jc:
        with jax.threefry_partitionable(False):
            return sess.run()
    return sess.run()


@pytest.fixture(scope="module")
def macau_stores(tmp_path_factory):
    side = _side(N, D, 13)
    jd = tmp_path_factory.mktemp("jax_macau")
    td = tmp_path_factory.mktemp("port_macau")
    _train_store(jc, jd, side)
    _train_store(tc, td, side, device="cpu")
    return {"repro": str(jd), "port": str(td)}


@pytest.mark.parametrize("writer", ["repro", "port"])
def test_macau_store_loads_in_both_and_predicts_alike(macau_stores, writer):
    d = macau_stores[writer]
    F_new = _side(9, D, 14)
    p = tc.PredictSession(d, device="cpu")
    assert isinstance(p.model.entities[0].prior, tpriors.MacauPrior)
    with jax.threefry_partitionable(False):
        jp = jc.PredictSession(d)
        jpred = jp.predict_new("rows", F_new)
        jcold = np.asarray(jp.cold_rows(F_new))
    assert p.num_samples == jp.num_samples == 5
    np.testing.assert_allclose(p.predict_new("rows", F_new), jpred,
                               **PRED_TOL)
    cold = p.cold_rows(F_new)
    assert cold.shape == (9, 5, K)
    np.testing.assert_allclose(cold.numpy(), jcold, **PRED_TOL)
    # the lazy path (no resident cache) gives the same numbers
    lazy = tc.PredictSession(d, device="cpu", cache_bytes=0)
    np.testing.assert_allclose(lazy.predict_new("rows", F_new),
                               p.predict_new("rows", F_new), **PRED_TOL)
    np.testing.assert_array_equal(lazy.cold_rows(F_new).numpy(),
                                  cold.numpy())


def test_cold_start_errors_match_reference(macau_stores):
    d = macau_stores["port"]
    p = tc.PredictSession(d, device="cpu")
    with jax.threefry_partitionable(False):
        jp = jc.PredictSession(d)
    for call in (lambda s: s.predict_new("cols", np.zeros((2, D))),
                 lambda s: s.predict_new("rows", np.zeros((2, D + 1))),
                 lambda s: s.cold_rows(np.zeros((2, D)), block=("cols",
                                                                "rows"))):
        with pytest.raises(ValueError) as je:
            call(jp)
        with pytest.raises(ValueError) as te:
            call(p)
        assert str(te.value) == str(je.value)


def test_recommend_server_serves_features_bitwise_sequential(macau_stores):
    p = tc.PredictSession(macau_stores["port"], device="cpu")
    F = _side(6, D, 15)
    srv = RecommendServer(p, slots=4, k=5)
    ids = [srv.submit(features=F[b], exclude=[b]) for b in range(6)]
    ids.append(srv.submit(user=3))
    done = {r["id"]: r for r in srv.run()}
    for b in range(6):
        want = p.recommend(features=F[b], k=5, exclude=[b])
        got = done[ids[b]]
        for g, w in zip((got["ids"], got["mean"], got["std"]), want):
            np.testing.assert_array_equal(g, w[0])
    want = p.recommend(user=3, k=5)
    np.testing.assert_array_equal(done[ids[-1]]["ids"], want.ids[0])
