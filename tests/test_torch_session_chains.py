"""Several chains, resume and the result API of the port's sessions,
against ``repro.core.session`` and against the port itself.

Against the reference, on the same ``chembl_like`` data (bitwise the
same arrays in both packages), at the golden-chain tolerance rtol 1e-3 /
atol 1e-5:

* ``chains=3``: every chain's train trace (``chain_blocks``), the pooled
  test metrics and predictions, and split-R-hat / bulk-ESS;
* ``run(resume=True)`` for one chain and for three: ``resumed_from``
  and the traces of the sweeps after it; the errors of a resume without
  a store and of a resume past the end;
* ``resolve_chains`` with ``REPRO_CHAINS``, ``to_dict()``'s keys,
  ``PredictAccumulator.std``;
* a two-chain store written by either package pools the same in the
  other's ``PredictSession``.

Within the port, bitwise: chain c of a session is the single-chain run
keyed ``chain_keys(seed, C)[c]``, a resumed chain is the uninterrupted
one, and ``mean_from_samples`` is the run's ``predictions``.

Every JAX call runs inside ``jax.threefry_partitionable(False)``.
"""
import jax
import numpy as np
import pytest
import torch

import repro.core as jc
import repro_torch.core as tc
from repro.core import predict as jpredict
from repro.data.synthetic import chembl_like as j_chembl_like
from repro_torch.core import gibbs as tgibbs
from repro_torch.core import predict as tpredict
from repro_torch.data import chembl_like as t_chembl_like
from torch_threads import _one_thread  # noqa: F401 (autouse)

CHAIN_TOL = dict(rtol=1e-3, atol=1e-5)
# a reload replays the in-session accumulator over exact copies of the
# samples; the reference's reload tolerance
RELOAD_TOL = dict(rtol=1e-6, atol=1e-6)


def _data(seed=1, n=48, m=24):
    kw = dict(n_compounds=n, n_proteins=m, density=0.3, rank=3)
    jmat, test, F = j_chembl_like(seed, **kw)
    tmat, _, _ = t_chembl_like(seed, device="cpu", **kw)
    return jmat, tmat, test, F


def _train(pkg, mat, test, **kw):
    dev = {} if pkg is jc else {"device": "cpu"}
    s = pkg.TrainSession(num_latent=3, **dev, **kw)
    s.add_train_and_test(mat, test, noise=pkg.AdaptiveGaussian())
    return s


def _jax_run(sess, **kw):
    with jax.threefry_partitionable(False):
        return sess.run(**kw)


def _states_equal(a, b) -> bool:
    return (torch.equal(a.key, b.key) and a.step == b.step
            and all(torch.equal(x, y) for x, y in zip(a.factors, b.factors))
            and all(torch.equal(ha[k], hb[k])
                    for ha, hb in zip(a.hypers, b.hypers) for k in ha)
            and all(torch.equal(na[k], nb[k])
                    for na, nb in zip(a.noises, b.noises) for k in na))


def test_chembl_like_is_the_references_bitwise():
    kw = dict(n_compounds=60, n_proteins=20, density=0.2, rank=4,
              n_features=16)
    jmat, jtest, jF = j_chembl_like(3, **kw)
    tmat, ttest, tF = t_chembl_like(3, device="cpu", **kw)
    assert np.array_equal(jF, tF) and jF.dtype == tF.dtype
    for a, b in zip(jtest, ttest):
        assert np.array_equal(a, b) and a.dtype == b.dtype
    assert tuple(tmat.shape) == tuple(jmat.shape)
    n = int(jmat.nnz)
    assert int(tmat.nnz) == n
    for name in ("coo_i", "coo_j", "coo_v"):
        assert np.array_equal(getattr(tmat, name)[:n].numpy(),
                              np.asarray(getattr(jmat, name))[:n]), name
    for side in ("rows", "cols"):
        jp, tp = getattr(jmat, side), getattr(tmat, side)
        for f in ("idx", "val", "mask"):
            assert np.array_equal(getattr(tp, f).numpy(),
                                  np.asarray(getattr(jp, f))), (side, f)


def test_multi_chain_session_matches_reference():
    jmat, tmat, test, _ = _data()
    kw = dict(burnin=2, nsamples=4, seed=5, chains=3)
    jr = _jax_run(_train(jc, jmat, test, **kw))
    tr = _train(tc, tmat, test, **kw).run()
    assert tr.n_chains == jr.n_chains == 3
    assert len(tr.chain_blocks) == 3
    for c in range(3):
        assert tr.chain_blocks[c][0].entities == ("rows", "cols")
        np.testing.assert_allclose(tr.chain_blocks[c][0].rmse_train_trace,
                                   jr.chain_blocks[c][0].rmse_train_trace,
                                   **CHAIN_TOL)
    assert tr.rmse_train_trace == tr.chain_blocks[0][0].rmse_train_trace
    np.testing.assert_allclose(tr.rmse_test_trace, jr.rmse_test_trace,
                               **CHAIN_TOL)
    np.testing.assert_allclose(tr.rmse_test, jr.rmse_test, **CHAIN_TOL)
    np.testing.assert_allclose(tr.predictions, np.asarray(jr.predictions),
                               rtol=1e-3, atol=1e-4)
    assert tr.state.factors[0].shape == (3, 48, 3)
    jd, td = jr.diagnostics, tr.diagnostics
    assert (td.n_chains, td.n_draws) == (jd.n_chains, jd.n_draws) == (3, 4)
    assert set(td.rhat) == set(jd.rhat)
    for k in jd.rhat:
        np.testing.assert_allclose(td.rhat[k], jd.rhat[k], rtol=1e-3)
        np.testing.assert_allclose(td.ess[k], jd.ess[k], rtol=1e-3)
    assert np.isfinite(td.rhat["rmse_train_0"])


@pytest.mark.parametrize("c", [0, 1, 2])
def test_session_chain_is_the_single_chain_run_with_its_key(c):
    _, tmat, test, _ = _data(2)
    infos = []
    kw = dict(burnin=2, nsamples=3, seed=9)
    multi = _train(tc, tmat, test, chains=3, callbacks=[infos.append],
                   **kw).run()
    if c == 0:
        single = _train(tc, tmat, test, chains=1, **kw).run()
        assert single.n_chains == 1 and single.chain_blocks is None
        assert multi.rmse_train_trace == single.rmse_train_trace
        st = single.state
    else:
        model, data = _train(tc, tmat, test, **kw)._build()
        st = tgibbs.init_state(
            model, data, key=tgibbs.chain_keys(9, 3, "cpu")[c])
        trace = []
        for _ in range(5):
            st, m = tgibbs.gibbs_step(model, data, st)
            trace.append(float(m["rmse_train_0"]))
        assert multi.chain_blocks[c][0].rmse_train_trace == trace
    assert _states_equal(tgibbs.unstack_state(multi.state, c), st)
    # callbacks: metrics are chain 0's scalars, chain_metrics all chains'
    last = infos[-1]
    assert last.metrics["rmse_train_0"].dim() == 0
    assert last.chain_metrics["rmse_train_0"].shape == (3,)
    assert torch.equal(last.metrics["rmse_train_0"],
                       last.chain_metrics["rmse_train_0"][0])


@pytest.mark.parametrize("chains", [1, 3])
def test_resume_matches_reference_and_the_uninterrupted_chain(tmp_path,
                                                              chains):
    jmat, tmat, test, _ = _data(6)
    got = {}
    for name, pkg, mat in (("jax", jc, jmat), ("torch", tc, tmat)):
        d = str(tmp_path / name)
        kw = dict(burnin=2, seed=2, chains=chains, save_freq=1, save_dir=d)
        first = _train(pkg, mat, test, nsamples=3, **kw)
        r1 = _jax_run(first) if pkg is jc else first.run()
        assert r1.resumed_from is None
        # extend the schedule and resume from the saved sweep count
        second = _train(pkg, mat, test, nsamples=6, **kw)
        got[name] = (_jax_run(second, resume=True) if pkg is jc
                     else second.run(resume=True))
    jr, tr = got["jax"], got["torch"]
    assert tr.resumed_from == jr.resumed_from == 5
    assert len(tr.rmse_train_trace) == len(jr.rmse_train_trace) == 3
    np.testing.assert_allclose(tr.rmse_train_trace, jr.rmse_train_trace,
                               **CHAIN_TOL)
    np.testing.assert_allclose(tr.rmse_test_trace, jr.rmse_test_trace,
                               **CHAIN_TOL)
    np.testing.assert_allclose(tr.rmse_test, jr.rmse_test, **CHAIN_TOL)
    # bitwise the chain that was never interrupted
    whole = _train(tc, tmat, test, burnin=2, nsamples=6, seed=2,
                   chains=chains).run()
    assert tr.rmse_train_trace == whole.rmse_train_trace[5:]
    if chains > 1:
        for c in range(chains):
            assert tr.chain_blocks[c][0].rmse_train_trace == \
                whole.chain_blocks[c][0].rmse_train_trace[5:]
    for c in range(chains):
        a = tr.state if chains == 1 else tgibbs.unstack_state(tr.state, c)
        b = whole.state if chains == 1 else \
            tgibbs.unstack_state(whole.state, c)
        assert _states_equal(a, b)


def test_resume_takes_the_highest_step_common_to_all_chains(tmp_path):
    """A run cut between two chains' saves resumes from the step both
    chains hold."""
    import shutil
    _, tmat, test, _ = _data(6)
    d = tmp_path / "store"
    kw = dict(burnin=2, seed=2, chains=2, save_freq=1, save_dir=str(d))
    _train(tc, tmat, test, nsamples=3, **kw).run()
    shutil.rmtree(d / "chain_1" / "samples" / "step_5")
    r = _train(tc, tmat, test, nsamples=3, **kw).run(resume=True)
    assert r.resumed_from == 4 and len(r.rmse_train_trace) == 1


def _message(fn, jax_side: bool):
    with pytest.raises(ValueError) as ei:
        if jax_side:
            with jax.threefry_partitionable(False):
                fn()
        else:
            fn()
    return str(ei.value)


def test_resume_without_a_store_raises_the_references_error():
    jmat, tmat, test, _ = _data()
    msgs = [_message(lambda: _train(pkg, mat, test, burnin=1, nsamples=1)
                     .run(resume=True), pkg is jc)
            for pkg, mat in ((jc, jmat), (tc, tmat))]
    assert msgs[0] == msgs[1] and "save_freq > 0" in msgs[1]


def test_gfa_resume_past_the_end_raises_the_references_error(tmp_path):
    rng = np.random.default_rng(0)
    views = [rng.normal(size=(16, 6)).astype(np.float32),
             rng.normal(size=(16, 4)).astype(np.float32)]
    msgs = []
    for pkg in (jc, tc):
        kw = dict(num_latent=3, burnin=2, nsamples=3, seed=1, save_freq=1,
                  save_dir=str(tmp_path / pkg.__name__))
        if pkg is tc:
            kw["device"] = "cpu"
        if pkg is jc:
            with jax.threefry_partitionable(False):
                pkg.GFASession(views, **kw).run()
        else:
            pkg.GFASession(views, **kw).run()
        msgs.append(_message(lambda: pkg.GFASession(views, **kw).run(
            resume=True), pkg is jc))
    assert msgs[0] == msgs[1] and "ZERO posterior draws" in msgs[1]


def test_two_chain_stores_pool_the_same_in_either_package(tmp_path):
    jmat, tmat, test, _ = _data(7)
    kw = dict(burnin=2, nsamples=3, seed=4, chains=2, save_freq=1)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    jr = _jax_run(_train(jc, jmat, test, save_dir=jd, **kw))
    tr = _train(tc, tmat, test, save_dir=td, **kw).run()
    i, j = test[0], test[1]
    for d, run in ((jd, jr), (td, tr)):
        with jax.threefry_partitionable(False):
            jp = jc.PredictSession(d)
            j_pred = np.asarray(jp.predict(i, j))
        tp = tc.PredictSession(d, device="cpu")
        assert tp.n_chains == jp.n_chains == 2
        assert tp.num_samples == jp.num_samples == 6
        t_pred = tp.predict(i, j)
        np.testing.assert_allclose(t_pred, j_pred, **RELOAD_TOL)
        np.testing.assert_allclose(t_pred, np.asarray(run.predictions),
                                   **RELOAD_TOL)
    # the two packages' stores hold the same chains
    np.testing.assert_allclose(tr.predictions, np.asarray(jr.predictions),
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("chains", [1, 2])
def test_mean_from_samples_is_bitwise_the_runs_predictions(chains):
    _, tmat, test, _ = _data(1)
    r = _train(tc, tmat, test, burnin=2, nsamples=3, seed=3,
               chains=chains).run(keep_samples=True)
    assert len(r.samples) == 3 * chains
    assert np.array_equal(r.mean_from_samples(test), r.predictions)
    with pytest.raises(ValueError, match="keep_samples"):
        _train(tc, tmat, test, burnin=1, nsamples=1).run().mean_from_samples(
            test)


def test_to_dict_has_the_references_keys(tmp_path):
    jmat, tmat, test, _ = _data(2)
    kw = dict(burnin=1, nsamples=4, seed=1, chains=2)
    jd = _jax_run(_train(jc, jmat, test, **kw)).to_dict()
    td = _train(tc, tmat, test, **kw).run().to_dict()
    assert list(td) == list(jd)
    assert list(td["diagnostics"]) == list(jd["diagnostics"])
    assert td["n_chains"] == 2 and td["resumed_from"] is None
    assert td["total_s"] == td["compile_s"] + td["runtime_s"]
    np.testing.assert_allclose(td["rmse_train_trace"],
                               jd["rmse_train_trace"], **CHAIN_TOL)


def test_resolve_chains_matches_reference(monkeypatch):
    monkeypatch.delenv("REPRO_CHAINS", raising=False)
    for arg in (None, 4, "2"):
        assert tc.resolve_chains(arg) == jc.session.resolve_chains(arg)
    assert tc.resolve_chains() == 1
    monkeypatch.setenv("REPRO_CHAINS", "3")
    assert tc.resolve_chains() == jc.session.resolve_chains() == 3
    assert tc.resolve_chains(2) == 2          # explicit beats the env
    for bad in (0, -1):
        with pytest.raises(ValueError) as te:
            tc.resolve_chains(bad)
        with pytest.raises(ValueError) as je:
            jc.session.resolve_chains(bad)
        assert str(te.value) == str(je.value)
    monkeypatch.setenv("REPRO_CHAINS", "0")
    with pytest.raises(ValueError, match="chains must be >= 1"):
        tc.resolve_chains()


def test_repro_chains_sets_the_sessions_chain_count(monkeypatch):
    _, tmat, test, _ = _data(3)
    monkeypatch.setenv("REPRO_CHAINS", "2")
    r = _train(tc, tmat, test, burnin=1, nsamples=1).run()
    assert r.n_chains == 2 and r.state.factors[0].shape[0] == 2


def test_predict_accumulator_std_matches_reference():
    rng = np.random.default_rng(0)
    i = rng.integers(0, 20, 50)
    j = rng.integers(0, 15, 50)
    v = rng.normal(size=50).astype(np.float32)
    jacc = jpredict.PredictAccumulator(jpredict.make_test_set(i, j, v))
    tacc = tpredict.PredictAccumulator(
        tpredict.make_test_set(i, j, v, device="cpu"))
    for _ in range(4):
        U = rng.normal(size=(20, 5)).astype(np.float32)
        V = rng.normal(size=(15, 5)).astype(np.float32)
        jacc.update(jax.numpy.asarray(U), jax.numpy.asarray(V))
        tacc.update(torch.from_numpy(U), torch.from_numpy(V))
    np.testing.assert_allclose(tacc.std.numpy(), np.asarray(jacc.std),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(tacc.std, torch.sqrt(tacc.var))
