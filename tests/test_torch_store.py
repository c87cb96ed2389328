"""Posterior-sample stores carry state between the two packages.

A store is ``model.json`` + ``samples/step_<n>/{shard_0.npz,
treedef.json}`` + ``diagnostics.json``, written by a session with
``save_freq > 0``.  The port writes the reference's layout and dtypes
(the threefry key as uint32 (2,), the step as a 0-d int32), so:

* a store written by ``repro`` loads in the port with every leaf equal;
* a store written by the port loads in ``repro``'s ``PredictSession``,
  and both packages' ``predict`` and ``recommend`` agree: predictions
  at rtol 1e-5 / atol 1e-6 (fp32 dot products summed in another
  order), recommendations at ``ref.check_topk_score``'s tolerance;
* ``model.json`` is the same dict for the same model;
* ``diagnostics.json`` has the same keys, and its R-hat and ESS agree
  at rtol 1e-4.  The two chains draw the same numbers up to a few ulps
  (the golden-chain tolerance, rtol 1e-3, bounds them), so the traces
  agree to about 1e-6 relative; R-hat is a smooth function of them
  (largest difference seen: 1.1e-6) and ESS one of their ranks (seen:
  equal).
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

import repro.core as jc
import repro_torch.core as tc
from repro.checkpoint import ckpt as jckpt
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.core import modelspec as tspec
from repro_torch.kernels import ref as tref

PRED_TOL = dict(rtol=1e-5, atol=1e-6)
N_ROWS, N_COLS = 40, 30


def _train(pkg, d, seed=0, **kw):
    mat, test, _ = pkg.sparse.random_sparse(3, (N_ROWS, N_COLS), 0.3,
                                            rank=3, **kw)
    b = pkg.ModelBuilder(num_latent=4, **kw)
    b.add_entity("compound", N_ROWS).add_entity("protein", N_COLS)
    b.add_block("compound", "protein", mat, test=test,
                noise=pkg.AdaptiveGaussian())
    with jax.threefry_partitionable(False):
        res = b.session(burnin=3, nsamples=10, seed=seed, save_freq=1,
                        save_dir=str(d)).run()
    return res, test


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """The same chain written by each package."""
    jd = tmp_path_factory.mktemp("jax_store")
    td = tmp_path_factory.mktemp("port_store")
    jres, test = _train(jc, jd)
    tres, _ = _train(tc, td, device="cpu")
    return str(jd), str(td), jres, tres, test


def test_reference_store_loads_in_the_port_leaf_for_leaf(stores):
    jd, _, _, _, _ = stores
    p = tc.PredictSession(jd, device="cpu")
    with jax.threefry_partitionable(False):
        jp = jc.PredictSession(jd)
    assert p.steps == jp.steps == list(range(4, 14))
    for step in p.steps:
        path = os.path.join(jd, "samples", f"step_{step}")
        want, _ = jax.tree.flatten(jckpt.load_pytree(jp._template, path))
        got = tckpt.flatten(p.load_sample(step)).leaves
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g, np.asarray(w))
    # the port's template reads the same leaves through load_pytree
    tmpl = tspec.state_template(p.model)
    st = tckpt.load_pytree(tmpl, os.path.join(jd, "samples", "step_13"),
                           device="cpu")
    assert st.step == 13 and st.key.dtype == torch.int64
    assert st.factors[0].shape == (N_ROWS, 4)


def test_port_store_serves_in_the_reference(stores):
    jd, td, _, tres, test = stores
    with jax.threefry_partitionable(False):
        jp = jc.PredictSession(td)
        jpred = jp.predict(test[0], test[1])
        jrec = jp.recommend(user=[0, 5, 9], k=8,
                            exclude=[[1, 2], [], [3]])
    p = tc.PredictSession(td, device="cpu")
    # the port's reload reproduces its in-session posterior mean
    np.testing.assert_array_equal(p.predict(test[0], test[1]),
                                  tres.predictions)
    np.testing.assert_allclose(p.predict(test[0], test[1]), jpred,
                               **PRED_TOL)
    rec = p.recommend(user=[0, 5, 9], k=8, exclude=[[1, 2], [], [3]])
    cache = p.warm_cache()
    tref.check_topk_score(
        [torch.from_numpy(np.asarray(x)) for x in rec],
        [torch.from_numpy(np.asarray(x)) for x in jrec],
        p.user_rows([0, 5, 9]), cache.factors[1], "port vs repro store")
    assert p.store_nbytes() == jp.store_nbytes()


def test_reference_store_serves_in_the_port(stores):
    jd, _, jres, _, test = stores
    p = tc.PredictSession(jd, device="cpu")
    np.testing.assert_allclose(p.predict(test[0], test[1]),
                               jres.predictions, **PRED_TOL)
    np.testing.assert_allclose(p.predict_all()[test[0], test[1]],
                               jres.predictions, rtol=1e-5, atol=1e-5)


def test_model_spec_is_the_same_dict(stores):
    jd, td, _, _, _ = stores
    with open(os.path.join(jd, "model.json")) as f:
        want = json.load(f)
    with open(os.path.join(td, "model.json")) as f:
        got = json.load(f)
    assert got == want
    assert got["format"] == "repro-mf-model-v1"


def test_diagnostics_match_the_reference(stores):
    jd, td, jres, tres, _ = stores
    with open(os.path.join(jd, "diagnostics.json")) as f:
        want = json.load(f)
    with open(os.path.join(td, "diagnostics.json")) as f:
        got = json.load(f)
    assert set(got) == set(want)
    assert set(got["rhat"]) == set(want["rhat"]) == {
        "rmse_train_0", "alpha_0", "factor_rms_compound",
        "factor_rms_protein"}
    assert (got["n_chains"], got["n_draws"]) == (1, 10)
    for key in ("rhat", "ess"):
        for name, w in want[key].items():
            assert np.isfinite(w), (key, name)
            np.testing.assert_allclose(got[key][name], w, rtol=1e-4,
                                       err_msg=f"{key} {name}")
    assert tres.diagnostics.rhat.keys() == jres.diagnostics.rhat.keys()


def test_unported_types_in_a_store_point_at_the_roadmap():
    spec = tspec.model_to_spec(tc.ModelDef(
        (tc.EntityDef("a", 3, tc.NormalPrior(2)),
         tc.EntityDef("b", 2, tc.NormalPrior(2))),
        (tc.BlockDef(0, 1, tc.FixedGaussian(), True),), 2, device="cpu"))
    spec["entities"][0]["prior"] = {"type": "MacauPrior"}
    with pytest.raises(ValueError, match="MacauPrior.*ROADMAP"):
        tspec.spec_to_model(spec, device="cpu")
    spec["entities"][0]["prior"] = {"type": "Bogus"}
    with pytest.raises(ValueError, match="valid priors: NormalPrior"):
        tspec.spec_to_model(spec, device="cpu")


def test_checkpoint_manager_reraises_a_failed_background_save(
        tmp_path, monkeypatch):
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=None)
    state = {"w": torch.arange(6.0)}

    def fail(tree, path):
        raise OSError("disk full")

    monkeypatch.setattr(tckpt, "save_pytree", fail)
    mgr.save(1, state)
    with pytest.raises(RuntimeError, match="disk full"):
        mgr.wait()
    mgr.wait()                          # handled: not raised again
    monkeypatch.undo()
    mgr.save(2, state)
    state["w"].add_(1.0)                # the save holds a host copy
    mgr.save(3, state)
    mgr.wait()
    assert mgr.all_steps() == [2, 3]
    got = tckpt.load_pytree({"w": torch.zeros(6)},
                            str(tmp_path / "step_2"))
    assert torch.equal(got["w"], torch.arange(6.0))


def test_checkpoint_manager_keeps_the_last_n(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=2)
    for s in range(5):
        mgr.save(s, {"x": np.full(3, s, np.float32)}, blocking=True)
    assert mgr.all_steps() == [3, 4] == jckpt.list_steps(str(tmp_path))
    step, tree = mgr.restore_latest({"x": np.zeros(3, np.float32)})
    assert step == 4 and (tree["x"] == 4).all()


def test_session_store_errors_carry_reference_messages(tmp_path):
    mat, _, _ = tc.random_sparse(0, (6, 4), 0.5, device="cpu")
    b = tc.ModelBuilder(3, device="cpu").add_entity("r", 6).add_entity(
        "c", 4).add_block("r", "c", mat)
    with pytest.raises(ValueError) as te:
        b.session(save_freq=1)
    jmat, _, _ = jc.sparse.random_sparse(0, (6, 4), 0.5)
    jb = jc.ModelBuilder(3).add_entity("r", 6).add_entity(
        "c", 4).add_block("r", "c", jmat)
    with pytest.raises(ValueError) as je:
        jb.session(save_freq=1)
    assert str(te.value) == str(je.value)
    for pkg, kw in ((jc, {}), (tc, {"device": "cpu"})):
        with pytest.raises(ValueError, match="save_freq") as e:
            pkg.PredictSession(str(tmp_path), **kw)
        assert "no model spec" in str(e.value)


def test_require_converged_gates_like_the_reference(stores):
    jd, td, _, _, _ = stores
    for gate in (dict(require_converged=True, rhat_threshold=1.0 + 1e-9),):
        with jax.threefry_partitionable(False):
            with pytest.raises(ValueError) as je:
                jc.PredictSession(td, **gate)
        with pytest.raises(ValueError) as te:
            tc.PredictSession(td, device="cpu", **gate)
        assert str(te.value) == str(je.value)
        assert "NOT converged" in str(te.value)
    with pytest.warns(UserWarning, match="NOT converged"):
        tc.PredictSession(td, device="cpu", require_converged="warn",
                          rhat_threshold=1.0 + 1e-9)
    tc.PredictSession(td, device="cpu", require_converged=True,
                      rhat_threshold=1e9)
    os.rename(os.path.join(td, "diagnostics.json"),
              os.path.join(td, "diag.bak"))
    try:
        with pytest.raises(ValueError, match="records no diagnostics"):
            tc.PredictSession(td, device="cpu", require_converged=True)
    finally:
        os.rename(os.path.join(td, "diag.bak"),
                  os.path.join(td, "diagnostics.json"))


def test_multi_chain_reference_store_pools_like_the_reference(tmp_path):
    """A ``chains=2`` store of the reference (``chain_<c>/`` stores)
    loads in the port pooled step-major, chain-minor, and predicts what
    the reference predicts from it."""
    mat, test, _ = jc.sparse.random_sparse(5, (N_ROWS, N_COLS), 0.3,
                                           rank=3)
    b = jc.ModelBuilder(num_latent=3)
    b.add_entity("compound", N_ROWS).add_entity("protein", N_COLS)
    b.add_block("compound", "protein", mat, noise=jc.AdaptiveGaussian())
    with jax.threefry_partitionable(False):
        b.session(burnin=2, nsamples=3, seed=1, chains=2, save_freq=1,
                  save_dir=str(tmp_path)).run()
        jp = jc.PredictSession(str(tmp_path))
        want = jp.predict(test[0], test[1])
    p = tc.PredictSession(str(tmp_path), device="cpu")
    assert p.n_chains == jp.n_chains == 2
    assert p.chain_steps == jp.chain_steps == [
        (s, c) for s in (3, 4, 5) for c in (0, 1)]
    np.testing.assert_allclose(p.predict(test[0], test[1]), want,
                               **PRED_TOL)
    with pytest.raises(ValueError, match="for chain 1"):
        p.load_sample(99, chain=1)
