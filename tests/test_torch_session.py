"""The port's session layer against ``repro.core.session``.

``Session.run`` and ``TrainSession.run`` at the same seed give the same
chain: train traces and ``rmse_test`` at the golden-chain tolerance
(rtol 1e-3 / atol 1e-5).  Errors that both packages raise carry the
same message; options outside the port's slice raise a ValueError that
names what the port supports.
"""
import jax
import numpy as np
import pytest

import repro.core as jc
import repro_torch.core as tc

CHAIN_TOL = dict(rtol=1e-3, atol=1e-5)


def _data(n=40, m=30, density=0.3, seed=3):
    jmat, test, _ = jc.sparse.random_sparse(seed, (n, m), density, rank=3)
    tmat, ttest, _ = tc.random_sparse(seed, (n, m), density, rank=3,
                                      device="cpu")
    return jmat, tmat, test


def test_session_run_matches_reference():
    jmat, tmat, test = _data()
    runs = []
    for pkg, mat, kw in ((jc, jmat, {}), (tc, tmat, {"device": "cpu"})):
        b = pkg.ModelBuilder(num_latent=4, **kw)
        b.add_entity("compound", 40).add_entity("protein", 30)
        b.add_block("compound", "protein", mat, test=test,
                    noise=pkg.AdaptiveGaussian())
        with jax.threefry_partitionable(False):
            runs.append(b.session(burnin=3, nsamples=3, seed=5).run())
    jr, tr = runs
    np.testing.assert_allclose(tr.rmse_train_trace, jr.rmse_train_trace,
                               **CHAIN_TOL)
    np.testing.assert_allclose(tr.rmse_test_trace, jr.rmse_test_trace,
                               **CHAIN_TOL)
    np.testing.assert_allclose(tr.rmse_test, jr.rmse_test, **CHAIN_TOL)
    np.testing.assert_allclose(tr.predictions, jr.predictions, rtol=1e-3,
                               atol=1e-4)
    assert tr.blocks[0].entities == ("compound", "protein")
    assert tr.nsamples == 3 and tr.compile_s == 0.0


def test_train_session_matches_reference_with_callbacks():
    jmat, tmat, test = _data(seed=8)
    seen = []
    jres = None
    with jax.threefry_partitionable(False):
        js = jc.TrainSession(num_latent=3, burnin=2, nsamples=2, seed=1)
        jres = js.add_train_and_test(jmat, test,
                                     jc.FixedGaussian(3.0)).run()
    ts = tc.TrainSession(num_latent=3, burnin=2, nsamples=2, seed=1,
                         device="cpu",
                         callbacks=[lambda info: seen.append(info.phase)])
    tres = ts.add_train_and_test(tmat, test, tc.FixedGaussian(3.0)).run(
        keep_samples=True)
    np.testing.assert_allclose(tres.rmse_train_trace,
                               jres.rmse_train_trace, **CHAIN_TOL)
    np.testing.assert_allclose(tres.rmse_test, jres.rmse_test, **CHAIN_TOL)
    assert seen == ["burnin", "burnin", "sample", "sample"]
    assert len(tres.samples) == 2 and tres.samples[0][0].shape == (40, 3)


def _chembl_like(n, m, per_row, n_test, rank, noise, seed):
    """COO of a planted rank-``rank`` product plus Gaussian noise where
    every row observes ``per_row`` training and ``n_test`` held-out
    columns, all distinct: the shape of the slice ``chip_smoke.py`` runs."""
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(n, rank))
    V = rng.normal(size=(m, rank))
    cols = np.stack([rng.permutation(m)[:per_row + n_test]
                     for _ in range(n)])
    rows = np.repeat(np.arange(n)[:, None], cols.shape[1], axis=1)
    vals = (np.einsum("rtk,rtk->rt", U[rows], V[cols])
            + noise * rng.normal(size=cols.shape)).astype(np.float32)
    tr, te = slice(0, per_row), slice(per_row, None)
    return ((rows[:, tr].ravel(), cols[:, tr].ravel(), vals[:, tr].ravel()),
            (rows[:, te].ravel(), cols[:, te].ravel(), vals[:, te].ravel()))


def test_session_rmse_test_matches_reference_with_more_latents_than_obs():
    """K = 128 over 64 observations per row, as in the slice: the chain
    leaves the unobserved directions of each row near the prior, so the
    test RMSE after a few sweeps exceeds that of predicting 0 -- in the
    reference as in the port."""
    n, m = 96, 512
    train, test = _chembl_like(n, m, 64, 7, rank=16, noise=0.3, seed=4)
    runs = []
    for pkg, kw in ((jc, {}), (tc, {"device": "cpu"})):
        b = pkg.ModelBuilder(num_latent=128, **kw)
        b.add_entity("compound", n).add_entity("protein", m)
        b.add_block("compound", "protein",
                    pkg.from_coo(*train, (n, m), **kw), test=test,
                    noise=pkg.AdaptiveGaussian())
        with jax.threefry_partitionable(False):
            runs.append(b.session(burnin=4, nsamples=2, seed=0).run())
    jr, tr = runs
    np.testing.assert_allclose(tr.rmse_train_trace, jr.rmse_train_trace,
                               **CHAIN_TOL)
    np.testing.assert_allclose(tr.rmse_test, jr.rmse_test, **CHAIN_TOL)
    assert jr.rmse_test > np.sqrt(np.mean(np.square(test[2])))


def _sparse(pkg, shape, **kw):
    return pkg.from_coo([0, 1], [1, 0], [1.0, 2.0], shape, **kw)


def _mistakes():
    """(name, fn(pkg, kw)) pairs where kw carries the port's device."""
    def unknown_entity(pkg, kw):
        b = pkg.ModelBuilder(4, **kw).add_entity("rows", 8).add_entity(
            "cols", 4)
        b.add_block("rows", "bogus", _sparse(pkg, (8, 4), **kw))

    def before_entities(pkg, kw):
        pkg.ModelBuilder(4, **kw).add_block("a", "b",
                                            _sparse(pkg, (2, 2), **kw))

    def duplicate_entity(pkg, kw):
        pkg.ModelBuilder(4, **kw).add_entity("rows", 8).add_entity(
            "rows", 9)

    def bad_n(pkg, kw):
        pkg.ModelBuilder(4, **kw).add_entity("rows", 0)

    def shape_mismatch(pkg, kw):
        b = pkg.ModelBuilder(4, **kw).add_entity("rows", 8).add_entity(
            "cols", 4)
        b.add_block("rows", "cols", _sparse(pkg, (8, 5), **kw))

    def duplicate_block(pkg, kw):
        b = pkg.ModelBuilder(4, **kw).add_entity("rows", 8).add_entity(
            "cols", 4)
        b.add_block("rows", "cols", _sparse(pkg, (8, 4), **kw))
        b.add_block("cols", "rows", _sparse(pkg, (4, 8), **kw))

    def self_block(pkg, kw):
        b = pkg.ModelBuilder(4, **kw).add_entity("rows", 8)
        b.add_block("rows", "rows", _sparse(pkg, (8, 8), **kw))

    def prior_width(pkg, kw):
        pkg.ModelBuilder(4, **kw).add_entity("rows", 8,
                                             prior=pkg.NormalPrior(3))

    def empty(pkg, kw):
        pkg.ModelBuilder(4, **kw).build()

    def no_blocks(pkg, kw):
        pkg.ModelBuilder(4, **kw).add_entity("rows", 8).build()

    def test_block_index(pkg, kw):
        b = pkg.ModelBuilder(4, **kw).add_entity("r", 8).add_entity("c", 4)
        b.add_block("r", "c", _sparse(pkg, (8, 4), **kw))
        model, data, _ = b.build()
        pkg.Session(model, data,
                    tests={3: pkg.make_test_set([0], [0], [0.0], **kw)})

    return [(f.__name__, f) for f in (
        unknown_entity, before_entities, duplicate_entity, bad_n,
        shape_mismatch, duplicate_block, self_block, prior_width, empty,
        no_blocks, test_block_index)]


@pytest.mark.parametrize("name,mistake", _mistakes())
def test_shared_errors_carry_reference_messages(name, mistake):
    with pytest.raises(ValueError) as je:
        mistake(jc, {})
    with pytest.raises(ValueError) as te:
        mistake(tc, {"device": "cpu"})
    assert str(te.value) == str(je.value)


def _builder():
    _, tmat, _ = _data()
    b = tc.ModelBuilder(num_latent=4, device="cpu")
    b.add_entity("r", 40).add_entity("c", 30)
    return b, tmat


@pytest.mark.parametrize("what,call", [
    ("side_info", lambda b, m: b.add_entity(
        "x", 3, side_info=np.zeros((3, 2), np.float32))),
    ("prior 'spikeandslab'", lambda b, m: b.add_entity(
        "x", 3, prior="spikeandslab")),
    ("dense block data", lambda b, m: b.add_block(
        "r", "c", np.zeros((40, 30), np.float32))),
    ("noise ProbitNoise", lambda b, m: b.add_block(
        "r", "c", m, noise=jc.ProbitNoise())),
    ("chains=4", lambda b, m: b.add_block("r", "c", m).session(chains=4)),
    ("save_freq", lambda b, m: b.add_block("r", "c", m).session(
        save_freq=2, save_dir="unused").run(resume=True)),
    ("mesh=", lambda b, m: b.add_block("r", "c", m).session(
        mesh=object())),
    ("resume=True", lambda b, m: b.add_block("r", "c", m).session(
        burnin=1, nsamples=1).run(resume=True)),
])
def test_options_outside_the_slice_raise(what, call):
    b, m = _builder()
    with pytest.raises(ValueError) as ei:
        call(b, m)
    msg = str(ei.value)
    assert what in msg and "not ported yet" in msg and "ROADMAP" in msg


def test_unknown_prior_lists_the_ports_priors():
    b, _ = _builder()
    with pytest.raises(ValueError, match="valid priors: normal"):
        b.add_entity("x", 3, prior="bogus")
