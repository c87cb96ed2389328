"""The port's session wrappers, ``TrainSession``, ``GFASession`` and
``smurff()``, against ``repro.core.session`` and the golden chains.

* ``GFASession`` with ``zero_init_loadings`` True and False, one chain
  and two: ``Z``, ``W`` and the per-chain means against the reference at
  the golden-chain tolerance (rtol 1e-3 / atol 1e-5); for two chains
  ``Z``/``W`` are bitwise the single-chain run's (chain 0);
* ``smurff()`` with side information against the reference;
* the wrappers replay the golden ``gaussian``, ``probit`` and ``gfa``
  chains: bitwise the port's engine chain, and at the golden-chain
  tolerance against ``results/golden_chains.json`` (the reference's
  ``test_wrappers_replay_golden_chain``);
* every argument of the reference's entry points exists in the port's
  (``device=`` in place of ``use_pallas=``), and the distributed
  sweep's arguments behave as the reference's without a mesh.

Every JAX call runs inside ``jax.threefry_partitionable(False)``.
"""
import inspect
import json
from pathlib import Path

import jax
import numpy as np
import pytest

import repro.core as jc
import repro_torch.core as tc
from repro.data.synthetic import chembl_like as j_chembl_like
from repro_torch.data import chembl_like as t_chembl_like
from torch_threads import _one_thread  # noqa: F401 (autouse)

CHAIN_TOL = dict(rtol=1e-3, atol=1e-5)
GOLDEN = Path(__file__).resolve().parents[1] / "results" / \
    "golden_chains.json"


def _views(seed=1, N=16, dims=(6, 4)):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(N, D)).astype(np.float32) for D in dims]


@pytest.mark.parametrize("zero_init", [True, False])
@pytest.mark.parametrize("chains", [1, 2])
def test_gfa_session_matches_reference(zero_init, chains):
    views = _views()
    kw = dict(num_latent=3, burnin=3, nsamples=3, seed=4, chains=chains,
              zero_init_loadings=zero_init)
    with jax.threefry_partitionable(False):
        j = jc.GFASession(views, **kw).run()
    t = tc.GFASession(views, device="cpu", **kw).run()
    assert set(t) == set(j)
    np.testing.assert_allclose(t["Z"], np.asarray(j["Z"]), **CHAIN_TOL)
    assert len(t["W"]) == len(j["W"]) == 2
    for a, b in zip(j["W"], t["W"]):
        assert b.shape == np.asarray(a).shape
        np.testing.assert_allclose(b, np.asarray(a), **CHAIN_TOL)
    for a, b in zip(j["rmse_train"], t["rmse_train"]):
        np.testing.assert_allclose(b, a, **CHAIN_TOL)
    if chains == 2:
        assert t["Z_chains"].shape == (2, 16, 3)
        np.testing.assert_allclose(t["Z_chains"], np.asarray(j["Z_chains"]),
                                   **CHAIN_TOL)
        for a, b in zip(j["W_chains"], t["W_chains"]):
            np.testing.assert_allclose(b, np.asarray(a), **CHAIN_TOL)
        assert t["diagnostics"].n_chains == 2
        # Z/W follow chain 0: bitwise the single-chain run
        single = tc.GFASession(views, device="cpu",
                               **{**kw, "chains": 1}).run()
        assert np.array_equal(t["Z"], single["Z"])
        for wm, ws in zip(t["W"], single["W"]):
            assert np.array_equal(wm, ws)
        assert np.array_equal(t["Z_last"], single["Z_last"])


def test_gfa_session_takes_tensors_and_keeps_them_on_its_device():
    import torch
    views = _views(2)
    kw = dict(num_latent=3, burnin=2, nsamples=2, seed=1, device="cpu")
    a = tc.GFASession(views, **kw).run()
    b = tc.GFASession([torch.from_numpy(v) for v in views], **kw).run()
    assert np.array_equal(a["Z"], b["Z"])


def test_smurff_with_side_info_matches_reference():
    kw = dict(n_compounds=48, n_proteins=24, density=0.3, rank=3,
              n_features=8)
    jmat, test, F = j_chembl_like(3, **kw)
    tmat, _, _ = t_chembl_like(3, device="cpu", **kw)
    args = dict(test=test, side_info=(F, None), num_latent=3, burnin=3,
                nsamples=3, seed=2, noise=None)
    with jax.threefry_partitionable(False):
        jr = jc.smurff(jmat, **args)
    tr = tc.smurff(tmat, device="cpu", **args)
    np.testing.assert_allclose(tr.rmse_train_trace, jr.rmse_train_trace,
                               **CHAIN_TOL)
    np.testing.assert_allclose(tr.rmse_test, jr.rmse_test, **CHAIN_TOL)
    np.testing.assert_allclose(tr.predictions, np.asarray(jr.predictions),
                               rtol=1e-3, atol=1e-4)
    assert "beta" in tr.state.hypers[0]


def test_smurff_on_a_dense_array_and_verbose_prints(capsys):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(12, 9)).astype(np.float32)
    r = tc.smurff(X, num_latent=2, burnin=2, nsamples=2, seed=0,
                  device="cpu", verbose=1)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[burnin    0] rmse_train=")
    assert len(lines) == 4 and r.rmse_test is None


def _golden_engine(name, seed, sweeps):
    """The golden model's chain through ``gibbs_step``, as
    ``tests/test_golden_chain.py`` builds it (K = 4)."""
    K = 4
    if name == "gfa":
        views = _golden_views(seed, K)
        ents = [tc.EntityDef("samples", 48, tc.FixedNormalPrior(K))]
        blocks, payloads = [], []
        for m, X in enumerate(views):
            ents.append(tc.EntityDef(f"view{m}", X.shape[1],
                                     tc.SpikeAndSlabPrior(K)))
            blocks.append(tc.BlockDef(0, m + 1, tc.AdaptiveGaussian(),
                                      sparse=False))
            payloads.append(tc.dense_block(X, device="cpu"))
        model = tc.ModelDef(tuple(ents), tuple(blocks), K, device="cpu")
        data = tc.MFData(tuple(payloads), (None,) * len(ents))
    else:
        binary = name == "probit"
        mat, _, _ = tc.random_sparse(seed, (48, 32), 0.3, rank=3,
                                     binary=binary, device="cpu")
        noise = tc.ProbitNoise() if binary else tc.AdaptiveGaussian()
        model = tc.ModelDef((tc.EntityDef("r", 48, tc.NormalPrior(K)),
                             tc.EntityDef("c", 32, tc.NormalPrior(K))),
                            (tc.BlockDef(0, 1, noise, sparse=True),), K,
                            device="cpu")
        data = tc.MFData((mat,), (None, None))
    state = tc.init_state(model, data, seed=seed)
    out = {"rmse_train": [], "alpha": []}
    for _ in range(sweeps):
        state, m = tc.gibbs_step(model, data, state)
        out["rmse_train"].append(float(m["rmse_train_0"]))
        out["alpha"].append(float(m["alpha_0"]))
    return out


def _golden_views(seed, K):
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(48, K)).astype(np.float32)
    views = []
    for D in (16, 12):
        W = rng.normal(size=(D, K)).astype(np.float32)
        views.append((Z @ W.T + 0.1 * rng.normal(size=(48, D)))
                     .astype(np.float32))
    return views


@pytest.mark.parametrize("name", ["gaussian", "probit", "gfa"])
def test_wrappers_replay_golden_chain(name):
    golden = json.loads(GOLDEN.read_text())
    seed, sweeps = golden["seed"], golden["sweeps"]
    store = {"rmse_train": [], "alpha": []}

    def cb(info):
        store["rmse_train"].append(float(info.metrics["rmse_train_0"]))
        store["alpha"].append(float(info.metrics["alpha_0"]))

    if name == "gfa":
        tc.GFASession(_golden_views(seed, 4), num_latent=4, burnin=sweeps,
                      nsamples=0, seed=seed, zero_init_loadings=False,
                      device="cpu", callbacks=[cb]).run()
    else:
        binary = name == "probit"
        mat, _, _ = tc.random_sparse(seed, (48, 32), 0.3, rank=3,
                                     binary=binary, device="cpu")
        s = tc.TrainSession(num_latent=4, burnin=sweeps, nsamples=0,
                            seed=seed, device="cpu", callbacks=[cb])
        s.add_train_and_test(mat, noise=tc.ProbitNoise() if binary
                             else tc.AdaptiveGaussian())
        s.run()
    engine = _golden_engine(name, seed, sweeps)
    for key in ("rmse_train", "alpha"):
        assert store[key] == engine[key], f"{name} {key} forked"
        np.testing.assert_allclose(store[key], golden["chains"][name][key],
                                   **CHAIN_TOL)


@pytest.mark.parametrize("name", ["Session", "TrainSession", "GFASession",
                                  "smurff"])
def test_entry_points_take_the_references_arguments(name):
    ref = inspect.signature(getattr(jc, name)).parameters
    port = inspect.signature(getattr(tc, name)).parameters
    want = [p for p in ref if p != "use_pallas"]
    assert [p for p in port if p != "device"] == want
    if name != "Session":
        assert "device" in port and "use_pallas" in ref


def _session_entry(kind, **kw):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(6, 5)).astype(np.float32)
    if kind == "TrainSession":
        return tc.TrainSession(num_latent=2, device="cpu", **kw)
    if kind == "GFASession":
        return tc.GFASession([X], num_latent=2, device="cpu", **kw)
    return tc.smurff(X, num_latent=2, device="cpu", **kw)


@pytest.mark.parametrize("kind", ["TrainSession", "GFASession", "smurff"])
@pytest.mark.parametrize("arg,value", [("mesh", object()),
                                       ("pipeline", "eager"),
                                       ("chain_axis", "chain")])
def test_distributed_arguments_raise_naming_a8(kind, arg, value):
    """The distributed sweep's arguments are ported
    (``tests/test_torch_distributed.py``).  Without a mesh, each wrapper
    does what the reference's does: ``mesh=`` must be a ``DeviceMesh``,
    ``chain_axis=`` raises, and ``pipeline=`` warns that it has no
    effect when the run starts."""
    if arg == "pipeline":
        with pytest.warns(UserWarning, match=f"pipeline={value!r} has no "
                          "effect without mesh="):
            entry = _session_entry(kind, burnin=1, nsamples=1, **{arg: value})
            if kind == "TrainSession":
                entry.add_train_and_test(
                    np.random.default_rng(0).normal(size=(6, 5)).astype(
                        np.float32)).run()
            elif kind == "GFASession":
                entry.run()
        return
    with pytest.raises(ValueError) as ei:
        _session_entry(kind, **{arg: value})
    msg = str(ei.value)
    assert f"{arg}=" in msg
    assert ("DeviceMesh" if arg == "mesh" else "pass mesh= too") in msg
