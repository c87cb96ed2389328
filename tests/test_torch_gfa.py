"""GFA: the FixedNormal and spike-and-slab priors and the coordinate-wise
spike-and-slab update of the port against ``repro``.

* ``FixedNormalPrior``: its terms exactly; ``SpikeAndSlabPrior``'s
  hyper-sample (vector gamma draws) at rtol 1e-5 / atol 1e-6;
* one spike-and-slab update from a state carried over from the
  reference (dense fully observed, dense masked and sparse views).  The
  inclusion draw is ``u < sigmoid(log_odds)``: an ulp of the odds (the
  matvecs sum in another order, torch's ``log`` is not XLA's) flips a
  bit where u lies next to p.  So per row, the first component whose
  bit differs must have |u - p| < 1e-5, and the flips are counted; the
  rows with no flip match at rtol 1e-4 / atol 1e-5;
* the golden ``gfa`` chain against the fixture and a live JAX run, and
  a GFA model built by prior name, at the golden-chain tolerance rtol
  1e-3 / atol 1e-5.

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
from repro.core import priors as jpriors
from repro_torch import convert
from repro_torch import random as trandom
from repro_torch import core as tc
from repro_torch.core import gibbs as tgibbs
from repro_torch.core import priors as tpriors
from torch_threads import _one_thread  # noqa: F401 (autouse)

FIXTURE = os.path.join(os.path.dirname(__file__), "..", "results",
                       "golden_chains.json")
CHAIN_TOL = dict(rtol=1e-3, atol=1e-5)
FLIP_GAP = 1e-5


def test_fixed_normal_prior_terms():
    p = tpriors.FixedNormalPrior(3)
    assert p.init(trandom.PRNGKey(0), 5, "cpu") == {}
    assert p.sample_hyper(trandom.PRNGKey(0), torch.zeros(5, 3), {}) == {}
    assert torch.equal(p.precision_term({}, "cpu"), torch.eye(3))
    assert torch.equal(p.mean_term({}, 5, "cpu"), torch.zeros(3))


@pytest.mark.parametrize("N,K,seed", [(20, 4, 0), (300, 16, 1)])
def test_spike_and_slab_sample_hyper_matches_reference(N, K, seed):
    rng = np.random.default_rng(seed)
    F = rng.normal(size=(N, K)).astype(np.float32)
    F[rng.random((N, K)) < 0.4] = 0.0
    h = {"rho": rng.random(K).astype(np.float32),
         "tau": (rng.random(K) + 0.5).astype(np.float32)}
    jp, tp = jpriors.SpikeAndSlabPrior(K), tpriors.SpikeAndSlabPrior(K)
    with jax.threefry_partitionable(False):
        want = jp.sample_hyper(jax.random.PRNGKey(seed + 3), jnp.asarray(F),
                               {k: jnp.asarray(v) for k, v in h.items()})
    got = tp.sample_hyper(trandom.PRNGKey(seed + 3), torch.from_numpy(F),
                          {k: torch.from_numpy(v) for k, v in h.items()})
    for name in ("rho", "tau"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(tp.precision_term(got).numpy(),
                                  np.diag(got["tau"].numpy()))


def _gfa(pkg, N, dims, K, seed, masked_view=False, sparse_view=False,
         **kw):
    """FixedNormal samples against spike-and-slab views: fully observed
    dense views, optionally one masked and one sparse."""
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(N, K)).astype(np.float32)
    b = pkg.ModelBuilder(K, **kw)
    b.add_entity("samples", N, prior="fixednormal")
    for m, D in enumerate(dims):
        W = rng.normal(size=(D, K)).astype(np.float32)
        W[:, rng.random(K) < 0.3] = 0.0
        X = (Z @ W.T + 0.1 * rng.normal(size=(N, D))).astype(np.float32)
        b.add_entity(f"view{m}", D, prior="spikeandslab")
        if sparse_view and m == len(dims) - 1:
            keep = rng.random((N, D)) < 0.5
            i, j = np.nonzero(keep)
            b.add_block("samples", f"view{m}",
                        pkg.from_coo(i, j, X[i, j], (N, D), **kw),
                        noise=pkg.AdaptiveGaussian())
        elif masked_view and m == 0:
            b.add_block("samples", f"view{m}", X,
                        mask=(rng.random((N, D)) > 0.2).astype(np.float32),
                        noise=pkg.AdaptiveGaussian())
        else:
            b.add_block("samples", f"view{m}", X,
                        noise=pkg.AdaptiveGaussian())
    return b.build()


@pytest.mark.parametrize("kind", ["dense", "masked+sparse"])
def test_one_sns_update_from_carried_state_flips_only_at_ties(kind):
    N, dims, K = 96, (40, 24, 18), 8
    extra = dict(masked_view=kind != "dense", sparse_view=kind != "dense")
    jm, jdata, _ = _gfa(jc, N, dims, K, 5, **extra)
    tm, _, _ = _gfa(tc, N, dims, K, 5, device="cpu", **extra)
    with jax.threefry_partitionable(False):
        st = jgibbs.init_state(jm, jdata, seed=3)
        for _ in range(2):
            st, _ = jgibbs.gibbs_step(jm, jdata, st)
    ts = convert.state_from_reference(st.key, st.factors, st.hypers,
                                      st.noises, st.step, device="cpu")
    tdata = convert.data_from_reference(jdata.blocks, jdata.sides,
                                        device="cpu")
    flips = 0
    for e in range(1, len(dims) + 1):
        key = np.asarray(jax.random.fold_in(jax.random.PRNGKey(21), e))
        with jax.threefry_partitionable(False):
            want = np.asarray(jgibbs._sample_sns_factor(
                jm, jdata, jnp.asarray(key), e, st.factors[e], st.hypers[e],
                lambda o: st.factors[o], st.noises))
        trace = []
        tkey = torch.from_numpy(key.astype(np.int64))
        got = tgibbs._sample_sns_factor(
            tm, tdata, tkey, e, ts.factors[e], ts.hypers[e],
            ts.factors.__getitem__, ts.noises, trace=trace).numpy()
        k_incl = trandom.split(tkey)[0]
        differs = (got != 0) != (want != 0)
        for r in np.nonzero(differs.any(axis=1))[0]:
            k = int(np.argmax(differs[r]))
            u = tgibbs.row_uniforms(trandom.fold_in(k_incl, k),
                                    got.shape[0], 1)[r, 0]
            p = trace[k][1][r]
            assert abs(float(u - p)) < FLIP_GAP, (e, r, k, float(u),
                                                  float(p))
            flips += 1
        same = ~differs.any(axis=1)
        np.testing.assert_allclose(got[same], want[same], rtol=1e-4,
                                   atol=1e-5)
    print(f"spike-and-slab inclusion flips ({kind}): {flips}")


def test_golden_gfa_chain_replays_fixture_and_live_jax():
    """The reference's golden GFA model: FixedNormal samples, two fully
    observed dense views with spike-and-slab loadings."""
    with open(FIXTURE) as f:
        golden = json.load(f)
    seed, sweeps, K = golden["seed"], golden["sweeps"], 4

    def build(pkg, **kw):
        rng = np.random.default_rng(seed)
        N, dims = 48, (16, 12)
        Z = rng.normal(size=(N, K)).astype(np.float32)
        ents = [pkg.EntityDef("samples", N, pkg.FixedNormalPrior(K))]
        blocks, payloads = [], []
        for m, D in enumerate(dims):
            W = rng.normal(size=(D, K)).astype(np.float32)
            X = (Z @ W.T + 0.1 * rng.normal(size=(N, D))).astype(np.float32)
            ents.append(pkg.EntityDef(f"view{m}", D,
                                      pkg.SpikeAndSlabPrior(K)))
            blocks.append(pkg.BlockDef(0, m + 1, pkg.AdaptiveGaussian(),
                                       sparse=False))
            payloads.append(pkg.dense_block(X, **kw))
        if pkg is jc:
            model = pkg.ModelDef(tuple(ents), tuple(blocks), K, False)
        else:
            model = pkg.ModelDef(tuple(ents), tuple(blocks), K, **kw)
        return model, pkg.MFData(tuple(payloads), (None,) * len(ents))

    traces = {}
    for pkg, kw in ((jc, {}), (tc, {"device": "cpu"})):
        model, data = build(pkg, **kw)
        with jax.threefry_partitionable(False):
            st = pkg.init_state(model, data, seed=seed)
            tr = {"rmse_train": [], "alpha": []}
            for _ in range(sweeps):
                st, m = pkg.gibbs_step(model, data, st)
                tr["rmse_train"].append(float(m["rmse_train_0"]))
                tr["alpha"].append(float(m["alpha_0"]))
        traces[pkg] = (tr, st)
    got, tst = traces[tc]
    live, jst = traces[jc]
    for key in ("rmse_train", "alpha"):
        np.testing.assert_allclose(got[key], golden["chains"]["gfa"][key],
                                   **CHAIN_TOL, err_msg=f"fixture {key}")
        np.testing.assert_allclose(got[key], live[key], **CHAIN_TOL,
                                   err_msg=f"live {key}")
    for a, b in zip(jst.factors, tst.factors):
        np.testing.assert_array_equal(b.numpy() != 0, np.asarray(a) != 0)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **CHAIN_TOL)


def test_gfa_by_prior_name_matches_reference():
    jm, jdata, _ = _gfa(jc, 40, (14, 9), 4, 8, masked_view=True)
    tm, tdata, _ = _gfa(tc, 40, (14, 9), 4, 8, masked_view=True,
                        device="cpu")
    assert isinstance(tm.entities[0].prior, tpriors.FixedNormalPrior)
    assert isinstance(tm.entities[1].prior, tpriors.SpikeAndSlabPrior)
    assert not tm.blocks[0].sparse
    with jax.threefry_partitionable(False):
        st = jgibbs.init_state(jm, jdata, seed=6)
        jtrace = []
        for _ in range(3):
            st, m = jgibbs.gibbs_step(jm, jdata, st)
            jtrace.append({k: float(v) for k, v in m.items()})
    ts = tc.init_state(tm, tdata, seed=6)
    for s in range(3):
        ts, m = tc.gibbs_step(tm, tdata, ts)
        for key, want in jtrace[s].items():
            np.testing.assert_allclose(float(m[key]), want, **CHAIN_TOL,
                                       err_msg=f"sweep {s} {key}")
    for e in range(1, 3):
        for name in ("rho", "tau"):
            np.testing.assert_allclose(ts.hypers[e][name].numpy(),
                                       np.asarray(st.hypers[e][name]),
                                       **CHAIN_TOL)
