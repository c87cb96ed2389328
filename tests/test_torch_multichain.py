"""Several chains in the port, against ``repro`` and against itself.

* ``chain_keys``: bitwise ``repro``'s (chain 0 is the unfolded key);
  ``init_chain_states``: keys bitwise, factors at rtol 1e-6 / atol 1e-7
  (the few-ulp normal draws);
* chain c of a C-chain run (``multi_chain_step``, a loop over chains) is
  bitwise the single-chain run keyed ``chain_keys(seed, C)[c]``, on a
  probit model, a Macau model and a GFA model;
* ``multi_chain_step``'s stacked metrics against ``repro``'s at the
  golden-chain tolerance rtol 1e-3 / atol 1e-5.

Every JAX call runs inside ``jax.threefry_partitionable(False)``.
"""
import jax
import numpy as np
import pytest
import torch

import repro.core as jc
from repro.core import gibbs as jgibbs
from repro_torch import core as tc
from repro_torch.core import gibbs as tgibbs
from torch_threads import _one_thread  # noqa: F401 (autouse)

CHAIN_TOL = dict(rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("seed,chains", [(0, 1), (11, 3), (2**31 - 1, 4)])
def test_chain_keys_are_bitwise(seed, chains):
    with jax.threefry_partitionable(False):
        want = [np.asarray(k) for k in jgibbs.chain_keys(seed, chains)]
    got = tgibbs.chain_keys(seed, chains)
    assert len(got) == chains
    for w, g in zip(want, got):
        assert np.array_equal(w.astype(np.int64), g.numpy())
    assert torch.equal(got[0], tc.gibbs.random.PRNGKey(seed))


def _probit(pkg, **kw):
    mat, _, _ = (pkg.sparse.random_sparse(4, (30, 20), 0.3, rank=3,
                                          binary=True, **kw))
    b = pkg.ModelBuilder(3, **kw).add_entity("r", 30).add_entity("c", 20)
    b.add_block("r", "c", mat, noise=pkg.ProbitNoise())
    return b.build()[:2]


def _macau(pkg, **kw):
    rng = np.random.default_rng(5)
    side = (rng.random((30, 6)) > 0.5).astype(np.float32)
    mat, _, _ = pkg.sparse.random_sparse(5, (30, 20), 0.3, rank=3, **kw)
    b = pkg.ModelBuilder(3, **kw).add_entity("r", 30, side_info=side)
    b.add_entity("c", 20).add_block("r", "c", mat,
                                    noise=pkg.AdaptiveGaussian())
    return b.build()[:2]


def _gfa(pkg, **kw):
    rng = np.random.default_rng(6)
    b = pkg.ModelBuilder(3, **kw).add_entity("s", 25, prior="fixednormal")
    for m, D in enumerate((9, 7)):
        b.add_entity(f"v{m}", D, prior="spikeandslab")
        b.add_block("s", f"v{m}",
                    rng.normal(size=(25, D)).astype(np.float32),
                    noise=pkg.AdaptiveGaussian())
    return b.build()[:2]


def test_init_chain_states_match_reference():
    jm, jdata = _probit(jc)
    tm, tdata = _probit(tc, device="cpu")
    with jax.threefry_partitionable(False):
        want = jgibbs.init_chain_states(jm, jdata, 7, 3)
    got = tgibbs.init_chain_states(tm, tdata, 7, 3)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w.key).astype(np.int64),
                              g.key.numpy())
        for a, b in zip(w.factors, g.factors):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-7)


@pytest.mark.parametrize("build", [_probit, _macau, _gfa],
                         ids=["probit", "macau", "gfa"])
@pytest.mark.parametrize("chains", [2, 3])
def test_chain_c_is_the_single_chain_run_bitwise(build, chains):
    model, data = build(tc, device="cpu")
    seed, sweeps = 9, 3
    stacked = tgibbs.stack_states(tgibbs.init_chain_states(model, data,
                                                           seed, chains))
    traces = []
    for _ in range(sweeps):
        stacked, m = tgibbs.multi_chain_step(model, data, stacked)
        traces.append(m)
    assert stacked.step == sweeps
    for c, key in enumerate(tgibbs.chain_keys(seed, chains)):
        st = tgibbs.init_state(model, data, key=key)
        for s in range(sweeps):
            st, m = tgibbs.gibbs_step(model, data, st)
            for name, v in m.items():
                assert torch.equal(traces[s][name][c], v), (c, s, name)
        mine = tgibbs.unstack_state(stacked, c)
        assert torch.equal(mine.key, st.key)
        for a, b in zip(mine.factors, st.factors):
            assert torch.equal(a, b)
        for ha, hb in zip(mine.hypers, st.hypers):
            assert set(ha) == set(hb)
            for name in ha:
                assert torch.equal(ha[name], hb[name])


def test_stack_states_refuses_chains_at_different_sweeps():
    model, data = _probit(tc, device="cpu")
    a, b = tgibbs.init_chain_states(model, data, 0, 2)
    b, _ = tgibbs.gibbs_step(model, data, b)
    with pytest.raises(ValueError, match="different sweeps"):
        tgibbs.stack_states([a, b])


def test_multi_chain_metrics_match_reference():
    jm, jdata = _macau(jc)
    tm, tdata = _macau(tc, device="cpu")
    with jax.threefry_partitionable(False):
        js = jgibbs.stack_states(jgibbs.init_chain_states(jm, jdata, 3, 2))
        jtr = []
        for _ in range(3):
            js, m = jgibbs.multi_chain_step(jm, jdata, js)
            jtr.append({k: np.asarray(v) for k, v in m.items()})
    ts = tgibbs.stack_states(tgibbs.init_chain_states(tm, tdata, 3, 2))
    for s in range(3):
        ts, m = tgibbs.multi_chain_step(tm, tdata, ts)
        for key, want in jtr[s].items():
            assert m[key].shape == want.shape == (2,)
            np.testing.assert_allclose(m[key].numpy(), want, **CHAIN_TOL,
                                       err_msg=f"sweep {s} {key}")
    for a, b in zip(js.factors, ts.factors):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **CHAIN_TOL)
