"""The ``bf16_gather`` sweep of the port (``ModelDef.bf16_gather``)
against the reference's, on the CPU.

With the flag, every half-sweep reads one bf16 copy of the fixed factor
(and the distributed sweep exchanges it in bf16); the kernels' bf16
branches do the arithmetic.  Every product reads the bf16 values
widened exactly: JAX promotes a bf16 x fp32 product to fp32, and the
jitted reference computes the bf16 x bf16 products it types bf16 (a
dense Gram, dense predictions, f_k * f_k) in fp32 too, since only fp32
consumers read them.  The roundings left are the reference's explicit
ones (``val * mask`` in the Gram's rhs, a bf16 ``jnp.sum``).  JAX runs
in this process only, inside
``jax.threefry_partitionable(False)``; the gloo ranks import
``repro_torch`` alone.

* the plain versions of the kernels' bf16 branches against the
  reference's oracles, at the reference's probe shapes and ragged ones:
  ``sddmm_ref``, ``gathered_sddmm_ref``, ``gathered_sddmm_padded_ref``
  (fp32 u against bf16 rows), ``gathered_gram_ref`` (a bf16 fixed
  factor, with the reference's rounding of ``val * mask`` to bf16) and
  ``topk_score_ref`` (bf16; a batched call bitwise B single-user calls);
* one sweep of each model kind from one converted state: each entity's
  update in the port from the reference's inputs (the later entity gets
  the reference's updated factor, so a bf16 rounding flip of one
  package cannot carry into the other's next update), then the
  sweep-end noise states and metrics from the reference's new factors;
* a short ``ModelBuilder(bf16_gather=True)`` session chain in both
  packages, held by its rmse and alpha traces (statistically: the
  chains are not elementwise comparable over many sweeps, see
  ``CHAIN_RTOL``);
* ``bf16_gather=False`` makes no bf16 tensor and is the default;
* a store written with ``"bf16_gather": true`` by either package loads
  in the other;
* gloo worlds of 2 and 4 ranks, eager and ring: the exchange in bf16 at
  ``contract_wire_bytes``, the census against ``contract_for``, the
  gathered first sweep against the single-device bf16 sweep; a world of
  1 in this process, whose first sweep is bitwise the single-device
  bf16 sweep's;
* ``contract_for`` of a bf16 model against the reference's, field by
  field.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.runtime import run_world
from torch_threads import _one_thread  # noqa: F401 (autouse)

HERE = Path(__file__).resolve().parent

K = 8
N_ROWS, N_COLS = 96, 48
D_SIDE = 12
GFA_N, GFA_DIMS = 64, (40, 24, 18)
MODELS = ("gaussian", "gaussian_fixed", "probit", "macau", "dense_full",
          "dense_masked", "gfa")
# one entity update from identical inputs: the bf16 copies are the same
# bits in both packages (one rounding of one fp32 value), every product
# of two bf16 values is exact in fp32, so the packages differ only by the
# order of fp32 sums (Gram, Cholesky, solves): the reference's chain
# tolerance holds with room
UPDATE_TOL = dict(rtol=2e-4, atol=2e-4)
# spike-and-slab's hypers (rho, tau) at the reference's SnS tolerance
SNS_TOL = dict(rtol=2e-3, atol=2e-3)
# sweep-end metrics from the same factors: sums of squared residuals in
# another order
METRIC_RTOL = 1e-5
# a session chain of CHAIN_SWEEPS sweeps in each package: after the first
# entity update the two packages' fp32 factors differ by ULPs, and an
# element near a bf16 rounding boundary rounds to the other neighbour in
# one package (a 2^-8 relative step) that the chain then carries and
# grows.  The traces are held sweep by sweep at 1e-2 relative, about ten
# times the largest drift seen (8.6e-4, alpha at the eighth sweep), and
# no factor is held elementwise
CHAIN_SWEEPS = 8
CHAIN_RTOL = 1e-2


def _no_jax():
    assert "jax" not in sys.modules and "repro" not in sys.modules, \
        "a rank imported jax or the reference package"


def build(pkg, name, bf16=True, **kw):
    """(ModelDef, MFData) of one test model through ``pkg``'s
    ``ModelBuilder(bf16_gather=bf16)`` from numpy inputs of a fixed
    seed: sparse Gaussian (adaptive or fixed noise), probit, Macau with
    side information, a fully observed dense block, a masked one under
    probit, and GFA (FixedNormal samples against spike-and-slab views:
    fully observed, masked and sparse)."""
    rng = np.random.default_rng(0)
    b = pkg.ModelBuilder(K, bf16_gather=bf16, **kw)
    if name == "gfa":
        Z = rng.normal(size=(GFA_N, K)).astype(np.float32)
        b.add_entity("samples", GFA_N, prior="fixednormal")
        for m, D in enumerate(GFA_DIMS):
            W = rng.normal(size=(D, K)).astype(np.float32)
            W[:, rng.random(K) < 0.3] = 0.0
            X = (Z @ W.T + 0.1 * rng.normal(size=(GFA_N, D))).astype(
                np.float32)
            b.add_entity(f"view{m}", D, prior="spikeandslab")
            if m == 0:
                b.add_block("samples", "view0", X,
                            noise=pkg.AdaptiveGaussian())
            elif m == 1:
                b.add_block("samples", "view1", X, mask=(
                    rng.random((GFA_N, D)) > 0.2).astype(np.float32),
                    noise=pkg.AdaptiveGaussian())
            else:
                i, j = np.nonzero(rng.random((GFA_N, D)) < 0.5)
                b.add_block("samples", "view2", pkg.from_coo(
                    i, j, X[i, j], (GFA_N, D), **kw),
                    noise=pkg.AdaptiveGaussian())
        model, data, _ = b.build()
        return model, data
    if name == "macau":
        b.add_entity("r", N_ROWS, side_info=rng.normal(
            size=(N_ROWS, D_SIDE)).astype(np.float32))
    else:
        b.add_entity("r", N_ROWS)
    b.add_entity("c", N_COLS)
    if name.startswith("dense"):
        R = rng.normal(size=(N_ROWS, N_COLS)).astype(np.float32)
        if name == "dense_full":
            b.add_block("r", "c", R, noise=pkg.FixedGaussian(5.0))
        else:
            m = (rng.random((N_ROWS, N_COLS)) < 0.6).astype(np.float32)
            b.add_block("r", "c", (R > 0).astype(np.float32), mask=m,
                        noise=pkg.ProbitNoise())
    else:
        mat, _, _ = pkg.random_sparse(0, (N_ROWS, N_COLS), 0.2, rank=4,
                                      binary=name == "probit", **kw)
        noise = {"gaussian": pkg.AdaptiveGaussian(),
                 "probit": pkg.ProbitNoise()}.get(name,
                                                   pkg.FixedGaussian(5.0))
        b.add_block("r", "c", mat, noise=noise)
    model, data, _ = b.build()
    return model, data


def _jax():
    """(jax, jnp, repro.core) imported here, never at module import: the
    gloo ranks import this module."""
    import jax
    import jax.numpy as jnp
    import repro.core as jc
    return jax, jnp, jc


def _bf16_pair(x: np.ndarray):
    """One fp32 array rounded to bf16 by each package: the same bits."""
    _, jnp, _ = _jax()
    t = torch.from_numpy(x).bfloat16()
    j = jnp.asarray(x).astype(jnp.bfloat16)
    assert np.array_equal(t.float().numpy(), np.asarray(j, np.float32))
    return t, j


# ---------------------------------------------------------------------------
# the plain versions of the kernels' bf16 branches
# ---------------------------------------------------------------------------

def _sddmm_cases():
    from repro_torch.kernels import ops as tops
    probes = [(f"{label}", E, K) for label, (E, K)
              in tops.KERNELS["sddmm_bf16"].items()]
    return probes + [("ragged e37 K9", 37, 9)]


# fp32 sums of the same exact products (a product of two bf16 values, or
# of an fp32 and a widened bf16, is exact in fp32 or rounded once), in
# another order: the error of a sum grows with the sum of its terms'
# magnitudes, so the bound is that sum times SUM_RTOL
SUM_RTOL = 1e-5
SUM_ATOL = 1e-6


def _close_to_magnitude(got, want, scale, what):
    got, want, scale = (np.asarray(x, np.float64) for x in (got, want,
                                                           scale))
    bad = np.abs(got - want) > SUM_ATOL + SUM_RTOL * scale
    assert not bad.any(), (f"{what}: {int(bad.sum())} elements, max "
                           f"|diff| {np.abs(got - want).max():.3e}")


@pytest.mark.parametrize("entry", ["sddmm", "gathered", "padded_mixed"])
@pytest.mark.parametrize("label,E,K", _sddmm_cases())
def test_sddmm_plain_versions_match_reference(entry, label, E, K):
    """``sddmm_ref`` (bf16 x bf16), ``gathered_sddmm_ref`` (bf16 rows of
    both factors) and ``gathered_sddmm_padded_ref`` (fp32 u against bf16
    rows: probit's predictions) against the reference's expressions:
    ``ref.sddmm_ref`` and the sweep's ``einsum("rtk,rk->rt", vg, u)``."""
    jax, jnp, _ = _jax()
    from repro.kernels import ref as jref
    from repro_torch.kernels import ops as tops
    rng = np.random.default_rng(E + K)
    n_u, n_v = max(E // 7, 3), max(E // 5, 3)
    U = rng.normal(size=(n_u, K)).astype(np.float32)
    V = rng.normal(size=(n_v, K)).astype(np.float32)
    i = rng.integers(0, n_u, E).astype(np.int32)
    j = rng.integers(0, n_v, E).astype(np.int32)
    tU, jU = _bf16_pair(U)
    tV, jV = _bf16_pair(V)
    wU, wV = tU.float().numpy(), tV.float().numpy()
    if entry == "sddmm":
        got = tops.sddmm(tU[i], tV[j])
        assert got.dtype == torch.float32
        want = jref.sddmm_ref(jU[i], jV[j])
        scale = np.einsum("ek,ek->e", np.abs(wU[i]), np.abs(wV[j]))
    elif entry == "gathered":
        got = tops.gathered_sddmm(tU, tV, torch.from_numpy(i),
                                  torch.from_numpy(j))
        want = jref.sddmm_ref(jU[i], jV[j])
        scale = np.einsum("ek,ek->e", np.abs(wU[i]), np.abs(wV[j]))
    else:
        T = 7
        R = max(E // T, 1)
        u = rng.normal(size=(R, K)).astype(np.float32)
        idx = rng.integers(0, n_v, (R, T)).astype(np.int32)
        got = tops.gathered_sddmm_padded(torch.from_numpy(u), tV,
                                         torch.from_numpy(idx))
        with jax.threefry_partitionable(False):
            want = jnp.einsum("rtk,rk->rt", jV[idx], jnp.asarray(u))
        assert want.dtype == jnp.float32
        scale = np.einsum("rtk,rk->rt", np.abs(wV[idx]), np.abs(u))
    _close_to_magnitude(got.numpy(), np.asarray(want), scale,
                        f"{entry} {label}")


def _gram_cases():
    from repro_torch.kernels import ops as tops
    (R, T, K), _ = tops.KERNELS["gram"]["bf16 gathered operands"]
    return [("bf16 gathered operands", R, T, K, False),
            ("uneven tail r13 t257 K33", 13, 257, 33, True),
            ("ragged r5 t37 K9", 5, 37, 9, True)]


@pytest.mark.parametrize("label,R,T,K,with_acc", _gram_cases())
def test_gathered_gram_plain_version_matches_reference(label, R, T, K,
                                                       with_acc):
    """``gathered_gram_ref`` on a bf16 fixed factor against the
    reference's half-sweep: ``alpha * gram_ref(fixed[idx], vals, mask)``
    in its bf16 branch (then ``acc +`` and ``+ Lambda_p`` where given).
    The reference rounds ``val * mask`` to bf16 before the rhs product:
    widening the rows and running the fp32 program instead gives another
    rhs, outside the tolerance."""
    jax, jnp, _ = _jax()
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref as tref
    rng = np.random.default_rng(R * T)
    n_fixed = 3 * R + 11
    fixed = rng.normal(size=(n_fixed, K)).astype(np.float32)
    idx = rng.integers(0, n_fixed, (R, T)).astype(np.int32)
    val = rng.normal(size=(R, T)).astype(np.float32)
    mask = (rng.random((R, T)) > 0.3).astype(np.float32)
    alpha = np.float32(3.7)
    tf, jf = _bf16_pair(fixed)
    acc = lam = None
    if with_acc:
        acc = (rng.normal(size=(R, K, K)).astype(np.float32),
               rng.normal(size=(R, K)).astype(np.float32))
        lam = rng.normal(size=(K, K)).astype(np.float32)
    t = [torch.from_numpy(x) for x in (idx, val, mask)]
    g, r = tref.gathered_gram_ref(
        tf, *t, torch.tensor(alpha),
        acc=None if acc is None else tuple(torch.from_numpy(a.copy())
                                           for a in acc),
        lam=None if lam is None else torch.from_numpy(lam))
    jg, jr = jref.gram_ref(jf[idx], jnp.asarray(val), jnp.asarray(mask))
    jg, jr = np.asarray(alpha * jg), np.asarray(alpha * jr)
    if with_acc:
        jg, jr = (acc[0] + jg) + lam, acc[1] + jr
    wv = tf.float().numpy()[idx]
    m = mask[..., None]
    gscale = alpha * np.einsum("rtk,rtl->rkl", np.abs(wv) * m, np.abs(wv))
    rscale = alpha * np.einsum("rtk,rt->rk", np.abs(wv), np.abs(val * mask))
    if with_acc:
        gscale, rscale = gscale + np.abs(acc[0]) + np.abs(lam), \
            rscale + np.abs(acc[1])
    _close_to_magnitude(g.numpy(), jg, gscale, f"gram {label}")
    _close_to_magnitude(r.numpy(), jr, rscale, f"rhs {label}")
    # the fp32 program on the widened rows: val * mask not rounded
    _, wide_r = tref.gathered_gram_ref(tf.float(), *t, torch.tensor(alpha))
    wide_r = wide_r.numpy() + (acc[1] if with_acc else 0.0)
    assert (np.abs(wide_r - jr) > SUM_ATOL + SUM_RTOL * rscale).any()


def _topk_cases():
    from repro_torch.kernels import ops as tops
    cases = [(label, us, v, k, 0.0) for label, (us, v, k)
             in tops.KERNELS["topk_score_bf16"].items()]
    return cases + [("ragged + exclusions b3 s5 n77 K9 k11 bf16",
                     (3, 5, 9), (5, 77, 9), 11, 0.3)]


@pytest.mark.parametrize("label,us_shape,v_shape,k,excl_frac",
                         _topk_cases())
def test_topk_plain_version_matches_reference(label, us_shape, v_shape, k,
                                              excl_frac):
    """``ops.topk_score`` on bf16 us and v (the plain version's bf16
    branch) against the reference's jnp path on the same bf16 operands,
    at ``ref.check_topk_score``'s tolerance; a batched call is bitwise B
    single-user calls, as in fp32."""
    jax, jnp, _ = _jax()
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops as tops
    from repro_torch.kernels import ref as tref
    rng = np.random.default_rng(k)
    us = rng.normal(size=us_shape).astype(np.float32)
    v = rng.normal(size=v_shape).astype(np.float32)
    excl = None
    if excl_frac:
        excl = (rng.random((us_shape[0], v_shape[1])) < excl_frac).astype(
            np.float32)
    tus, jus = _bf16_pair(us)
    tv, jv = _bf16_pair(v)
    got = tops.topk_score(tus, tv, k, exclude=excl)
    with jax.threefry_partitionable(False):
        want = jops.topk_score(jus, jv, k, exclude=excl)
    tref.check_topk_score(got, [torch.from_numpy(np.array(x))
                                for x in want], tus.float(), tv.float(),
                          what=label)
    for b in range(us_shape[0]):
        one = tops.topk_score(tus[b:b + 1], tv, k, exclude=None if excl
                              is None else excl[b:b + 1])
        for a, c in zip(got, one):
            assert torch.equal(a[b:b + 1], c) or (
                torch.isnan(a[b:b + 1]) == torch.isnan(c)).all() and \
                torch.equal(torch.nan_to_num(a[b:b + 1]),
                            torch.nan_to_num(c)), (label, b)


# ---------------------------------------------------------------------------
# one sweep of each model kind from one converted state
# ---------------------------------------------------------------------------

def _convert(st):
    from repro_torch import convert
    return convert.state_from_reference(st.key, st.factors, st.hypers,
                                        st.noises, st.step, device="cpu")


@pytest.mark.parametrize("name", MODELS)
def test_one_sweep_from_the_reference_state(name):
    """The reference's second bf16 sweep from its own state, entity by
    entity in the port: entity e's update from the reference's factors
    and hypers (its new ones for the entities before e), held at
    UPDATE_TOL, spike-and-slab's inclusion pattern equal and its
    rho/tau at SNS_TOL; then the sweep-end noise states and metrics
    from the reference's new factors, at METRIC_RTOL.  The port's
    ``gibbs_step`` from the same state gives the first entity's update
    bit for bit."""
    jax, _, jc = _jax()
    from repro.core import gibbs as jgibbs
    from repro_torch import convert
    from repro_torch import core as tc
    from repro_torch import random as trandom
    from repro_torch.core import gibbs as tgibbs
    jm, jd = build(jc, name)
    tm, _ = build(tc, name, device="cpu")
    assert jm.bf16_gather and tm.bf16_gather
    with jax.threefry_partitionable(False):
        st0 = jgibbs.init_state(jm, jd, seed=0)
        st0, _ = jgibbs.gibbs_step(jm, jd, st0)
        st1, m1 = jgibbs.gibbs_step(jm, jd, st0)
    ts0, want = _convert(st0), _convert(st1)
    td = convert.data_from_reference(jd.blocks, jd.sides, device="cpu")
    E = len(tm.entities)
    ekeys = trandom.split(ts0.key, E + 2)[1:]
    first = None
    for e in range(E):
        f = tuple(want.factors[o] if o < e else ts0.factors[o]
                  for o in range(E))
        h = tuple(want.hypers[o] if o < e else ts0.hypers[o]
                  for o in range(E))
        u, hyper = tgibbs._entity_update(tm, td, ekeys[e], e, f, h,
                                         ts0.noises)
        first = u if e == 0 else first
        w = want.factors[e]
        if "rho" in hyper:
            assert torch.equal(u != 0, w != 0), (name, e)
            for k in ("rho", "tau"):
                torch.testing.assert_close(hyper[k], want.hypers[e][k],
                                           **SNS_TOL)
        torch.testing.assert_close(u, w, **UPDATE_TOL,
                                   msg=f"{name} entity {e}")
    noises, metrics = tgibbs._sweep_end(tm, td, ekeys[-1], want.factors,
                                        ts0.noises)
    for k, v in metrics.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(m1[k]),
                                   rtol=METRIC_RTOL, err_msg=f"{name} {k}")
    for bi, nz in enumerate(noises):
        np.testing.assert_allclose(nz["alpha"].numpy(),
                                   np.asarray(st1.noises[bi]["alpha"]),
                                   rtol=METRIC_RTOL)
    st, _ = tgibbs.gibbs_step(tm, td, ts0)
    assert torch.equal(st.factors[0], first)


def _chain(pkg, name, **kw):
    """rmse_train_0 and alpha_0 of each sweep of a bf16 session."""
    rng = np.random.default_rng(3)
    b = pkg.ModelBuilder(K, bf16_gather=True, **kw)
    b.add_entity("r", N_ROWS).add_entity("c", N_COLS)
    U = rng.normal(size=(N_ROWS, 4)).astype(np.float32)
    V = rng.normal(size=(N_COLS, 4)).astype(np.float32)
    i, j = np.nonzero(rng.random((N_ROWS, N_COLS)) < 0.3)
    x = (np.einsum("ek,ek->e", U[i], V[j])
         + 0.3 * rng.normal(size=i.shape)).astype(np.float32)
    b.add_block("r", "c", pkg.from_coo(i, j, x, (N_ROWS, N_COLS), **kw),
                noise=pkg.AdaptiveGaussian())
    got = {"rmse_train": [], "alpha": []}

    def trace(info):
        got["rmse_train"].append(float(info.metrics["rmse_train_0"]))
        got["alpha"].append(float(info.metrics["alpha_0"]))

    b.session(burnin=CHAIN_SWEEPS, nsamples=0, seed=5,
              callbacks=[trace]).run()
    return got


def test_session_chain_traces_are_close_to_the_reference():
    """A ``ModelBuilder(bf16_gather=True)`` session of CHAIN_SWEEPS
    sweeps in each package from one seed: the rmse and alpha traces
    agree within CHAIN_RTOL, sweep by sweep, and both chains learn."""
    jax, _, jc = _jax()
    from repro_torch import core as tc
    with jax.threefry_partitionable(False):
        want = _chain(jc, "gaussian")
    got = _chain(tc, "gaussian", device="cpu")
    for key in ("rmse_train", "alpha"):
        np.testing.assert_allclose(got[key], want[key], rtol=CHAIN_RTOL,
                                   err_msg=key)
    assert got["rmse_train"][-1] < got["rmse_train"][0]
    d = max(abs(a - b) / abs(b) for key in got
            for a, b in zip(got[key], want[key]))
    print(f"bf16 session chain: largest relative trace difference {d:.2e}")


@pytest.mark.parametrize("name", ["probit", "gfa"])
def test_each_chain_is_its_single_chain_run(name):
    """Several bf16 chains (``multi_chain_step``, a loop over chains):
    chain c is bitwise the single-chain bf16 run keyed
    ``chain_keys(seed, C)[c]``, two sweeps, and the metrics stack."""
    from repro_torch import core as tc
    from repro_torch.core import gibbs as tgibbs
    model, data = build(tc, name, device="cpu")
    states = tgibbs.init_chain_states(model, data, 3, 2)
    stacked = tgibbs.stack_states(states)
    for _ in range(2):
        stacked, metrics = tgibbs.multi_chain_step(model, data, stacked)
    for c, st in enumerate(states):
        for _ in range(2):
            st, m = tgibbs.gibbs_step(model, data, st)
        for a, b in zip(stacked.factors, st.factors):
            assert torch.equal(a[c], b), (name, c)
        for k, v in m.items():
            assert torch.equal(metrics[k][c], v), (name, c, k)


# ---------------------------------------------------------------------------
# without the flag: the fp32 program
# ---------------------------------------------------------------------------

class _Dtypes(torch.utils._python_dispatch.TorchDispatchMode):
    """The dtypes of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for x in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(x, torch.Tensor):
                self.seen.add(x.dtype)
        return out


@pytest.mark.parametrize("name", ["gaussian", "probit", "dense_full", "gfa"])
def test_flag_off_is_the_default_and_makes_no_bf16(name):
    """``bf16_gather`` is False unless asked for, ``gather_view`` then
    hands out the factors themselves, and a sweep makes no bf16 tensor;
    with the flag every factor the sweep gathers is copied to bf16 once
    an entity update (the reference's ``_gather_view``)."""
    from repro_torch import core as tc
    from repro_torch.core import gibbs as tgibbs
    model, data = build(tc, name, bf16=False, device="cpu")
    assert not model.bf16_gather
    assert not dataclasses.replace(model, bf16_gather=False).bf16_gather
    default = tc.ModelDef(model.entities, model.blocks, model.num_latent,
                          device="cpu")
    assert default == model
    st = tc.init_state(model, data, seed=0)
    view = tgibbs.gather_view(model, st.factors)
    assert all(view(e) is f for e, f in enumerate(st.factors))
    with _Dtypes() as mode:
        tc.gibbs_step(model, data, st)
    assert torch.bfloat16 not in mode.seen
    on = dataclasses.replace(model, bf16_gather=True)
    view = tgibbs.gather_view(on, st.factors)
    assert view(0).dtype == torch.bfloat16 and view(0) is view(0)
    assert torch.equal(view(0).float(), st.factors[0].bfloat16().float())


# ---------------------------------------------------------------------------
# stores
# ---------------------------------------------------------------------------

def _store(pkg, d, **kw):
    rng = np.random.default_rng(7)
    b = pkg.ModelBuilder(K, bf16_gather=True, **kw)
    b.add_entity("r", 40).add_entity("c", 30)
    mat, test, _ = pkg.random_sparse(2, (40, 30), 0.3, rank=3, **kw)
    b.add_block("r", "c", mat, test=test, noise=pkg.AdaptiveGaussian())
    b.session(burnin=1, nsamples=2, seed=1, save_freq=1,
              save_dir=str(d)).run()
    return rng.integers(0, 40, 25), rng.integers(0, 30, 25)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_bf16_store_loads_in_the_other_package(tmp_path, writer):
    """A store trained with ``bf16_gather=True`` writes the flag into
    ``model.json``; the other package's ``PredictSession`` loads it (the
    port refused such stores before this slice), keeps the flag, and
    both predict the same values at rtol 1e-5 / atol 1e-6 (fp32 dot
    products of the same samples, summed in another order)."""
    import json
    jax, _, jc = _jax()
    from repro_torch import core as tc
    if writer == "port":
        rows, cols = _store(tc, tmp_path, device="cpu")
    else:
        with jax.threefry_partitionable(False):
            rows, cols = _store(jc, tmp_path)
    spec = json.loads((tmp_path / "model.json").read_text())
    assert spec["bf16_gather"] is True
    tp = tc.PredictSession(str(tmp_path), device="cpu")
    with jax.threefry_partitionable(False):
        jp = jc.PredictSession(str(tmp_path))
        want = np.asarray(jp.predict(rows, cols))
    assert tp.model.bf16_gather and jp.model.bf16_gather
    np.testing.assert_allclose(np.asarray(tp.predict(rows, cols)), want,
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the distributed sweep
# ---------------------------------------------------------------------------

DIST_MODELS = ("gaussian", "probit", "dense_full")
PIPELINES = ("eager", "ring")
DIST_SWEEPS = 2
MESHES = {2: ((2,), ("data",)), 4: ((2, 2), ("data", "model"))}
COUNTS = ("all_gathers", "collective_permutes", "all_reduces",
          "max_reduce_elems", "wire_elems")
# the sharded first sweep against the single-device one: the reference's
# distributed tolerance (the hyper moments summed in another order move
# the fp32 factors by ULPs; a bf16 copy of an element at a rounding
# boundary may then round the other way in the later half-sweep)
DIST_TOL = dict(rtol=2e-4, atol=2e-4)
RMSE_RTOL = 1e-3


def rank_bf16(rank, world, out):
    """The bf16 models under both pipelines on this world's mesh: each
    sweep's census and the gathered state and metrics."""
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch import core as tc
    from repro_torch.core import distributed as D
    shape, names = MESHES[world]
    mesh = DeviceMesh("cpu", torch.arange(world).reshape(shape),
                      mesh_dim_names=names)
    for name in DIST_MODELS:
        model, data = build(tc, name, device="cpu")
        st0 = tc.init_state(model, data, seed=0)
        for pipe in PIPELINES:
            step, ldata, st = D.make_distributed_step(model, mesh, data,
                                                      st0, pipe)
            assert step.supported and step.layout.n_shards == world
            rec = {}
            for s in range(DIST_SWEEPS):
                D.reset_census()
                st, m = step(ldata, st)
                c = D.census()
                for k in COUNTS:
                    rec[f"s{s}_{k}"] = c[k]
                rec[f"s{s}_wire"] = ",".join(c["wire_dtypes"])
                for e, f in enumerate(step.gather_state(st).factors):
                    rec[f"s{s}_f{e}"] = f.numpy()
                for k, v in m.items():
                    rec[f"s{s}_m_{k}"] = v.numpy()
            np.savez(Path(out) / f"{name}_{pipe}_rank{rank}.npz", **rec)
    _no_jax()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Worlds of 2 and 4 gloo ranks, one after the other."""
    outs = {}
    for world in MESHES:
        base = tmp_path_factory.mktemp(f"bf16_world{world}")
        out = base / "out"
        out.mkdir()
        run_world("test_torch_bf16_gather:rank_bf16", world,
                  workdir=base / "world", args=(str(out),),
                  extra_paths=[str(HERE)], timeout_s=600)
        outs[world] = out
    return outs


_SINGLE = {}


def _single_device(name):
    """The port's single-device bf16 chain: (states, metrics) a sweep."""
    if name not in _SINGLE:
        from repro_torch import core as tc
        model, data = build(tc, name, device="cpu")
        st = tc.init_state(model, data, seed=0)
        states, metrics = [], []
        for _ in range(DIST_SWEEPS):
            st, m = tc.gibbs_step(model, data, st)
            states.append(st)
            metrics.append(m)
        _SINGLE[name] = (states, metrics)
    return _SINGLE[name]


@pytest.mark.parametrize("pipe", PIPELINES)
@pytest.mark.parametrize("name", DIST_MODELS)
@pytest.mark.parametrize("world", list(MESHES))
def test_distributed_bf16_wire_and_chain(worlds, world, name, pipe):
    """Every rank's every sweep: the collectives ``contract_for`` says,
    the exchange in bf16 (``wire_dtypes == ["bf16"]``), and its bytes
    (elements sent, 2 bytes each; an all-gather receives S - 1 times
    what it sends, a ring hop what it sends) plus the all-reduces'
    estimate equal to ``contract_wire_bytes``.  Rank 0's gathered first
    sweep against the single-device bf16 sweep at DIST_TOL, and the
    rmse of both sweeps at RMSE_RTOL."""
    from repro_torch import core as tc
    from repro_torch.analysis.contract import (check_census, contract_for,
                                               contract_wire_bytes)
    model, _ = build(tc, name, device="cpu")
    shape, _ = MESHES[world]
    c = contract_for(model, shape, pipe)
    assert c.wire_dtype == "bf16"
    S = c.n_shards
    frac = (S - 1) / S
    reduces = c.all_reduces * c.max_reduce_elems * 4 * frac
    ranks = [np.load(worlds[world] / f"{name}_{pipe}_rank{r}.npz")
             for r in range(world)]
    for r, rank in enumerate(ranks):
        for s in range(DIST_SWEEPS):
            counted = {k: int(rank[f"s{s}_{k}"]) for k in COUNTS}
            counted["wire_dtypes"] = str(rank[f"s{s}_wire"]).split(",")
            assert counted["wire_dtypes"] == ["bf16"]
            assert check_census(c, counted) == [], (r, s)
            received = counted["wire_elems"] * 2 * (
                S - 1 if pipe == "eager" else 1)
            assert int(received + reduces) == contract_wire_bytes(model, c)
    states, metrics = _single_device(name)
    for e, want in enumerate(states[0].factors):
        np.testing.assert_allclose(ranks[0][f"s0_f{e}"], want.numpy(),
                                   **DIST_TOL, err_msg=f"factor {e}")
    for s in range(DIST_SWEEPS):
        np.testing.assert_allclose(ranks[0][f"s{s}_m_rmse_train_0"],
                                   metrics[s]["rmse_train_0"].numpy(),
                                   rtol=RMSE_RTOL)


@pytest.fixture
def world1(tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        yield DeviceMesh("cpu", torch.arange(1), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("pipe", PIPELINES)
@pytest.mark.parametrize("name", MODELS)
def test_world_of_one_first_sweep_is_the_single_device_bits(world1, name,
                                                            pipe):
    """One rank: the first bf16 sweep's factors are bitwise the
    single-device bf16 sweep's (the same bf16 copies, the same float
    program; the collectives of one rank move nothing), and its census
    is ``contract_for``'s, the exchange in bf16."""
    from repro_torch import core as tc
    from repro_torch.analysis.contract import check_census, contract_for
    from repro_torch.core import distributed as D
    model, data = build(tc, name, device="cpu")
    st0 = tc.init_state(model, data, seed=0)
    want, _ = tc.gibbs_step(model, data, st0)
    step, ldata, st = D.make_distributed_step(model, world1, data, st0,
                                              pipe)
    assert step.supported
    D.reset_census()
    st, _ = step(ldata, st)
    for e, f in enumerate(st.factors):
        assert torch.equal(f, want.factors[e]), (name, e)
    # eager gathers in bf16 at one rank; the ring of one rank has no hop
    assert check_census(contract_for(model, (1,), pipe), D.census()) == []


@pytest.mark.parametrize("pipe", PIPELINES)
@pytest.mark.parametrize("name", MODELS)
def test_contract_for_matches_reference(name, pipe):
    """``contract_for`` of a bf16 model is the reference's, field by
    field (wire ``"bf16"``), and ``contract_wire_bytes`` too."""
    _, _, jc = _jax()
    from repro.analysis import contract as jcontract
    from repro_torch import core as tc
    from repro_torch.analysis.contract import (contract_for,
                                               contract_wire_bytes)
    model, _ = build(tc, name, device="cpu")
    jmodel, _ = build(jc, name)
    for shape in ((4, 2), (2,)):
        c = contract_for(model, shape, pipe)
        jc_ = jcontract.contract_for(jmodel, shape, pipe)
        assert c.asdict() == jc_.asdict()
        assert c.wire_dtype == "bf16"
        assert contract_wire_bytes(model, c) == \
            jcontract.contract_wire_bytes(jmodel, jc_)
