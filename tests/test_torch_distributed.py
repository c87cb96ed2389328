"""The distributed Gibbs sweep of the port (``repro_torch.core.
distributed``) against the single-device chains of the port and of
``repro``.

Worlds of ranks are processes (``repro_torch.runtime.run_world``): gloo
on the CPU, one thread a rank, a ``file://`` rendezvous under
``tmp_path`` (no TCP port, so xdist workers never collide), and a join
timeout a world.  The ranks import ``repro_torch`` alone (each asserts
that no ``jax`` module is loaded); JAX runs in the pytest process only,
inside ``jax.threefry_partitionable(False)``.  The ranks write shards,
hypers, metrics and census to ``.npz`` and the checks below compare
them, one case a (model, pipeline, check).

* **world of 8** (module fixture), the reference's 96 x 48 at K = 8 on
  a ("data" 4, "model" 2) mesh, 3 sweeps of gaussian (adaptive noise),
  probit, macau with side information, dense (fully observed, and
  masked under probit), gfa (FixedNormal + spike-and-slab views) and
  sparse spike-and-slab, eager and ring:
  - factors and metrics against the port's single-device chain and
    against ``repro``'s ``gibbs_step`` at the reference's 2e-4 (rmse
    rtol 1e-3; spike-and-slab rho/tau at its 2e-3);
  - the per-row draws of every sweep: each shard's bitwise the slice of
    the single-device draw, which is bitwise ``repro``'s;
  - hypers, noise states and metrics bitwise equal across ranks;
  - the counted collectives of each sweep equal ``contract_for``, and
    the port's ``contract_for`` equals the reference's field by field;
  - ring against eager: bitwise where no block streams its moments
    (every sparse path, and probit's masked dense block), 2e-4 where a
    dense block folds them in chunk by chunk;
* **world of 1** in the pytest process: the first sweep's factors are
  bitwise the single-device sweep's for every model; later sweeps
  differ in ULPs only where an adaptive noise's alpha, summed over the
  padded slots instead of the COO, moves;
* **world of 4** (module fixture): two chains over ("chain" 2, "data"
  2), each bitwise its single-chain run on 2 shards, census by
  ``contract_for(chains=2, chain_axis_size=2)``; two chains without a
  chain axis on 4 shards, each bitwise its single-chain run; a
  ``TrainSession(mesh=...)`` two-chain store that ``PredictSession``
  reads in this process; a model outside the sharded subset warns with
  the reason and runs the whole single-device sweep on every rank;
* in this process: ``resolve_pipeline``, the unsupported reasons word
  for word against the reference's, the sessions' refusals and
  warnings; on a card, an NCCL world of 1 (``cuda`` marker).
"""
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.runtime import run_world
from torch_threads import _one_thread  # noqa: F401 (autouse)

HERE = Path(__file__).resolve().parent

K = 8
N_ROWS, N_COLS = 96, 48
GFA_N, GFA_DIMS = 96, (72, 48, 24)
D_SIDE = 12
SWEEPS = 3
MODELS = ("gaussian", "probit", "macau", "dense_full", "dense_masked", "gfa",
          "sparse_sns")
PIPELINES = ("eager", "ring")
# no block of these streams its moments through the ring (sparse, or
# probit's pred-dependent augmentation): the ring moves the same rows
# by copies, so the chain is eager's bit for bit
RING_BITWISE = ("gaussian", "probit", "macau", "dense_masked", "sparse_sns")
MESH8 = (4, 2)                   # ("data", "model")
TOL = dict(rtol=2e-4, atol=2e-4)
RMSE_RTOL = 1e-3
SNS_TOL = dict(rtol=2e-3, atol=2e-3)
COUNTS = ("all_gathers", "collective_permutes", "all_reduces",
          "max_reduce_elems")
PROBIT_EPS = 1e-7
NORMAL_ULPS = 4          # test_torch_random.py's bound on normal()


def _ulps(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a - b) / np.spacing(np.maximum(np.abs(a), 1e-30))


def build(pkg, name, **kw):
    """(ModelDef, MFData) of one test model through ``pkg``'s
    ModelBuilder (``repro.core`` or ``repro_torch.core``), from numpy
    inputs of a fixed seed."""
    rng = np.random.default_rng(0)
    b = pkg.ModelBuilder(K, **kw)
    if name == "gfa":
        Z = rng.normal(size=(GFA_N, K)).astype(np.float32)
        b.add_entity("samples", GFA_N, prior="fixednormal")
        for m, D in enumerate(GFA_DIMS):
            W = rng.normal(size=(D, K)).astype(np.float32)
            X = (Z @ W.T + 0.1 * rng.normal(size=(GFA_N, D))).astype(
                np.float32)
            b.add_entity(f"view{m}", D, prior="spikeandslab")
            b.add_block("samples", f"view{m}", X,
                        noise=pkg.AdaptiveGaussian())
        model, data, _ = b.build()
        return model, data
    if name == "macau":
        b.add_entity("r", N_ROWS, side_info=rng.normal(
            size=(N_ROWS, D_SIDE)).astype(np.float32))
    else:
        b.add_entity("r", N_ROWS)
    b.add_entity("c", N_COLS,
                 prior="spikeandslab" if name == "sparse_sns" else "normal")
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


def _width(payload, as_row):
    """Columns of a block's orientation: padded slots or dense cols."""
    if hasattr(payload, "rows"):
        return (payload.rows if as_row else payload.cols).idx.shape[1]
    return (payload.X if as_row else payload.XT).shape[1]


def sweep_draws(rnd, gibbs, model, data, key, rows):
    """The per-row draws the sweep from ``key`` takes, at the rows
    ``rows[e] = (count, global offset)`` of each entity: the factor
    normals, the spike-and-slab inclusion uniforms of component 0, and
    probit's latent uniforms at each probit block's orientation.
    ``rnd``/``gibbs`` are either package's ``random``/``gibbs``
    modules."""
    E = len(model.entities)
    ekeys = rnd.split(key, E + 2)[1:]
    out = {}
    for e, ent in enumerate(model.entities):
        n, off = rows[e]
        _, k_fac, k_blk = rnd.split(ekeys[e], 3)
        out[f"z{e}"] = gibbs.row_normals(k_fac, n, K, off)
        if type(ent.prior).__name__ == "SpikeAndSlabPrior":
            k_incl = rnd.split(k_fac)[0]
            out[f"incl{e}"] = gibbs.row_uniforms(rnd.fold_in(k_incl, 0), n,
                                                 1, off)
        bkeys = rnd.split(k_blk, max(1, len(model.blocks)))
        for bi, as_row in model.blocks_touching(e):
            if type(model.blocks[bi].noise).__name__ == "ProbitNoise":
                out[f"latent{e}_{bi}"] = gibbs.row_uniforms(
                    bkeys[bi], n, _width(data.blocks[bi], as_row), off,
                    minval=PROBIT_EPS,
                    maxval=1.0 - PROBIT_EPS)
    return out


def _no_jax():
    assert "jax" not in sys.modules and "repro" not in sys.modules, \
        "a rank imported jax or the reference package"


# ---------------------------------------------------------------------------
# what the ranks run (repro_torch only)
# ---------------------------------------------------------------------------

def _save(path, rec):
    np.savez(path, **{k: np.asarray(v) for k, v in rec.items()})


def _record_state(rec, tag, st):
    for e, f in enumerate(st.factors):
        rec[f"{tag}f{e}"] = f.numpy()
    for e, h in enumerate(st.hypers):
        for k, v in h.items():
            rec[f"{tag}h{e}_{k}"] = v.numpy()
    for bi, nz in enumerate(st.noises):
        rec[f"{tag}alpha{bi}"] = nz["alpha"].numpy()


def rank_models(rank, world, out):
    """Every model under both pipelines on the (4, 2) mesh."""
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch import core as tc
    from repro_torch import random as trandom
    from repro_torch.core import distributed as D
    from repro_torch.core import gibbs as tg
    mesh = DeviceMesh("cpu", torch.arange(world).reshape(MESH8),
                      mesh_dim_names=("data", "model"))
    for name in MODELS:
        model, data = build(tc, name, device="cpu")
        st0 = tc.init_state(model, data, seed=0)
        for pipe in PIPELINES:
            step, ldata, st = D.make_distributed_step(model, mesh, data,
                                                      st0, pipe)
            assert step.supported and step.layout.shard == rank
            rec = {}
            for s in range(SWEEPS):
                rows = {e: (f.shape[0], rank * f.shape[0])
                        for e, f in enumerate(st.factors)}
                for k, v in sweep_draws(trandom, tg, model, ldata, st.key,
                                        rows).items():
                    rec[f"s{s}_draw_{k}"] = v.numpy()
                D.reset_census()
                st, m = step(ldata, st)
                c = D.census()
                for k in COUNTS:
                    rec[f"s{s}_census_{k}"] = c[k]
                rec[f"s{s}_wire"] = ",".join(c["wire_dtypes"])
                _record_state(rec, f"s{s}_shard_", st)
                _record_state(rec, f"s{s}_", step.gather_state(st))
                for k, v in m.items():
                    rec[f"s{s}_m_{k}"] = v.numpy()
            _save(Path(out) / f"{name}_{pipe}_rank{rank}.npz", rec)
    _no_jax()


def rank_chains(rank, world, out, store):
    """Two chains over ("chain" 2, "data" 2) and over ("data" 4), each
    beside its single-chain runs; a two-chain ``TrainSession`` store; a
    session outside the sharded subset."""
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch import core as tc
    from repro_torch.core import distributed as D
    from repro_torch.core import gibbs as tg
    from repro_torch.obs import Recorder
    model, data = build(tc, "probit", device="cpu")
    states = tg.init_chain_states(model, data, 0, 2)
    stacked = tg.stack_states(states)
    meshes = {
        "axis": DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                           mesh_dim_names=("chain", "data")),
        # the same row groups of 2 as "axis", its first dim a replica dim
        "pairs": DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                            mesh_dim_names=("replica", "data")),
        "flat": DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("data",)),
    }
    rec = {}
    for tag, mesh_name, single_mesh, chain_axis, pipe in (
            ("axis_eager", "axis", "pairs", "chain", "eager"),
            ("axis_ring", "axis", "pairs", "chain", "ring"),
            ("flat_eager", "flat", "flat", None, "eager")):
        step, ldata, st = D.make_multi_chain_step(
            model, meshes[mesh_name], data, stacked, pipe, chains=2,
            chain_axis=chain_axis)
        for s in range(SWEEPS):
            D.reset_census()
            st, m = step(ldata, st)
            c = D.census()
            for k in COUNTS:
                rec[f"{tag}_s{s}_census_{k}"] = c[k]
            m = step.gather_metrics(m)
            for k, v in m.items():
                rec[f"{tag}_s{s}_m_{k}"] = v.numpy()
        rec[f"{tag}_local_chains"] = st.key.shape[0]
        for e, f in enumerate(st.factors):
            rec[f"{tag}_local_f{e}"] = f.numpy()
        _record_state(rec, f"{tag}_gathered_", step.gather_state(st))
        first = step.layout.chain_index * st.key.shape[0]
        for c in range(first, first + st.key.shape[0]):
            one, ld1, st1 = D.make_distributed_step(
                model, meshes[single_mesh], data, states[c], pipe)
            for s in range(SWEEPS):
                st1, m1 = one(ld1, st1)
                for k, v in m1.items():
                    rec[f"{tag}_single{c}_s{s}_m_{k}"] = v.numpy()
            for e, f in enumerate(st1.factors):
                rec[f"{tag}_single{c}_f{e}"] = f.numpy()

    # a two-chain TrainSession store, chains over the chain axis
    mat, test, _ = tc.random_sparse(0, (N_ROWS, N_COLS), 0.2, rank=4,
                                    device="cpu")
    rec_obs = Recorder(enabled=True)
    sess = tc.TrainSession(num_latent=K, burnin=2, nsamples=2, seed=0,
                           device="cpu", save_freq=1, save_dir=store,
                           mesh=meshes["axis"], pipeline="ring", chains=2,
                           chain_axis="chain", recorder=rec_obs)
    sess.add_train_and_test(mat, test=test, noise=tc.AdaptiveGaussian())
    res = sess.run()
    rec["session_predictions"] = res.predictions
    rec["session_rmse_test"] = res.rmse_test
    for c, blocks in enumerate(res.chain_blocks):
        rec[f"session_trace{c}"] = np.asarray(blocks[0].rmse_train_trace)
    _record_state(rec, "session_", res.state)
    rec["session_wire"] = [ev["args"]["bytes_on_wire"]
                           for ev in rec_obs.trace()["traceEvents"]
                           if ev.get("name") == "sweep"]

    # outside the sharded subset: 97 rows on 2 row shards
    b = tc.ModelBuilder(K, device="cpu")
    b.add_entity("r", 97).add_entity("c", N_COLS)
    odd, _, _ = tc.random_sparse(1, (97, N_COLS), 0.2, rank=4, device="cpu")
    b.add_block("r", "c", odd, noise=tc.AdaptiveGaussian())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fell = b.session(burnin=1, nsamples=1, seed=0,
                         mesh=meshes["axis"]).run()
    rec["fallback_warnings"] = "\n".join(str(w.message) for w in caught)
    whole = b.session(burnin=1, nsamples=1, seed=0).run()
    rec["fallback_bitwise"] = all(
        torch.equal(a, b_) for a, b_ in zip(fell.state.factors,
                                            whole.state.factors))
    _save(Path(out) / f"chains_rank{rank}.npz", rec)
    _no_jax()


# ---------------------------------------------------------------------------
# the worlds (module fixtures) and the single-device chains beside them
# ---------------------------------------------------------------------------

def _world(tmp_path_factory, name, target, size, *args):
    base = tmp_path_factory.mktemp(name)
    out = base / "out"
    out.mkdir()
    run_world(f"test_torch_distributed:{target}", size,
              workdir=base / "world", args=(str(out),) + args,
              extra_paths=[str(HERE)], timeout_s=600)
    return out


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    return _world(tmp_path_factory, "world8", "rank_models", 8)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    store = tmp_path_factory.mktemp("store")
    out = _world(tmp_path_factory, "world4", "rank_chains", 4,
                 str(store / "s"))
    return out, store / "s"


def _ranks(out, name, pipe, world=8):
    return [np.load(Path(out) / f"{name}_{pipe}_rank{r}.npz")
            for r in range(world)]


_CHAINS = {}


def port_chain(name):
    """The port's single-device chain: (states, metrics) after each
    sweep, and the sweeps' keys."""
    if name not in _CHAINS:
        from repro_torch import core as tc
        model, data = build(tc, name, device="cpu")
        st = tc.init_state(model, data, seed=0)
        states, metrics, keys = [], [], []
        for _ in range(SWEEPS):
            keys.append(st.key)
            st, m = tc.gibbs_step(model, data, st)
            states.append(st)
            metrics.append({k: v.numpy() for k, v in m.items()})
        _CHAINS[name] = (model, states, metrics, keys)
    return _CHAINS[name]


_REF_CHAINS = {}


def reference_chain(name):
    """``repro``'s single-device chain from the same inputs."""
    if name not in _REF_CHAINS:
        import jax
        import repro.core as jc
        model, data = build(jc, name)
        with jax.threefry_partitionable(False):
            st = jc.init_state(model, data, seed=0)
            states, metrics = [], []
            for _ in range(SWEEPS):
                st, m = jc.gibbs_step(model, data, st)
                states.append(jax.tree.map(np.asarray, st))
                metrics.append({k: np.asarray(v) for k, v in m.items()})
        _REF_CHAINS[name] = (model, states, metrics)
    return _REF_CHAINS[name]


def _hold_chain(ranks, states, metrics, name, where, slack=None):
    """The gathered chain of rank 0 against a single-device chain, each
    factor element within TOL plus ``slack[s][e]`` (elementwise; none by
    default)."""
    for s in range(SWEEPS):
        for e, want in enumerate(states[s].factors):
            got, want = ranks[0][f"s{s}_f{e}"], np.asarray(want)
            if slack is None:
                np.testing.assert_allclose(
                    got, want, **TOL, err_msg=f"{where}: sweep {s} "
                    f"factor {e}")
                continue
            bound = slack[s][e] + TOL["atol"] + TOL["rtol"] * np.abs(want)
            bad = np.abs(got - want) > bound
            assert not bad.any(), (f"{where}: sweep {s} factor {e}: "
                                   f"{int(bad.sum())} elements")
            hyper = states[s].hypers[e]
            if "rho" in hyper:
                for hk in ("rho", "tau"):
                    np.testing.assert_allclose(
                        ranks[0][f"s{s}_h{e}_{hk}"], np.asarray(hyper[hk]),
                        **SNS_TOL, err_msg=f"{where}: sweep {s} {hk}{e}")
        for k, want in metrics[s].items():
            np.testing.assert_allclose(
                ranks[0][f"s{s}_m_{k}"], want, rtol=RMSE_RTOL,
                err_msg=f"{where}: sweep {s} {k}")


# ---------------------------------------------------------------------------
# the world of 8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pipe", PIPELINES)
@pytest.mark.parametrize("name", MODELS)
def test_sharded_chain_matches_port_single_device(world8, name, pipe):
    _, states, metrics, _ = port_chain(name)
    _hold_chain(_ranks(world8, name, pipe), states, metrics, name,
                f"{name}/{pipe} vs port")


@pytest.mark.parametrize("pipe", PIPELINES)
@pytest.mark.parametrize("name", MODELS)
def test_sharded_chain_matches_reference_single_device(world8, name, pipe):
    """At 2e-4 of ``repro``'s chain.  Under probit noise the port's
    single-device chain is itself farther from ``repro``'s than that
    (the truncated normal's inverse CDF carries the few-ulp difference
    of ``erf_inv`` through its steep tails, ``test_torch_probit.py``):
    there each element is held within the single-device port's own
    distance from ``repro`` plus 2e-4, and the metrics at rtol 1e-3."""
    model, states, metrics = reference_chain(name)
    slack = None
    if any(type(b.noise).__name__ == "ProbitNoise" for b in model.blocks):
        _, port, _, _ = port_chain(name)
        slack = [[np.abs(p.numpy() - np.asarray(r))
                  for p, r in zip(port[s].factors, states[s].factors)]
                 for s in range(SWEEPS)]
    _hold_chain(_ranks(world8, name, pipe), states, metrics, name,
                f"{name}/{pipe} vs repro", slack)


@pytest.mark.parametrize("pipe", PIPELINES)
@pytest.mark.parametrize("name", MODELS)
def test_per_row_draws_are_bitwise_slices(world8, name, pipe):
    """Each shard's draws are bitwise the single-device draws of its
    rows.  Those are ``repro``'s bitwise for the uniforms, and within
    ``NORMAL_ULPS`` for the normals (``erf_inv``'s ``log1p`` differs by an
    ulp between XLA and torch, ``test_torch_random.py``)."""
    import jax
    from repro.core import gibbs as jg
    from repro_torch import random as trandom
    from repro_torch.core import gibbs as tg
    from repro_torch import core as tc
    model, _, _, keys = port_chain(name)
    _, data = build(tc, name, device="cpu")
    ranks = _ranks(world8, name, pipe)
    full = {e: (ent.n_rows, 0) for e, ent in enumerate(model.entities)}
    for s in range(SWEEPS):
        want = {k: v.numpy() for k, v in sweep_draws(
            trandom, tg, model, data, keys[s], full).items()}
        with jax.threefry_partitionable(False):
            ref = {k: np.asarray(v) for k, v in sweep_draws(
                jax.random, jg, model, data,
                jax.numpy.asarray(keys[s].numpy().astype(np.uint32)),
                full).items()}
        for k, w in want.items():
            if k.startswith("z"):
                assert _ulps(w, ref[k]).max() <= NORMAL_ULPS, (k, s)
            else:
                np.testing.assert_array_equal(w, ref[k], err_msg=f"{k} {s}")
            got = np.concatenate([r[f"s{s}_draw_{k}"] for r in ranks])
            np.testing.assert_array_equal(got, w, err_msg=f"{k} {s}")


@pytest.mark.parametrize("pipe", PIPELINES)
@pytest.mark.parametrize("name", MODELS)
def test_hypers_and_metrics_are_bitwise_equal_across_ranks(world8, name,
                                                           pipe):
    ranks = _ranks(world8, name, pipe)
    keys = [k for k in ranks[0].files if "_shard_h" in k
            or "_shard_alpha" in k or "_m_" in k]
    assert any("_shard_h" in k for k in keys)
    for k in keys:
        for r in range(1, len(ranks)):
            np.testing.assert_array_equal(ranks[r][k], ranks[0][k],
                                          err_msg=f"{k} rank {r}")


@pytest.mark.parametrize("pipe", PIPELINES)
@pytest.mark.parametrize("name", MODELS)
def test_census_equals_contract(world8, name, pipe):
    import repro.core as jc
    from repro.analysis import contract as jcontract
    from repro_torch import core as tc
    from repro_torch.analysis.contract import check_census, contract_for
    model, _ = build(tc, name, device="cpu")
    c = contract_for(model, MESH8, pipe)
    jmodel, _ = build(jc, name)
    assert c.asdict() == jcontract.contract_for(jmodel, MESH8,
                                                pipe).asdict()
    for r, rank in enumerate(_ranks(world8, name, pipe)):
        for s in range(SWEEPS):
            counted = {k: int(rank[f"s{s}_census_{k}"]) for k in COUNTS}
            counted["wire_dtypes"] = str(rank[f"s{s}_wire"]).split(",")
            assert check_census(c, counted) == [], (r, s)


@pytest.mark.parametrize("name", MODELS)
def test_ring_matches_eager(world8, name):
    from repro_torch import core as tc
    from repro_torch.core import distributed as D
    model, _ = build(tc, name, device="cpu")
    streams = any(D._streamable(model, bi, e)
                  and type(ent.prior).__name__ != "SpikeAndSlabPrior"
                  for e, ent in enumerate(model.entities)
                  for bi, _ in model.blocks_touching(e))
    assert streams == (name not in RING_BITWISE)
    eager, ring = _ranks(world8, name, "eager"), _ranks(world8, name, "ring")
    for k in eager[0].files:
        if "census" in k or "wire" in k:
            continue
        a, b = eager[0][k], ring[0][k]
        if name in RING_BITWISE or "draw" in k:
            np.testing.assert_array_equal(a, b, err_msg=k)
        elif "_m_" in k:
            np.testing.assert_allclose(a, b, rtol=1e-4, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, **TOL, err_msg=k)


# ---------------------------------------------------------------------------
# a world of 1 in this process
# ---------------------------------------------------------------------------

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


@pytest.mark.parametrize("name", MODELS)
def test_world_of_one_first_sweep_is_bitwise(world1, name):
    """Eager at one rank: the first sweep's factors are bitwise the
    single-device sweep's.  Later sweeps may move by ULPs where an
    adaptive noise's alpha (its sse summed over the padded slots, not
    the COO) differs; the count of moved elements is printed."""
    from repro_torch import core as tc
    from repro_torch.core import distributed as D
    model, data = build(tc, name, device="cpu")
    _, states, _, _ = port_chain(name)
    step, ldata, st = D.make_distributed_step(
        model, world1, data, tc.init_state(model, data, seed=0), "eager")
    moved = []
    for s in range(SWEEPS):
        st, _ = step(ldata, st)
        for e, f in enumerate(st.factors):
            want = states[s].factors[e]
            if s == 0:
                assert torch.equal(f, want), (name, e)
            np.testing.assert_allclose(f.numpy(), want.numpy(), **TOL)
            moved.append(int((f != want).sum()))
    adaptive = any(type(b.noise).__name__ == "AdaptiveGaussian"
                   for b in model.blocks)
    if not adaptive:
        assert sum(moved) == 0, moved
    print(f"{name}: elements moved a sweep and entity {moved}")


# ---------------------------------------------------------------------------
# the world of 4: chains, a session store, the fallback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag", ["axis_eager", "axis_ring", "flat_eager"])
def test_each_chain_is_bitwise_its_single_chain_run(world4, tag):
    out, _ = world4
    for r in range(4):
        rank = np.load(out / f"chains_rank{r}.npz")
        local = int(rank[f"{tag}_local_chains"])
        first = (r // 2) * local if tag.startswith("axis") else 0
        assert local == (1 if tag.startswith("axis") else 2)
        for i, c in enumerate(range(first, first + local)):
            for e in range(2):
                np.testing.assert_array_equal(
                    rank[f"{tag}_local_f{e}"][i],
                    rank[f"{tag}_single{c}_f{e}"], err_msg=(tag, r, c, e))
            for s in range(SWEEPS):
                np.testing.assert_array_equal(
                    rank[f"{tag}_s{s}_m_rmse_train_0"][c],
                    rank[f"{tag}_single{c}_s{s}_m_rmse_train_0"])


@pytest.mark.parametrize("tag", ["axis_eager", "axis_ring", "flat_eager"])
def test_chain_census_equals_contract(world4, tag):
    import repro.core as jc
    from repro.analysis import contract as jcontract
    from repro_torch import core as tc
    from repro_torch.analysis.contract import check_census, contract_for
    out, _ = world4
    model, _ = build(tc, "probit", device="cpu")
    pipe = tag.split("_")[1]
    shape, axis = ((2, 2), 2) if tag.startswith("axis") else ((4,), None)
    c = contract_for(model, shape, pipe, chains=2, chain_axis_size=axis)
    jmodel, _ = build(jc, "probit")
    assert c.asdict() == jcontract.contract_for(
        jmodel, shape, pipe, chains=2, chain_axis_size=axis).asdict()
    for r in range(4):
        rank = np.load(out / f"chains_rank{r}.npz")
        for s in range(SWEEPS):
            counted = {k: int(rank[f"{tag}_s{s}_census_{k}"])
                       for k in COUNTS}
            counted["wire_dtypes"] = ["f32"]
            assert check_census(c, counted) == [], (r, s)


def test_gathered_chains_match_port_single_chains(world4):
    from repro_torch import core as tc
    from repro_torch.core import gibbs as tg
    out, _ = world4
    model, data = build(tc, "probit", device="cpu")
    rank = np.load(out / "chains_rank3.npz")
    for c, st in enumerate(tg.init_chain_states(model, data, 0, 2)):
        for _ in range(SWEEPS):
            st, _ = tc.gibbs_step(model, data, st)
        for tag in ("axis_eager", "axis_ring", "flat_eager"):
            for e, f in enumerate(st.factors):
                np.testing.assert_allclose(
                    rank[f"{tag}_gathered_f{e}"][c], f.numpy(), **TOL,
                    err_msg=(tag, c, e))


def test_train_session_store_is_read_by_predict_session(world4):
    """Rank 0 wrote a two-chain store; one process reads it, and its
    predictions are the session's.  Every rank's result is the same,
    the chains are the single-device session's at 2e-4, and the sweep
    spans carry the contract's bytes on the wire."""
    from repro_torch import core as tc
    from repro_torch.analysis.contract import (contract_for,
                                               contract_wire_bytes)
    out, store = world4
    ranks = [np.load(out / f"chains_rank{r}.npz") for r in range(4)]
    for r in range(1, 4):
        np.testing.assert_array_equal(ranks[r]["session_predictions"],
                                      ranks[0]["session_predictions"])
    mat, test, _ = tc.random_sparse(0, (N_ROWS, N_COLS), 0.2, rank=4,
                                    device="cpu")
    ps = tc.PredictSession(str(store), device="cpu")
    assert ps.n_chains == 2 and ps.num_samples == 4
    np.testing.assert_allclose(ps.predict(test[0], test[1]),
                               ranks[0]["session_predictions"],
                               rtol=1e-6, atol=1e-6)
    sess = tc.TrainSession(num_latent=K, burnin=2, nsamples=2, seed=0,
                           device="cpu", chains=2)
    sess.add_train_and_test(mat, test=test, noise=tc.AdaptiveGaussian())
    single = sess.run()
    np.testing.assert_allclose(ranks[0]["session_predictions"],
                               single.predictions, **TOL)
    for c in range(2):
        np.testing.assert_allclose(ranks[0][f"session_trace{c}"],
                                   single.chain_blocks[c][0]
                                   .rmse_train_trace, rtol=RMSE_RTOL)
        for e, f in enumerate(single.state.factors):
            np.testing.assert_allclose(ranks[0][f"session_f{e}"][c],
                                       f[c].numpy(), **TOL)
    model, _ = sess._build()
    want = contract_wire_bytes(model, contract_for(
        model, (2, 2), "ring", chains=2, chain_axis_size=2))
    assert want > 0
    assert list(ranks[0]["session_wire"]) == [want] * 4


def test_model_outside_the_subset_warns_and_runs_whole(world4):
    out, _ = world4
    for r in range(4):
        rank = np.load(out / f"chains_rank{r}.npz")
        msg = str(rank["fallback_warnings"])
        assert ("model is outside the sharded subset on this mesh "
                "(entity 'r' has 97 rows, not divisible by the 2-shard "
                "mesh); every rank runs the whole single-device sweep"
                in msg), msg
        assert bool(rank["fallback_bitwise"])


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------

def test_resolve_pipeline_validates_choices(monkeypatch):
    from repro_torch.core.distributed import resolve_pipeline
    monkeypatch.delenv("REPRO_PIPELINE", raising=False)
    assert resolve_pipeline() == "eager"
    assert resolve_pipeline("ring") == "ring"
    monkeypatch.setenv("REPRO_PIPELINE", "ring")
    assert resolve_pipeline() == "ring"
    assert resolve_pipeline("eager") == "eager"   # explicit wins
    with pytest.raises(ValueError, match="valid pipelines.*eager.*ring"):
        resolve_pipeline("warp")
    monkeypatch.setenv("REPRO_PIPELINE", "warp")
    with pytest.raises(ValueError, match="REPRO_PIPELINE"):
        resolve_pipeline()


class _Mesh:
    """Duck-typed meshes of S row shards for both packages' pure
    predicates: the reference reads ``axis_names``/``shape[name]``, the
    port ``mesh_dim_names``/``mesh.shape``."""

    def __init__(self, S):
        self.axis_names = self.mesh_dim_names = ("data",)
        self.shape = {"data": S}
        self.mesh = torch.arange(S)


def _unsupported_cases(pkg, **kw):
    import dataclasses as dc
    yield "rows", 5, build(pkg, "gaussian", **kw)
    model, data = build(pkg, "gaussian", **kw)
    odd = dc.replace(model.entities[0], prior=object())
    yield "prior", 2, (dc.replace(model, entities=(odd,)
                                  + model.entities[1:]), data)
    model, data = build(pkg, "macau", **kw)
    yield "macau", 2, (model, data._replace(sides=(None, None)))
    model, data = build(pkg, "gaussian", **kw)
    selfb = dc.replace(model.blocks[0], col_entity=0)
    yield "self", 2, (dc.replace(model, blocks=(selfb,)), data)
    noisy = dc.replace(model.blocks[0], noise=object())
    yield "noise", 2, (dc.replace(model, blocks=(noisy,)), data)
    model, data = build(pkg, "dense_full", **kw)
    yield "dense", 2, (model, data._replace(blocks=(object(),)))
    yield "fits", 2, (model, data)


def test_unsupported_reasons_are_the_references():
    import repro.core as jc
    from repro.core import distributed as JD
    from repro_torch import core as tc
    from repro_torch.core import distributed as D
    ref = {name: JD.distributed_unsupported_reason(m, _Mesh(S), d)
           for name, S, (m, d) in _unsupported_cases(jc)}
    port = {name: D.distributed_unsupported_reason(m, _Mesh(S), d)
            for name, S, (m, d) in _unsupported_cases(tc, device="cpu")}
    assert port == ref
    assert ref["fits"] is None and all(
        v for k, v in ref.items() if k != "fits")
    assert port["rows"] == ("entity 'r' has 96 rows, not divisible by "
                            "the 5-shard mesh")


def _session(kind, **kw):
    from repro_torch import core as tc
    X = np.random.default_rng(0).normal(size=(6, 5)).astype(np.float32)
    kw = dict(num_latent=2, burnin=1, nsamples=1, device="cpu", **kw)
    if kind == "TrainSession":
        return tc.TrainSession(**kw).add_train_and_test(X)
    if kind == "GFASession":
        return tc.GFASession([X], **kw)
    return tc.Session(*tc.TrainSession(**{
        k: v for k, v in kw.items() if k in ("num_latent", "device")})
        .add_train_and_test(X)._build(),
        **{k: v for k, v in kw.items()
           if k not in ("num_latent", "device")})


@pytest.mark.parametrize("kind", ["Session", "TrainSession", "GFASession"])
def test_sessions_refuse_and_warn_like_the_reference(kind):
    with pytest.raises(ValueError, match="chain_axis='chain' shards chains "
                       "over a mesh axis; pass mesh= too"):
        _session(kind, chain_axis="chain")
    with pytest.raises(ValueError, match="mesh= takes a torch.distributed"):
        _session(kind, mesh=object())
    with pytest.raises(ValueError, match="valid pipelines"):
        _session(kind, pipeline="warp")
    with pytest.warns(UserWarning, match="pipeline='ring' has no effect "
                      "without mesh=: the session runs the single-device "
                      "sweep"):
        _session(kind, pipeline="ring").run()


def test_model_device_must_be_the_ranks(monkeypatch):
    from repro_torch import core as tc
    from repro_torch.core import distributed as D
    model, data = build(tc, "gaussian", device="cpu")
    fake = _Mesh(1)
    fake.device_type = "cuda"
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(ValueError, match="build the model with the "
                       "rank's device"):
        D.make_distributed_step(model, fake, data,
                                tc.init_state(model, data, seed=0))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def rank_cuda(rank, world, out):
    """Gaussian, eager and ring, on this rank's card against the
    single-device sweep."""
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch import core as tc
    from repro_torch.core import distributed as D
    dev = f"cuda:{torch.cuda.current_device()}"
    model, data = build(tc, "gaussian", device=dev)
    mesh = DeviceMesh("cuda", torch.arange(world), mesh_dim_names=("data",))
    st0 = tc.init_state(model, data, seed=0)
    want = st0
    for _ in range(SWEEPS):
        want, _ = tc.gibbs_step(model, data, want)
    for pipe in PIPELINES:
        step, ldata, st = D.make_distributed_step(model, mesh, data, st0,
                                                  pipe)
        for _ in range(SWEEPS):
            st, _ = step(ldata, st)
        full = step.gather_state(st)
        for a, b in zip(full.factors, want.factors):
            torch.testing.assert_close(a, b, **TOL)
    _no_jax()


@pytest.mark.cuda
def test_nccl_world_of_one_matches_single_device(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    run_world("test_torch_distributed:rank_cuda", 1, device_type="cuda",
              workdir=tmp_path / "world", args=(str(tmp_path),),
              extra_paths=[str(HERE)], timeout_s=600)
