"""Elastic restart of the port's distributed sweep, through a checkpoint
on disk: the counterpart of ``tests/test_elastic.py``.

A ``torch.distributed`` world cannot shrink in place, so the restart is
what a lost card forces on a real machine:

  1. a gloo world of 8 ranks runs a sharded chain on the
     ``ElasticMesh`` of 8, gathering the whole state after every sweep
     into ``checkpoint.CheckpointManager`` (rank 0 writes it);
  2. ``runtime.fault.FailureSim`` raises ``DeviceLost`` at sweep 2 on
     every rank, and the world ends;
  3. a new world of the 6 survivors builds its ``ElasticMesh``, restores
     the last complete checkpoint from disk, places it on the 6 shards
     (``make_distributed_step``) and runs the chain to sweep 4.

The restarted chain is held against the uninterrupted single-device
chains of the port and of ``repro`` at the reference's 2e-4 (rmse rtol
1e-3; spike-and-slab rho/tau at 2e-3), for probit (eager and ring) and
for the GFA composition's spike-and-slab hyper state.  Under probit the
port's single-device chain is itself farther from ``repro``'s than
2e-4 (``test_torch_distributed.py``): there each element is held within
that distance plus 2e-4.  The ranks import ``repro_torch`` alone.
"""
import functools
from pathlib import Path

import numpy as np
import pytest

import test_torch_distributed as tdist
from repro_torch.runtime import run_world
from torch_threads import _one_thread  # noqa: F401 (autouse)

TOTAL, FAIL_AT = 4, 2
SCENARIOS = (("probit_eager", "probit", "eager"),
             ("gfa_eager", "gfa", "eager"),
             ("probit_ring", "probit", "ring"))


def rank_until_lost(rank, world, out, ckpt_root):
    """The world of 8: sweeps, a checkpoint after each, until the loss."""
    from repro_torch import core as tc
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import distributed as D
    from repro_torch.runtime import ElasticMesh, FailureSim
    lost = {}
    for tag, name, pipe in SCENARIOS:
        model, data = tdist.build(tc, name, device="cpu")
        state0 = tc.init_state(model, data, seed=0)
        mesh = ElasticMesh(model_parallel=1).build()
        assert tuple(mesh.mesh.shape) == (world, 1)
        assert mesh.mesh_dim_names == ("data", "model")
        step, ldata, st = D.make_distributed_step(model, mesh, data, state0,
                                                  pipe)
        assert step.supported and step.layout.n_shards == world
        ckpt = CheckpointManager(str(Path(ckpt_root) / tag), keep=2)
        sim = FailureSim(fail_at=[FAIL_AT], lose_devices=2)
        sweep = 0
        try:
            while sweep < TOTAL:
                sim.check(sweep)
                st, _ = step(ldata, st)
                sweep += 1
                full = step.gather_state(st)
                if rank == 0:
                    ckpt.save(sweep, full, blocking=True)
        except FailureSim.DeviceLost:
            lost[tag] = sweep
        assert sim.failures == 1
    np.savez(Path(out) / f"lost_rank{rank}.npz",
             **{k: np.asarray(v) for k, v in lost.items()})
    tdist._no_jax()


def rank_after_restart(rank, world, out, ckpt_root):
    """The world of the survivors: restore, re-shard, continue."""
    from repro_torch import core as tc
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import distributed as D
    from repro_torch.runtime import ElasticMesh
    rec = {}
    for tag, name, pipe in SCENARIOS:
        model, data = tdist.build(tc, name, device="cpu")
        state0 = tc.init_state(model, data, seed=0)
        mesh = ElasticMesh(model_parallel=1).build()
        assert tuple(mesh.mesh.shape) == (world, 1)
        restored = CheckpointManager(str(Path(ckpt_root) / tag),
                                     keep=2).restore_latest(state0)
        assert restored is not None, "no complete checkpoint"
        sweep, host_state = restored
        rec[f"{tag}_resumed_on"] = sweep
        step, ldata, st = D.make_distributed_step(model, mesh, data,
                                                  host_state, pipe)
        assert step.supported and step.layout.n_shards == world
        while sweep < TOTAL:
            st, m = step(ldata, st)
            sweep += 1
        full = step.gather_state(st)
        rec[f"{tag}_step"] = full.step
        tdist._record_state(rec, f"{tag}_", full)
        for k, v in m.items():
            rec[f"{tag}_m_{k}"] = v.numpy()
    np.savez(Path(out) / f"after_rank{rank}.npz",
             **{k: np.asarray(v) for k, v in rec.items()})
    tdist._no_jax()


@pytest.fixture(scope="module")
def restarted(tmp_path_factory):
    base = tmp_path_factory.mktemp("elastic")
    out, ckpt = base / "out", base / "ckpt"
    out.mkdir()
    here = str(Path(__file__).resolve().parent)
    run_world("test_torch_elastic:rank_until_lost", 8,
              workdir=base / "world8", args=(str(out), str(ckpt)),
              extra_paths=[here], timeout_s=600)
    run_world("test_torch_elastic:rank_after_restart", 6,
              workdir=base / "world6", args=(str(out), str(ckpt)),
              extra_paths=[here], timeout_s=600)
    return out


@functools.lru_cache(maxsize=None)
def _chains(name):
    """The uninterrupted single-device chains of the port and of
    ``repro`` after TOTAL sweeps: (port state, port metrics, reference
    state, reference metrics)."""
    import jax
    import repro.core as jc
    from repro_torch import core as tc
    model, data = tdist.build(tc, name, device="cpu")
    st = tc.init_state(model, data, seed=0)
    for _ in range(TOTAL):
        st, m = tc.gibbs_step(model, data, st)
    jmodel, jdata = tdist.build(jc, name)
    with jax.threefry_partitionable(False):
        jst = jc.init_state(jmodel, jdata, seed=0)
        for _ in range(TOTAL):
            jst, jm = jc.gibbs_step(jmodel, jdata, jst)
        jst = jax.tree.map(np.asarray, jst)
        jm = {k: np.asarray(v) for k, v in jm.items()}
    return st, {k: v.numpy() for k, v in m.items()}, jst, jm


def _hold(got, metrics, state, want_metrics, tag, slack=None):
    for e, want in enumerate(state.factors):
        want = np.asarray(want)
        extra = 0.0 if slack is None else slack[e]
        bound = extra + tdist.TOL["atol"] + tdist.TOL["rtol"] * np.abs(want)
        bad = np.abs(got[f"{tag}_f{e}"] - want) > bound
        assert not bad.any(), (tag, e, int(bad.sum()))
        hyper = state.hypers[e]
        for hk in ("rho", "tau"):
            if hk in hyper:
                np.testing.assert_allclose(got[f"{tag}_h{e}_{hk}"],
                                           np.asarray(hyper[hk]),
                                           **tdist.SNS_TOL)
    for k, want in want_metrics.items():
        np.testing.assert_allclose(metrics[k], want, rtol=tdist.RMSE_RTOL,
                                   err_msg=(tag, k))


@pytest.mark.parametrize("tag,name,pipe", SCENARIOS,
                         ids=[s[0] for s in SCENARIOS])
def test_restart_resumes_from_the_last_checkpoint(restarted, tag, name,
                                                  pipe):
    for r in range(8):
        assert int(np.load(restarted / f"lost_rank{r}.npz")[tag]) == FAIL_AT
    for r in range(6):
        got = np.load(restarted / f"after_rank{r}.npz")
        assert int(got[f"{tag}_resumed_on"]) == FAIL_AT
        assert int(got[f"{tag}_step"]) == TOTAL


@pytest.mark.parametrize("tag,name,pipe", SCENARIOS,
                         ids=[s[0] for s in SCENARIOS])
def test_restarted_chain_is_the_uninterrupted_port_chain(restarted, tag,
                                                         name, pipe):
    got = np.load(restarted / "after_rank0.npz")
    st, m, _, _ = _chains(name)
    metrics = {k: got[f"{tag}_m_{k}"] for k in m}
    _hold(got, metrics, st, m, tag)


@pytest.mark.parametrize("tag,name,pipe", SCENARIOS,
                         ids=[s[0] for s in SCENARIOS])
def test_restarted_chain_is_the_uninterrupted_reference_chain(
        restarted, tag, name, pipe):
    got = np.load(restarted / "after_rank0.npz")
    st, _, jst, jm = _chains(name)
    slack = None
    if name == "probit":
        slack = [np.abs(p.numpy() - np.asarray(j))
                 for p, j in zip(st.factors, jst.factors)]
    metrics = {k: got[f"{tag}_m_{k}"] for k in jm}
    _hold(got, metrics, jst, jm, tag, slack)


def test_survivors_hold_the_same_state(restarted):
    """Every survivor gathered the same whole state, bit for bit."""
    ranks = [np.load(restarted / f"after_rank{r}.npz") for r in range(6)]
    for k in ranks[0].files:
        for r in range(1, 6):
            np.testing.assert_array_equal(ranks[r][k], ranks[0][k],
                                          err_msg=(k, r))
