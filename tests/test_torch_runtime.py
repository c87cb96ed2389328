"""The port's ``runtime`` package against ``repro.runtime``: the mesh
arithmetic, the failure injector, the restartable loop and the
straggler monitor, plus what only the port has, its worlds of ranks
(``runtime.world``): a gloo world starts, reports a rank's failure
with its traceback, and stops at its timeout.

Worlds here are small (2 ranks, one thread each, a ``file://``
rendezvous under ``tmp_path``); their ranks import ``repro_torch``
alone.
"""
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.runtime import (ElasticMesh, FailureSim, StragglerMonitor,
                                 best_mesh_shape, run_with_restarts,
                                 run_world)
from torch_threads import _one_thread  # noqa: F401 (autouse)

HERE = str(Path(__file__).resolve().parent)


def test_best_mesh_shape_shrinks():
    assert best_mesh_shape(256, 16) == (16, 16)
    assert best_mesh_shape(240, 16) == (15, 16)
    assert best_mesh_shape(250, 16) == (125, 2)   # 16,8,4 don't divide
    assert best_mesh_shape(512, 16, multi_pod=True) == (2, 16, 16)
    assert best_mesh_shape(7, 4) == (7, 1)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_best_mesh_shape_is_the_references(multi_pod):
    from repro.runtime.fault import best_mesh_shape as ref
    for n in range(1, 70):
        for mp in (1, 2, 3, 4, 8, 16):
            assert best_mesh_shape(n, mp, multi_pod) == ref(n, mp,
                                                            multi_pod)


def test_failure_sim_raises_once_per_step():
    sim = FailureSim(fail_at=[3])
    sim.check(2)
    with pytest.raises(FailureSim.DeviceLost):
        sim.check(3)
    sim.check(3)   # cleared after firing
    assert sim.failures == 1


def test_run_with_restarts_bit_identical(tmp_path):
    """A crashed and restarted run ends in the uninterrupted run's state:
    every draw comes from (seed, step), never from the clock."""
    from repro_torch import random

    def init_fn():
        return {"x": torch.zeros(3), "step_sum": torch.tensor(0.0)}

    def step_fn(state, step):
        noise = random.normal(random.fold_in(random.PRNGKey(0), step), (3,))
        return {"x": state["x"] + noise,
                "step_sum": state["step_sum"] + step}

    clean, stats0 = run_with_restarts(
        20, init_fn, step_fn, CheckpointManager(str(tmp_path / "a"),
                                                keep=2), save_every=5)
    assert stats0["restarts"] == 0
    sim = FailureSim(fail_at=[7, 13])
    crashed, stats = run_with_restarts(
        20, init_fn, step_fn, CheckpointManager(str(tmp_path / "b"),
                                                keep=2),
        save_every=5, failure_sim=sim)
    assert stats["restarts"] == 2 and stats["resumed_from"] == [5, 10]
    assert torch.equal(clean["x"], crashed["x"])
    assert float(clean["step_sum"]) == float(crashed["step_sum"])


def test_straggler_monitor():
    mon = StragglerMonitor(window=20, threshold=2.0, patience=3)
    for _ in range(10):
        assert not mon.record(1.0)
    assert not mon.record(5.0)
    assert not mon.record(5.0)
    assert mon.record(5.0)          # third consecutive slow step
    assert not mon.record(1.0)      # recovery resets the streak


def test_straggler_monitor_is_the_references():
    from repro.runtime import StragglerMonitor as Ref
    times = np.random.default_rng(0).exponential(1.0, 300)
    mine, ref = StragglerMonitor(30, 1.8, 2), Ref(30, 1.8, 2)
    assert [mine.record(t) for t in times] == [ref.record(t) for t in times]
    assert mine.median() == ref.median()


def test_elastic_mesh_builds_over_the_process_group(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        mesh = ElasticMesh(model_parallel=1).build()
        assert tuple(mesh.mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("data", "model")
        assert mesh.device_type == "cpu"
        with pytest.raises(ValueError, match="process group holds 1"):
            ElasticMesh().build(world_size=2)
    finally:
        dist.destroy_process_group()


def rank_collectives(rank, world, out):
    """A world of 2: the backend the device type chose, an all-reduce,
    an all-gather and a ring hop; a mesh of the world from ElasticMesh."""
    import torch.distributed as dist
    from repro_torch.core import distributed as D
    assert dist.get_backend() == "gloo" and dist.get_world_size() == world
    mesh = ElasticMesh(model_parallel=2).build()
    assert tuple(mesh.mesh.shape) == (1, 2)
    lay = D.make_layout(mesh)
    assert lay.n_shards == 2 and lay.shard == rank
    total = D._all_reduce(torch.tensor([float(rank + 1)]), lay.group)
    full = D._all_gather(torch.full((2, 3), float(rank)), lay.group)
    ring = D._ring_accumulate(lay, torch.full((2, 3), float(rank)),
                              torch.empty(4, 3), D._place_chunk)
    np.savez(Path(out) / f"rank{rank}.npz", total=total.numpy(),
             full=full.numpy(), ring=ring.numpy(),
             counts=[D.census()[k] for k in ("all_reduces", "all_gathers",
                                             "collective_permutes")])


def rank_fails(rank, world, out):
    if rank == 1:
        raise RuntimeError("rank one gives up")


def rank_hangs(rank, world, out):
    threading.Event().wait()


def test_world_runs_ranks_and_their_collectives(tmp_path):
    outs = run_world("test_torch_runtime:rank_collectives", 2,
                     workdir=tmp_path / "world", args=(str(tmp_path),),
                     extra_paths=[HERE], timeout_s=300)
    assert len(outs) == 2
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        assert got["total"].tolist() == [3.0]
        assert got["full"][:, 0].tolist() == [0.0, 0.0, 1.0, 1.0]
        np.testing.assert_array_equal(got["ring"], got["full"])
        assert got["counts"].tolist() == [1, 1, 1]


def test_world_reports_a_failed_rank_with_its_traceback(tmp_path):
    with pytest.raises(RuntimeError) as ei:
        run_world("test_torch_runtime:rank_fails", 2,
                  workdir=tmp_path / "world", args=(str(tmp_path),),
                  extra_paths=[HERE], timeout_s=300)
    msg = str(ei.value)
    assert "rank(s) [1] failed" in msg and "rank one gives up" in msg
    assert "Traceback" in msg


def test_world_stops_at_its_timeout(tmp_path):
    with pytest.raises(RuntimeError, match="still running after 5 s"):
        run_world("test_torch_runtime:rank_hangs", 2,
                  workdir=tmp_path / "world", args=(str(tmp_path),),
                  extra_paths=[HERE], timeout_s=5)
