"""Fault tolerance and elastic restart for the distributed sweep.

The counterpart of ``repro/runtime/fault.py``.  The failure model: a
rank (a card) is lost.  A ``torch.distributed`` world cannot shrink in
place, so elastic restart is **save, start a new world of fewer ranks,
restore, re-shard, continue**:

* the loop checkpoints the whole state (gathered from the shards)
  through ``checkpoint.CheckpointManager``; ``FailureSim`` stands in for
  the lost card at chosen steps;
* the surviving ranks start a new world (``runtime.world``), build a
  mesh over it with ``ElasticMesh`` (the largest (data, model)
  factorisation of the survivor count), restore the last complete
  checkpoint and place it on the new mesh
  (``core.distributed.make_distributed_step``);
* every per-row draw of the sweep is counter-based on the global row
  index, so the restarted chain is the uninterrupted one up to the
  order of the moment sums (``tests/test_torch_elastic.py``).

``run_with_restarts`` is the reference's generic in-process loop (a
step function that fails and restarts from its last checkpoint in the
same process).  The straggler story is ``runtime/straggler.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..checkpoint import CheckpointManager


def best_mesh_shape(n_devices: int, model_parallel: int,
                    multi_pod: bool = False) -> Tuple[int, ...]:
    """Largest usable (pod, data, model) shape for a device count.

    Keeps the model axis at ``model_parallel`` if divisible; otherwise
    falls back to the largest power-of-2 model axis that divides.
    """
    mp = model_parallel
    while mp > 1 and n_devices % mp:
        mp //= 2
    dp = n_devices // mp
    if multi_pod and dp % 2 == 0:
        return (2, dp // 2, mp)
    return (dp, mp)


@dataclasses.dataclass
class ElasticMesh:
    """Builds a ``DeviceMesh`` over the current process group."""

    model_parallel: int = 1
    multi_pod: bool = False

    def build(self, world_size: Optional[int] = None):
        """A mesh of ``best_mesh_shape(world_size)`` over ranks 0.. of
        the current world (default: all of them), dims ("data",
        "model") or ("pod", "data", "model").  The device type follows
        the backend: ``cuda`` for NCCL, else ``cpu``.  Collective: every
        rank of the world calls it."""
        from torch.distributed.device_mesh import DeviceMesh
        world = dist.get_world_size()
        n = world if world_size is None else int(world_size)
        if not 0 < n <= world:
            raise ValueError(f"world_size={n}, but the process group "
                             f"holds {world} ranks")
        shape = best_mesh_shape(n, self.model_parallel, self.multi_pod)
        names = (("pod", "data", "model") if len(shape) == 3
                 else ("data", "model"))
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        ranks = torch.arange(math.prod(shape)).reshape(shape)
        return DeviceMesh(device_type, ranks, mesh_dim_names=names)


class FailureSim:
    """Deterministic failure injector for offline testing.

    ``check(step)`` raises ``DeviceLost`` at the configured steps,
    standing in for the error a lost card produces.
    """

    class DeviceLost(RuntimeError):
        pass

    def __init__(self, fail_at: Sequence[int] = (), lose_devices: int = 0):
        self.fail_at = set(fail_at)
        self.lose = lose_devices
        self.failures = 0

    def check(self, step: int) -> None:
        if step in self.fail_at:
            self.fail_at.discard(step)
            self.failures += 1
            raise FailureSim.DeviceLost(
                f"simulated device loss at step {step}")


def run_with_restarts(
        total_steps: int,
        init_fn: Callable[[], Any],
        step_fn: Callable[[Any, int], Any],
        ckpt: CheckpointManager,
        save_every: int = 10,
        failure_sim: Optional[FailureSim] = None,
        max_restarts: int = 10) -> Tuple[Any, dict]:
    """Generic restartable loop.

    ``state`` is a tree of tensors (dicts, tuples, NamedTuples);
    ``step_fn(state, step) -> state``.  On failure: restore the latest
    checkpoint and continue.  Returns (final_state, stats).
    """
    restarts = 0
    stats = {"restarts": 0, "resumed_from": []}

    state = init_fn()
    restored = ckpt.restore_latest(state)
    step = 0
    if restored is not None:
        step, state = restored
        stats["resumed_from"].append(step)

    while step < total_steps:
        try:
            if failure_sim is not None:
                failure_sim.check(step)
            state = step_fn(state, step)
            step += 1
            if step % save_every == 0 or step == total_steps:
                ckpt.save(step, state)
        except FailureSim.DeviceLost:
            restarts += 1
            stats["restarts"] = restarts
            if restarts > max_restarts:
                raise
            ckpt.wait()
            restored = ckpt.restore_latest(init_fn())
            if restored is None:
                step, state = 0, init_fn()
            else:
                step, state = restored
            stats["resumed_from"].append(step)
    ckpt.wait()
    return state, stats
