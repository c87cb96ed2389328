"""Data-parallel layout of a training step over a world of ranks.

The counterpart of the part of ``repro/launch/specs.py`` that means
something on a world of processes: the ``dponly`` variant, where the
batch is split over every rank and the AdamW moments are ZeRO-1-sharded
(each rank holds a slice) while the parameters stay replicated.

* :func:`effective_variant` drops ``dponly`` when the global batch does
  not divide the world, as the reference's does for its mesh;
* :func:`batch_shard` is this rank's share of a global batch, the
  reference's ``batch_shardings`` under ``dponly`` (every leaf split
  along its first axis over the whole world) with its microbatch
  reshape (``repro/launch/train.py:47-50``): global microbatch ``i`` is
  the rows ``[i B/k, (i+1) B/k)``, and a rank holds its 1/N share of
  each, in order;
* :func:`train_state_plan` is ``train_state_shardings``' ``dponly``
  branch: parameters and the step counter replicated, each moment leaf
  sharded on its first dimension ``d`` with ``shape[d] % N == 0`` and
  ``shape[d] >= N``, else replicated.  The port's leaves are per layer
  where the reference's are scanned stacks; the rule is the reference's.

The abstract input specs and the serve-cache shardings describe an XLA
program on a TPU mesh and stay in ROADMAP A11.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from ..configs.shapes import ShapeSpec

_FP32_BYTES = 4


def effective_variant(variant: str, shape: ShapeSpec,
                      world_size: int) -> str:
    """``variant`` without the flags whose preconditions the cell breaks:
    ``dponly`` needs the global batch to divide the whole world.  An
    empty result is ``"baseline"``."""
    flags = [f for f in variant.split(",") if f]
    if "dponly" in flags and shape.global_batch % world_size:
        flags.remove("dponly")
    return ",".join(flags) or "baseline"


def batch_shard(batch: Mapping[str, Any], rank: int, world_size: int,
                n_micro: int = 1) -> Dict[str, Any]:
    """This rank's rows of a global batch: of each leaf (a tensor split
    along its first axis), the ``rank``-th of ``world_size`` equal parts
    of each of the ``n_micro`` global microbatches, concatenated in
    microbatch order.  The first axis must divide by ``n_micro *
    world_size``."""
    out = {}
    for key, x in batch.items():
        B = x.shape[0]
        if B % (n_micro * world_size):
            raise ValueError(
                f"batch leaf {key!r} has {B} rows, not a multiple of "
                f"n_micro={n_micro} x world_size={world_size}")
        mb = B // n_micro
        r = mb // world_size
        parts = [x[i * mb + rank * r:i * mb + (rank + 1) * r]
                 for i in range(n_micro)]
        out[key] = parts[0] if n_micro == 1 else torch.cat(parts)
    return out


def moment_shard_dim(shape: Tuple[int, ...], world_size: int
                     ) -> Optional[int]:
    """The reference's ZeRO-1 rule for one moment leaf: its first
    dimension that ``world_size`` divides and does not exceed, or None
    (replicated)."""
    for d, n in enumerate(shape):
        if n % world_size == 0 and n >= world_size:
            return d
    return None


@dataclasses.dataclass(frozen=True)
class TrainStatePlan:
    """Where a ``dponly`` training state lives on a world of
    ``world_size`` ranks: the parameters (``shapes``, by name) on every
    rank, each moment leaf split on ``moment_dims[name]`` (None:
    replicated) into equal slices, rank ``r`` holding the ``r``-th."""

    world_size: int
    shapes: Dict[str, Tuple[int, ...]]
    moment_dims: Dict[str, Optional[int]]

    def shard_shape(self, name: str) -> Tuple[int, ...]:
        shape, d = self.shapes[name], self.moment_dims[name]
        if d is None:
            return shape
        return shape[:d] + (shape[d] // self.world_size,) + shape[d + 1:]

    def shard(self, name: str, x: torch.Tensor, rank: int) -> torch.Tensor:
        """Rank ``rank``'s slice of ``x``, a full leaf shaped like
        parameter ``name`` (a view; the whole leaf when replicated)."""
        d = self.moment_dims[name]
        if d is None:
            return x
        size = self.shapes[name][d] // self.world_size
        return x.narrow(d, rank * size, size)

    def moment_bytes(self) -> int:
        """fp32 bytes of the two moments one rank holds (every rank the
        same)."""
        return 2 * _FP32_BYTES * sum(math.prod(self.shard_shape(n))
                                     for n in self.shapes)

    def full_moment_bytes(self) -> int:
        """fp32 bytes of the two unsharded moments."""
        return 2 * _FP32_BYTES * sum(math.prod(s)
                                     for s in self.shapes.values())


def train_state_plan(named_params: Mapping[str, torch.Tensor],
                     world_size: int, variant: str = "dponly"
                     ) -> TrainStatePlan:
    """The ``dponly`` plan of ``named_params`` (tensors by parameter
    name, on any device, ``meta`` included) over ``world_size`` ranks.
    Another variant has no plan here (ROADMAP A11)."""
    flags = variant.split(",")
    if "dponly" not in flags:
        raise ValueError(
            f"variant {variant!r} (flags {', '.join(flags)}): only "
            "'dponly' (replicated parameters, ZeRO-1 moments) has a plan "
            "in the port; the baseline's ZeRO-3/TP shardings are ROADMAP "
            "A11")
    shapes = {k: tuple(p.shape) for k, p in named_params.items()}
    return TrainStatePlan(world_size, shapes,
                          {k: moment_shard_dim(s, world_size)
                           for k, s in shapes.items()})
