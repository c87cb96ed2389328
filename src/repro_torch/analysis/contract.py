"""Communication contracts of the distributed Gibbs sweep.

The arithmetic half of ``repro/analysis/contract.py``.  A
:class:`CommContract` states what one sweep may move between ranks:

* ``all_gathers``         -- whole-factor gathers: one an entity under
                             ``"eager"``, none under ``"ring"``;
* ``collective_permutes`` -- ring hops: E * (S - 1) under ``"ring"``;
* ``all_reduces``         -- hyper-moment and metric sums: per entity 2
                             (Normal), 4 (Macau), 2 (spike-and-slab), 0
                             (FixedNormal), plus sse and nnz a block;
* ``max_reduce_elems``    -- the largest all-reduce payload in elements
                             (K^2 Normal, max(K^2, D K) Macau, K
                             spike-and-slab): Macau's (D, D) side^T side
                             is never reduced;
* ``wire_dtype``          -- the exchange's dtype: ``"bf16"`` when
                             ``ModelDef.bf16_gather`` (the factor is cast
                             before it travels), else ``"f32"``;
* ``chains``              -- chains a row-shard group sweeps a call:
                             every count above is their total.

:func:`contract_for` derives it from any ``ModelDef``;
:func:`check_census` holds what ``core.distributed.census()`` counted in
a sweep against it.  The reference's checks of lowered and compiled XLA
programs have no counterpart: the port's collectives are calls, counted
where they are made.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..core.distributed import resolve_pipeline
from ..core.priors import (FixedNormalPrior, MacauPrior, NormalPrior,
                           SpikeAndSlabPrior)


class ContractViolation(AssertionError):
    """Raised by :func:`assert_census` with one line per violation."""


@dataclasses.dataclass(frozen=True)
class CommContract:
    pipeline: str
    n_shards: int
    all_gathers: int            # full-factor gathers per sweep
    collective_permutes: int    # ring hops per sweep
    all_reduces: int            # hyper-moment + metric sums
    max_reduce_elems: int       # largest all-reduce payload (elems)
    wire_dtype: str             # "f32" on gather/permute
    chains: int = 1             # local chains per shard group; the
    #                             counts above are totals across them

    def asdict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


def _prior_reduce_profile(prior) -> Tuple[int, int]:
    """(all-reduce count, max payload elems) for one entity's hyper
    moments, as ``distributed._psum_hyper`` reduces them."""
    K = getattr(prior, "num_latent", 0)
    if isinstance(prior, MacauPrior):
        D = prior.num_features
        # sum_U (K), moment (K,K), side moment (D,K), side norm (D)
        return 4, max(K * K, D * K, D, K)
    if isinstance(prior, SpikeAndSlabPrior):
        return 2, K                    # slab mass (K) + counts (K)
    if isinstance(prior, FixedNormalPrior):
        return 0, 0                    # no hypers to resample
    if isinstance(prior, NormalPrior):
        return 2, K * K                # sum_U (K) + moment (K,K)
    raise ValueError(
        f"no communication profile for prior {type(prior).__name__}; "
        "supported priors: "
        + ", ".join(sorted(c.__name__ for c in (
            NormalPrior, MacauPrior, SpikeAndSlabPrior,
            FixedNormalPrior))))


def contract_for(model, mesh_shape: Sequence[int],
                 pipeline: Optional[str] = "eager",
                 chains: int = 1,
                 chain_axis_size: Optional[int] = None) -> CommContract:
    """The expected communication of one sweep of ``model`` sharded over
    ``mesh_shape`` under ``pipeline``: pure arithmetic over the
    ModelDef (E entities, M blocks, S = prod(mesh_shape) ranks).

    ``chains=C``: every row-shard group sweeps its local chains one
    after the other, so the counts scale by the local chains while the
    payloads stay.  ``chain_axis_size`` says that ``mesh_shape``
    includes a chain axis of that size: rows then shard over
    prod(mesh_shape) / chain_axis_size ranks, and each group sweeps
    C / chain_axis_size chains.
    """
    pipeline = resolve_pipeline(pipeline)
    n_shards = math.prod(mesh_shape)
    chains = int(chains)
    if chains < 1:
        raise ValueError(f"chains must be >= 1, got {chains}")
    if chain_axis_size is not None:
        if n_shards % chain_axis_size:
            raise ValueError(
                f"chain_axis_size={chain_axis_size} does not divide "
                f"the {n_shards}-device mesh {tuple(mesh_shape)}")
        if chains % chain_axis_size:
            raise ValueError(
                f"chains={chains} does not divide over a chain axis "
                f"of size {chain_axis_size}")
        n_shards //= chain_axis_size
        local = chains // chain_axis_size
    else:
        local = chains
    E, M = len(model.entities), len(model.blocks)
    ar, elems = 0, 0
    for ent in model.entities:
        n, e = _prior_reduce_profile(ent.prior)
        ar += n
        elems = max(elems, e)
    ar += 2 * M                        # SSE + nnz scalars per block
    elems = max(elems, 1) if ar else elems
    if pipeline == "ring":
        ag, cp = 0, E * (n_shards - 1)
    else:
        ag, cp = E, 0
    return CommContract(
        pipeline=pipeline, n_shards=n_shards, all_gathers=ag * local,
        collective_permutes=cp * local, all_reduces=ar * local,
        max_reduce_elems=elems,
        wire_dtype="bf16" if model.bf16_gather else "f32", chains=local)


def contract_wire_bytes(model, contract: CommContract) -> int:
    """Estimated bytes a rank receives a sweep under ``contract``: each
    entity's whole factor less the rank's own rows, n_rows * K * 4 *
    (S - 1) / S, once a local chain (the all-gather and the ring move
    the same total), plus the all-reduces at ``max_reduce_elems`` fp32
    elements each at ring cost (S - 1) / S.  0 for one rank."""
    S = contract.n_shards
    if S <= 1:
        return 0
    frac = (S - 1) / S
    item = 2 if contract.wire_dtype == "bf16" else 4
    fixed_elems = sum(e.n_rows * model.num_latent
                      for e in model.entities)
    exchange = fixed_elems * item * frac * contract.chains
    reduces = contract.all_reduces * contract.max_reduce_elems * 4 * frac
    return int(exchange + reduces)


def check_census(contract: CommContract, counted: Dict[str, Any],
                 sweeps: int = 1) -> List[str]:
    """Violations of ``contract`` by a census of ``sweeps`` sweeps
    (``core.distributed.census()``): every count equal to the contract's
    times ``sweeps``, the largest all-reduce payload equal to its bound,
    and the exchange in ``wire_dtype``.  Empty when it holds."""
    out = []
    for kind in ("all_gathers", "collective_permutes", "all_reduces"):
        want = getattr(contract, kind) * sweeps
        if counted[kind] != want:
            out.append(f"{kind}: counted {counted[kind]}, contract "
                       f"{want} ({sweeps} sweep(s))")
    if contract.all_reduces and \
            counted["max_reduce_elems"] != contract.max_reduce_elems:
        out.append(f"max_reduce_elems: counted "
                   f"{counted['max_reduce_elems']}, contract "
                   f"{contract.max_reduce_elems}")
    moved = contract.all_gathers + contract.collective_permutes
    if moved and counted["wire_dtypes"] != [contract.wire_dtype]:
        out.append(f"wire dtypes: counted {counted['wire_dtypes']}, "
                   f"contract [{contract.wire_dtype!r}]")
    return out


def assert_census(contract: CommContract, counted: Dict[str, Any],
                  sweeps: int = 1, where: str = "") -> None:
    """Raise :class:`ContractViolation` listing every violation."""
    bad = check_census(contract, counted, sweeps)
    if bad:
        head = f"communication contract violated{' at ' + where if where else ''}"
        raise ContractViolation("\n".join([head] + bad))
