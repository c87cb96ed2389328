"""The distributed Gibbs sweep over ``torch.distributed``.

The counterpart of ``repro/core/distributed.py``.  One process a rank:
NCCL with each rank on ``cuda:{LOCAL_RANK}``, or gloo on the CPU; the
backend follows the mesh's device type (``runtime.world.init_world``
starts a rank that way).  ``mesh`` is a
``torch.distributed.device_mesh.DeviceMesh`` whose dim names are those of
``FACTOR_AXES``, plus an optional chain axis:

* rows of every factor, and the matching rows of both padded-CSR
  orientations, of both dense orientations and of the side information,
  are sharded over every factor axis flattened, major to minor in
  ``FACTOR_AXES`` order (the reference's ``_shard_index``); each rank
  holds its shard in tensors of its own (``clone``, never a view at an
  offset, so the kernels see aligned, contiguous operands);
* the *fixed* factor of each half-sweep is needed whole on every rank,
  in bf16 when ``ModelDef.bf16_gather`` (cast before it travels, so the
  wire carries half the bytes, as the reference's does).  How it
  travels is ``pipeline`` (default ``REPRO_PIPELINE``, else
  ``"eager"``):

  - ``"eager"``: one ``all_gather_into_tensor`` per half-sweep; the last
    half-sweep's view is reused for the sweep-end residuals, so a sweep
    over E entities moves exactly E gathers;
  - ``"ring"``: the same rows travel as S - 1 ``batch_isend_irecv`` hops
    around the row-shard ring (``_ring_accumulate``): rank s receives
    from s + 1 and sends to s - 1, and the hop for chunk t + 1 is issued
    before chunk t is consumed.  Dense non-probit blocks of the earlier
    half-sweep fold their Gram/rhs moments in chunk by chunk
    (``gibbs._dense_chunk_contrib``) and never hold the dense view;
    every other consumer reassembles the view by copies, bitwise the
    all-gathered one;
* the hyper-samples need global moments: one ``all_reduce`` a payload
  (fp32; Normal 2, Macau 4, spike-and-slab 2, FixedNormal 0), plus the
  sse and nnz of each block, then the same replicated computation on
  every rank (bitwise equal across ranks).  Macau's side^T side is data
  (``MFData.side_grams``), computed once with the data, never reduced;
* every per-row draw is counter-based on the global row index
  (``gibbs.row_normals``/``row_uniforms``/``row_bernoulli`` through
  ``row_offset``), so a shard draws exactly the single-device sweep's
  numbers for its rows and the chain differs from it only by the order
  of the moment sums, which is what makes a restart onto fewer ranks
  safe.

Every collective of the sweep goes through ``_all_gather``,
``_all_reduce`` and ``_ring_hop``, which count calls, payload elements
and dtypes (``census``, ``reset_census``), as ``kernels/ops.py`` counts
launches; ``analysis.contract.contract_for`` says what a sweep must
count.  A model outside the sharded subset runs the single-device
``gibbs_step`` whole on every rank (the session warns, naming the
reason), where the reference falls back to pjit.
"""
from __future__ import annotations

import dataclasses
import math
import os
import warnings
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from .. import random
from ..kernels import ops
from .blocks import DenseBlock, ModelDef
from .gibbs import (MFData, MFState, _dense_chunk_contrib, _factor_update,
                    _side_gram, gibbs_step, multi_chain_step, stack_states,
                    unstack_state)
from .noise import AdaptiveGaussian, FixedGaussian, ProbitNoise
from .priors import (FixedNormalPrior, MacauPrior, NormalPrior,
                     SpikeAndSlabPrior)
from .sparse import PaddedRows, SparseMatrix

FACTOR_AXES = ("pod", "data", "model")

PIPELINES = ("eager", "ring")


def resolve_pipeline(pipeline: Optional[str] = None) -> str:
    """Validate the exchange-pipeline knob, defaulting from the
    ``REPRO_PIPELINE`` environment variable, else ``"eager"``."""
    if pipeline is None:
        pipeline = os.environ.get("REPRO_PIPELINE", "eager")
    if pipeline not in PIPELINES:
        raise ValueError(
            f"unknown pipeline {pipeline!r}; valid pipelines: "
            f"{', '.join(PIPELINES)} (the REPRO_PIPELINE environment "
            "variable sets the default)")
    return pipeline


def _dim_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def _axes_in(mesh) -> Tuple[str, ...]:
    names = _dim_names(mesh)
    return tuple(a for a in FACTOR_AXES if a in names)


def _dim_size(mesh, name: str) -> int:
    return int(mesh.mesh.shape[_dim_names(mesh).index(name)])


def _n_shards(mesh) -> int:
    return math.prod(_dim_size(mesh, a) for a in _axes_in(mesh))


def distributed_unsupported_reason(model: ModelDef, mesh,
                                   data: Optional[MFData] = None
                                   ) -> Optional[str]:
    """Why this model falls off the sharded sweep; None when it fits."""
    S = _n_shards(mesh)
    for e, ent in enumerate(model.entities):
        if ent.n_rows % S != 0:
            return (f"entity {ent.name!r} has {ent.n_rows} rows, not "
                    f"divisible by the {S}-shard mesh")
        if not isinstance(ent.prior,
                          (NormalPrior, MacauPrior, FixedNormalPrior,
                           SpikeAndSlabPrior)):
            return (f"entity {ent.name!r} prior "
                    f"{type(ent.prior).__name__} has no sharded moment "
                    "algebra")
        if isinstance(ent.prior, MacauPrior) and (
                data is None or data.sides[e] is None):
            return (f"entity {ent.name!r} has a Macau prior but no "
                    "side-information matrix in the data")
    for bi, blk in enumerate(model.blocks):
        if blk.row_entity == blk.col_entity:
            return (f"block {bi} relates entity {blk.row_entity} to "
                    "itself (self-blocks are not sharded)")
        if not isinstance(blk.noise,
                          (FixedGaussian, AdaptiveGaussian, ProbitNoise)):
            return (f"block {bi} noise {type(blk.noise).__name__} has "
                    "no sharded residual reduction")
        if not blk.sparse and data is not None:
            payload = data.blocks[bi]
            # both orientations must be stored for per-shard reads
            if not isinstance(payload, DenseBlock) \
                    or getattr(payload, "XT", None) is None:
                return (f"block {bi} dense payload lacks the stored "
                        "transposed orientation (use dense_block())")
    return None


def distributed_supported(model: ModelDef, mesh,
                          data: Optional[MFData] = None) -> bool:
    """True when the sharded sweep covers this model: only the prior and
    noise types whose sharded moment algebra ``_sharded_sweep`` holds
    are admitted.  :func:`distributed_unsupported_reason` names what
    keeps a model out."""
    return distributed_unsupported_reason(model, mesh, data) is None


# ---------------------------------------------------------------------------
# the collectives, counted
# ---------------------------------------------------------------------------

def _new_census() -> Dict[str, Any]:
    return {"all_gathers": 0, "collective_permutes": 0, "all_reduces": 0,
            "max_reduce_elems": 0, "reduce_elems": 0, "wire_elems": 0,
            "wire_dtypes": set()}


# "sweep": the collectives of the sweeps; "gather": those that rebuild
# whole states and metrics for stores and comparisons
_CENSUS: Dict[str, Dict[str, Any]] = {"sweep": _new_census(),
                                      "gather": _new_census()}

_WIRE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def reset_census() -> None:
    for bucket in _CENSUS:
        _CENSUS[bucket] = _new_census()


def census(bucket: str = "sweep") -> Dict[str, Any]:
    """Collectives counted since the last ``reset_census``: calls of each
    kind (the ``CommContract`` field names), the largest all-reduce
    payload in elements, the elements sent, and the exchange's dtypes
    (``"f32"``...)."""
    c = dict(_CENSUS[bucket])
    c["wire_dtypes"] = sorted(_WIRE_NAMES.get(d, str(d))
                              for d in c["wire_dtypes"])
    return c


def _all_gather(t: torch.Tensor, group, bucket: str = "sweep"
                ) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0, in group order."""
    t = t.contiguous()
    n = dist.get_world_size(group)
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    with warnings.catch_warnings():
        # newer torch renames it; the older one on the card has only this
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, t, group=group)
    c = _CENSUS[bucket]
    c["all_gathers"] += 1
    c["wire_elems"] += t.numel()
    c["wire_dtypes"].add(t.dtype)
    return out


def _all_reduce(t: torch.Tensor, group, bucket: str = "sweep"
                ) -> torch.Tensor:
    """The sum of every rank's ``t`` (a fresh tensor, reduced in place)."""
    t = t.contiguous()
    dist.all_reduce(t, group=group)
    c = _CENSUS[bucket]
    c["all_reduces"] += 1
    c["reduce_elems"] += t.numel()
    c["max_reduce_elems"] = max(c["max_reduce_elems"], t.numel())
    return t


def _ring_hop(chunk: torch.Tensor, group, send_to: int, recv_from: int,
              bucket: str = "sweep"):
    """Send ``chunk`` to global rank ``send_to`` and receive the next one
    from ``recv_from``; returns (next chunk, requests to wait on)."""
    nxt = torch.empty_like(chunk)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, chunk, send_to, group),
        dist.P2POp(dist.irecv, nxt, recv_from, group)])
    c = _CENSUS[bucket]
    c["collective_permutes"] += 1
    c["wire_elems"] += chunk.numel()
    c["wire_dtypes"].add(chunk.dtype)
    return nxt, reqs


# ---------------------------------------------------------------------------
# this rank's place in the mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Layout:
    """This rank's row-shard group (``group``, ``n_shards`` ranks, this
    one at ``shard``) and, with a chain axis, its chain group
    (``chain_group`` of ``chain_size`` ranks, this one at
    ``chain_index``)."""

    group: Any
    n_shards: int
    shard: int
    chain_group: Any = None
    chain_size: int = 1
    chain_index: int = 0


def _group(ranks: List[int]):
    if ranks == list(range(dist.get_world_size())):
        return dist.group.WORLD
    return dist.new_group(ranks)


def _groups_along(mesh, last: List[int]):
    """Every group of the mesh's ranks that differ only in the dims
    ``last`` (flattened major to minor), created on every rank in one
    order; returns (this rank's group, its index in it, group size)."""
    names = _dim_names(mesh)
    rest = [i for i in range(len(names)) if i not in last]
    size = math.prod(int(mesh.mesh.shape[i]) for i in last)
    rows = mesh.mesh.permute(rest + last).reshape(-1, size).tolist()
    me = dist.get_rank()
    mine = None
    for ranks in rows:
        g = _group(ranks)
        if me in ranks:
            mine = (g, ranks.index(me))
    if mine is None:
        raise ValueError(f"rank {me} is not in the mesh "
                         f"{mesh.mesh.tolist()}")
    return mine[0], mine[1], size


def make_layout(mesh, chain_axis: Optional[str] = None) -> Layout:
    """Create the mesh's row-shard groups (every factor axis flattened,
    in ``FACTOR_AXES`` order) and, with ``chain_axis``, its chain
    groups, and place this rank in them.  Collective: every rank of the
    world calls it with the same mesh."""
    names = _dim_names(mesh)
    factor = [names.index(a) for a in _axes_in(mesh)]
    group, shard, S = _groups_along(mesh, factor)
    if chain_axis is None:
        return Layout(group, S, shard)
    cg, ci, A = _groups_along(mesh, [names.index(chain_axis)])
    return Layout(group, S, shard, cg, A, ci)


def _rank_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        return torch.device("cuda", int(local) if local is not None
                            else torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _check_device(model: ModelDef, mesh) -> None:
    want = _rank_device(mesh)
    if torch.device(model.device) != want:
        raise ValueError(
            f"the model runs on {model.device}, but this rank of the "
            f"{mesh.device_type} mesh runs on {want}: build the model "
            "with the rank's device")


def _validate_chain_axis(mesh, chains: int,
                         chain_axis: Optional[str]) -> None:
    if chain_axis is None:
        return
    if chain_axis in FACTOR_AXES:
        raise ValueError(
            f"chain_axis {chain_axis!r} collides with the row-sharding "
            f"axes {FACTOR_AXES}; name the chain mesh axis something "
            "else (conventionally 'chain')")
    if chain_axis not in _dim_names(mesh):
        raise ValueError(
            f"chain_axis {chain_axis!r} is not a mesh axis; this mesh "
            f"has {_dim_names(mesh)}")
    size = _dim_size(mesh, chain_axis)
    if chains % size != 0:
        raise ValueError(
            f"chains={chains} does not divide over chain_axis "
            f"{chain_axis!r} of size {size}")


# ---------------------------------------------------------------------------
# placement: this rank's shard in tensors of its own
# ---------------------------------------------------------------------------

def _rows(x: torch.Tensor, r0: int, r1: int) -> torch.Tensor:
    if all(s == 0 for s in x.stride()):
        return x[r0:r1]        # a broadcast 1.0 (fully observed): no copy
    return x[r0:r1].clone()


def _span(model: ModelDef, lay: Layout, e: int) -> Tuple[int, int]:
    R = model.entities[e].n_rows // lay.n_shards
    return lay.shard * R, (lay.shard + 1) * R


def _place_data(model: ModelDef, lay: Layout, data: MFData) -> MFData:
    """This rank's rows of both orientations of every block and of the
    side information; side^T side stays whole (replicated data).  A
    sparse block keeps its whole COO by reference: the sharded sweep
    reads only the padded orientations."""
    blocks = []
    for blk, payload in zip(model.blocks, data.blocks):
        r0, r1 = _span(model, lay, blk.row_entity)
        c0, c1 = _span(model, lay, blk.col_entity)
        if isinstance(payload, SparseMatrix):
            def cut(p: PaddedRows, a: int, b: int) -> PaddedRows:
                return PaddedRows(_rows(p.idx, a, b), _rows(p.val, a, b),
                                  _rows(p.mask, a, b), p.n_other)
            blocks.append(dataclasses.replace(
                payload, rows=cut(payload.rows, r0, r1),
                cols=cut(payload.cols, c0, c1)))
        else:
            blocks.append(DenseBlock(
                _rows(payload.X, r0, r1), _rows(payload.mask, r0, r1),
                _rows(payload.XT, c0, c1), _rows(payload.maskT, c0, c1),
                payload.fully))
    sides = tuple(None if s is None else _rows(s, *_span(model, lay, e))
                  for e, s in enumerate(data.sides))
    return MFData(tuple(blocks), sides, data.side_grams)


def _leaves(x, fn):
    if isinstance(x, dict):
        return {k: _leaves(v, fn) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_leaves(v, fn) for v in x)
    return fn(x)


def _place_state(model: ModelDef, lay: Layout, state: MFState,
                 chains: Optional[Tuple[int, int]] = None) -> MFState:
    """This rank's factor rows; key, hypers and noises replicated.  With
    ``chains`` = (c0, c1), a stacked state's chains c0..c1-1."""
    if chains is None:
        factors = tuple(_rows(f, *_span(model, lay, e))
                        for e, f in enumerate(state.factors))
        return state._replace(factors=factors)
    c0, c1 = chains
    factors = tuple(f[c0:c1, slice(*_span(model, lay, e))].clone()
                    for e, f in enumerate(state.factors))
    take = lambda x: x[c0:c1].clone()       # noqa: E731
    return MFState(take(state.key), factors, _leaves(state.hypers, take),
                   _leaves(state.noises, take), state.step)


# ---------------------------------------------------------------------------
# the sharded sweep
# ---------------------------------------------------------------------------

def _ring_accumulate(lay: Layout, f_shard: torch.Tensor, init, chunk_fn):
    """Circulate this rank's shard of a fixed factor around the ring.

    Rank s starts from its own shard and receives the other S - 1
    chunks from s + 1 while sending to s - 1 (the reference's
    permutation ``[((j + 1) % S, j)]``), so at step t it holds chunk
    (s + t) % S, rows ``c0 = ((s + t) % S) * rows_per`` on.  The hop
    moving chunk t + 1 is issued before chunk t is consumed and waited
    for after.  ``chunk_fn(acc, chunk, c0) -> acc``.
    """
    S, s, group = lay.n_shards, lay.shard, lay.group
    rows_per = f_shard.shape[0]
    if S > 1:
        send_to = dist.get_global_rank(group, (s - 1) % S)
        recv_from = dist.get_global_rank(group, (s + 1) % S)
    acc, chunk = init, f_shard
    for t in range(S):
        pending = None
        if t < S - 1:
            nxt, pending = _ring_hop(chunk, group, send_to, recv_from)
        acc = chunk_fn(acc, chunk, ((s + t) % S) * rows_per)
        if pending is not None:
            for req in pending:
                req.wait()
            chunk = nxt
    return acc


def _wire_cast(model: ModelDef, f: torch.Tensor) -> torch.Tensor:
    """A factor as it travels and is read whole: bf16 under
    ``bf16_gather``, else itself."""
    return f.to(torch.bfloat16) if model.bf16_gather else f


def _place_chunk(full: torch.Tensor, chunk: torch.Tensor, c0: int):
    full[c0:c0 + chunk.shape[0]].copy_(chunk)
    return full


def _streamable(model: ModelDef, bi: int, e: int) -> bool:
    """True when block ``bi``'s contribution to entity ``e``'s update
    can consume the ring chunk by chunk: a dense payload, a pred-free
    augmentation (not probit), and ``e`` the earlier-updated side (the
    later side's view is the one the sweep-end residuals reuse)."""
    blk = model.blocks[bi]
    return (not blk.sparse
            and not isinstance(blk.noise, ProbitNoise)
            and max(blk.row_entity, blk.col_entity) != e)


def _psum_hyper(model: ModelDef, e: int, key, u, hyper, side, group,
                ftf=None):
    """Hyper-sample from all-reduced moments, the same on every rank.
    Payloads: K and K^2 (Normal); Macau's centred K and K^2, D x K and
    D; spike-and-slab's two K; none for FixedNormal.  ``ftf`` is Macau's
    side^T side, data computed once."""
    prior = model.entities[e].prior
    N = model.entities[e].n_rows

    def psum(t):
        return _all_reduce(t, group)

    if isinstance(prior, MacauPrior):
        Uc = u - side @ hyper["beta"]
        return prior.sample_hyper_moments(
            key, hyper, F_sum=psum(Uc.sum(dim=0)), F_cov=psum(Uc.T @ Uc),
            n_rows=N, StF=psum(side.T @ u), s_side=psum(side.sum(dim=0)),
            FtF=ftf)
    if isinstance(prior, NormalPrior):
        return prior.sample_hyper_moments(
            key, hyper, F_sum=psum(u.sum(dim=0)), F_cov=psum(u.T @ u),
            n_rows=N)
    if isinstance(prior, SpikeAndSlabPrior):
        s = (u.abs() > 0).to(torch.float32)
        return prior.sample_hyper_moments(
            key, hyper, n_incl=psum(s.sum(dim=0)),
            sumsq=psum((u * u).sum(dim=0)), n_rows=N)
    # moment-free priors (FixedNormalPrior): the same on every rank
    return prior.sample_hyper(key, u, hyper)


def _stream_dense(model: ModelDef, lay: Layout, data: MFData, e: int,
                  factors, noises, k_blk, gathered, row_offset: int):
    """The ring's streamed blocks of entity ``e``'s half-sweep: the
    touching blocks grouped by their fixed entity; a group streams when
    every block in it is ``_streamable`` and its view is not held
    already.  Returns (streamed block indices, (gram_shared, gram_rows,
    rhs) with alpha applied after each circulation), or ((), None)."""
    bkeys = random.split(k_blk, max(1, len(model.blocks)))
    by_fixed: Dict[int, list] = {}
    for bi, as_row in model.blocks_touching(e):
        by_fixed.setdefault(model.blocks[bi].other(e), []).append(
            (bi, as_row))
    streamed = set()
    gram_shared = gram_rows = rhs = None
    R, K = factors[e].shape
    dev = factors[e].device
    for o, members in by_fixed.items():
        if o in gathered or not all(_streamable(model, bi, e)
                                    for bi, _ in members):
            continue
        streamed.update(bi for bi, _ in members)
        prep = []
        for bi, as_row in members:
            X, msk = data.blocks[bi].oriented(as_row)
            vals, alpha = model.blocks[bi].noise.augment(
                bkeys[bi], noises[bi], None, X, msk, row_offset=row_offset)
            prep.append((data.blocks[bi].fully, vals, msk, alpha))
        init = [(torch.zeros((K, K), device=dev) if fully else None,
                 None if fully else torch.zeros((R, K, K), device=dev),
                 torch.zeros((R, K), device=dev))
                for fully, _, _, _ in prep]

        def chunk_fn(acc, chunk, c0, prep=prep):
            for (fully, vals, msk, _), (gs, gr, rh) in zip(prep, acc):
                dgs, dgr, drh = _dense_chunk_contrib(vals, msk, fully,
                                                     chunk, c0)
                if gs is not None:
                    gs.add_(dgs)
                if gr is not None:
                    gr.add_(dgr)
                rh.add_(drh)
            return acc

        accs = _ring_accumulate(lay, _wire_cast(model, factors[o]), init,
                                chunk_fn)
        for (_, _, _, alpha), (gs, gr, rh) in zip(prep, accs):
            if gs is not None:
                gram_shared = alpha * gs if gram_shared is None \
                    else gram_shared + alpha * gs
            if gr is not None:
                gram_rows = alpha * gr if gram_rows is None \
                    else gram_rows.add_(alpha * gr)
            rhs = alpha * rh if rhs is None else rhs.add_(alpha * rh)
    if not streamed:
        return (), None
    return streamed, (gram_shared, gram_rows, rhs)


def _sharded_sweep(model: ModelDef, lay: Layout, ring: bool, data: MFData,
                   state: MFState) -> Tuple[MFState, Dict[str, torch.Tensor]]:
    """One full Gibbs sweep on this rank's row shard.

    ``gibbs.gibbs_step``'s program with the couplings made explicit: the
    same key splits, the same per-row draws (at the shard's global row
    offset), the same per-block float program (``gibbs._factor_update``)
    on the exchanged fixed view; the hyper moments and each block's sse
    and nnz all-reduced.  The residuals are taken at the padded slots of
    the last-updated entity's orientation (``ops.gathered_sddmm_padded``
    for sparse blocks) against the last half-sweep's view.  With
    ``bf16_gather`` every exchanged view is bf16 (cast before the
    collective) and so is the later entity's factor there, and the
    predictions are fp32 sums of their exact products (the reference
    types them bf16, and its compiled program computes them in fp32).
    """
    S, group = lay.n_shards, lay.group
    keys = random.split(state.key, len(model.entities) + 2)
    key, ekeys = keys[0], keys[1:]
    nkey = ekeys[-1]
    factors = list(state.factors)          # row shards (N_e / S, K)
    hypers = list(state.hypers)
    noises = list(state.noises)
    gathered: Dict[int, torch.Tensor] = {}   # entity -> its whole factor

    def fixed_view(o: int) -> torch.Tensor:
        if o not in gathered:
            f = _wire_cast(model, factors[o])
            if ring:
                full = torch.empty((model.entities[o].n_rows, f.shape[1]),
                                   dtype=f.dtype, device=f.device)
                gathered[o] = _ring_accumulate(lay, f, full, _place_chunk)
            else:
                gathered[o] = _all_gather(f, group)
        return gathered[o]

    for e, ent in enumerate(model.entities):
        side = data.sides[e]
        k_hyp, k_fac, k_blk = random.split(ekeys[e], 3)
        u = factors[e]
        row_offset = lay.shard * (ent.n_rows // S)
        ftf = _side_gram(data, e) if isinstance(ent.prior, MacauPrior) \
            else None
        hyper = _psum_hyper(model, e, k_hyp, u, hypers[e], side, group,
                            ftf=ftf)
        skip, pre = (), None
        if ring and not isinstance(ent.prior, SpikeAndSlabPrior):
            skip, pre = _stream_dense(model, lay, data, e, factors, noises,
                                      k_blk, gathered, row_offset)
        factors[e] = _factor_update(model, data, k_fac, k_blk, e, u, hyper,
                                    fixed_view, noises,
                                    row_offset=row_offset, skip=skip,
                                    pre=pre)
        hypers[e] = hyper
        gathered.pop(e, None)   # a view of e is stale now

    # noise states and metrics from the residuals, reusing the last
    # half-sweep's view: each block oriented along its later-updated
    # entity, whose fixed factor (the earlier one) is whole here
    metrics = {}
    nkeys = random.split(nkey, max(1, len(model.blocks)))
    for bi, blk in enumerate(model.blocks):
        e_last = max(blk.row_entity, blk.col_entity)
        payload = data.blocks[bi]
        fixed = gathered[blk.other(e_last)]
        v = _wire_cast(model, factors[e_last])
        if blk.sparse:
            padded = payload.rows if blk.row_entity == e_last \
                else payload.cols
            vals, msk = padded.val, padded.mask
            pred = ops.gathered_sddmm_padded(v, fixed, padded.idx)
        else:
            vals, msk = payload.oriented(blk.row_entity == e_last)
            pred = v.float() @ fixed.float().T
        resid = (vals - pred) * msk
        se = _all_reduce(torch.sum(resid * resid), group)
        nnz = _all_reduce(torch.sum(msk), group)
        del resid
        noises[bi] = blk.noise.sample_state(nkeys[bi], noises[bi], pred,
                                            vals, msk, sse=se, nnz=nnz)
        del pred
        metrics[f"rmse_train_{bi}"] = torch.sqrt(
            se / torch.clamp_min(nnz, 1.0))
        metrics[f"alpha_{bi}"] = noises[bi]["alpha"]

    new_state = MFState(key, tuple(factors), tuple(hypers), tuple(noises),
                        state.step + 1)
    return new_state, metrics


class DistributedStep:
    """``step(data, state) -> (state, metrics)`` on this rank's shard.

    Made by :func:`make_distributed_step` (one chain) or
    :func:`make_multi_chain_step` (a stacked state, this rank's chains
    looped over: chain c is bitwise its single-chain distributed run).
    ``gather_state`` rebuilds the whole state on every rank and
    ``gather_metrics`` every chain's metrics; their collectives are
    counted apart from the sweep's (``census("gather")``).  Outside the
    sharded subset (``supported`` False) the step is the single-device
    sweep on the whole data, and both gathers return their input.
    """

    def __init__(self, model: ModelDef, lay: Optional[Layout],
                 pipeline: str, stacked: bool = False):
        self.model = model
        self.layout = lay
        self.pipeline = pipeline
        self.stacked = stacked
        self.supported = lay is not None

    def __call__(self, data: MFData, state: MFState):
        model = self.model
        if not self.supported:
            return (multi_chain_step(model, data, state) if self.stacked
                    else gibbs_step(model, data, state))
        ring = self.pipeline == "ring"
        if not self.stacked:
            return _sharded_sweep(model, self.layout, ring, data, state)
        outs = [_sharded_sweep(model, self.layout, ring, data,
                               unstack_state(state, c))
                for c in range(state.key.shape[0])]
        metrics = {k: torch.stack([m[k] for _, m in outs])
                   for k in outs[0][1]}
        return stack_states([s for s, _ in outs]), metrics

    def _gather_chains(self, x: torch.Tensor) -> torch.Tensor:
        lay = self.layout
        if lay.chain_group is None:
            return x
        return _all_gather(x, lay.chain_group, bucket="gather")

    def gather_state(self, state: MFState) -> MFState:
        """The whole state (every row; with a chain axis, every chain)
        on every rank.  Collective."""
        if not self.supported:
            return state
        group = self.layout.group
        if not self.stacked:
            return state._replace(factors=tuple(
                _all_gather(f, group, bucket="gather")
                for f in state.factors))
        # rows are axis 1 of a stacked factor: gather them as axis 0
        factors = tuple(self._gather_chains(
            _all_gather(f.transpose(0, 1), group, bucket="gather")
            .transpose(0, 1).contiguous()) for f in state.factors)
        return MFState(self._gather_chains(state.key), factors,
                       _leaves(state.hypers, self._gather_chains),
                       _leaves(state.noises, self._gather_chains),
                       state.step)

    def gather_metrics(self, metrics: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
        """Every chain's metrics (identity without a chain axis)."""
        if not (self.supported and self.stacked):
            return metrics
        return {k: self._gather_chains(v) for k, v in metrics.items()}


def make_distributed_step(model: ModelDef, mesh, data: MFData,
                          state: MFState, pipeline: Optional[str] = None):
    """The sharded sweep on ``mesh``: returns ``(step_fn, local_data,
    local_state)``, this rank's row shard of both padded orientations,
    of the dense ``X``/``XT``, of the sides and of the factors (the
    Macau side^T side whole, in ``local_data.side_grams``);
    ``step_fn.gather_state`` rebuilds the whole state.  Collective:
    every rank calls it with the same arguments.

    ``pipeline`` chooses the fixed factor's exchange: ``"eager"`` (one
    all-gather a half-sweep) or ``"ring"`` (S - 1 hops overlapping the
    local work); None defers to ``REPRO_PIPELINE``.  A model outside the
    sharded subset gets the single-device ``gibbs_step`` on the whole
    ``data`` and ``state``.
    """
    pipeline = resolve_pipeline(pipeline)
    _check_device(model, mesh)
    if not distributed_supported(model, mesh, data):
        return DistributedStep(model, None, pipeline), data, state
    lay = make_layout(mesh)
    return (DistributedStep(model, lay, pipeline),
            _place_data(model, lay, data), _place_state(model, lay, state))


def make_multi_chain_step(model: ModelDef, mesh, data: MFData,
                          stacked: MFState,
                          pipeline: Optional[str] = None,
                          chains: int = 1,
                          chain_axis: Optional[str] = None):
    """The sharded sweep over a chain-stacked ``(C, ...)`` state.

    Each rank loops over its chains, so chain c is bitwise its
    single-chain distributed run keyed ``chain_keys(seed, C)[c]``.  With
    ``chain_axis`` the chains split over that mesh dim (C / size a rank)
    and rows over the factor axes; the sweep's census is then the
    single-chain census on the smaller row group times the local chains
    (``contract_for(..., chains=C, chain_axis_size=...)``).  Without it
    every rank sweeps all C chains and the census scales by C.

    Returns ``(step_fn, local_data, local_stacked)``; metrics come back
    stacked (C_local,) a quantity (``step_fn.gather_metrics`` makes them
    (C,)).
    """
    pipeline = resolve_pipeline(pipeline)
    C = int(stacked.key.shape[0])
    if chains != 1 and chains != C:
        raise ValueError(f"chains={chains}, but the stacked state holds "
                         f"{C} chains; valid: 1 or {C}")
    _validate_chain_axis(mesh, C, chain_axis)
    _check_device(model, mesh)
    if not distributed_supported(model, mesh, data):
        return (DistributedStep(model, None, pipeline, stacked=True), data,
                stacked)
    lay = make_layout(mesh, chain_axis)
    per = C // lay.chain_size
    c0 = lay.chain_index * per
    return (DistributedStep(model, lay, pipeline, stacked=True),
            _place_data(model, lay, data),
            _place_state(model, lay, stacked, chains=(c0, c0 + per)))


def pad_rows_to(n: int, devices: int) -> int:
    """Round a row count up so every shard is equal (elastic re-bucket)."""
    return int(-(-n // devices) * devices)
