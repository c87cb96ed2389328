"""The Gibbs sweep (paper Algorithm 1) in PyTorch.

The counterpart of ``repro/core/gibbs.py`` for the main path: Normal
(Normal-Wishart) priors on every entity and sparse blocks with Gaussian
noise.  One ``gibbs_step`` performs, per entity in order:

  1. resample the entity's prior hyper-parameters from its current
     factor matrix,
  2. resample the whole factor matrix from its conditional in one
     batched pass: the fixed factor's rows gathered over the padded
     rows, their masked Gram + rhs weighted by the noise's alpha and,
     for the entity's last block, Lambda_p added
     (``kernels/ops.gathered_gram_and_rhs``: one CUDA kernel a block on
     the card, which gathers in its loads), batched Cholesky and
     triangular solves, one counter-based N(0, 1) draw per row,

then resamples every block's noise state from the residuals at the
observed entries (``kernels/ops.sddmm``) and reports train-RMSE
metrics.  The keys are split in the reference's order, so the chain
draws the same numbers as ``repro``'s.

Unlike the reference's pure functions, the factor update works in place
on the freshly allocated (N, K, K) Gram: at 131,072 rows and K = 128
each such buffer is 8.6 GB, and an out-of-place sum would hold two.
The float program is the reference's, ``(g1 * a1 + g2 * a2) + Lam_p``,
each operation rounded apart, on the CPU and on the card.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from .. import random
from ..kernels import ops
from .blocks import ModelDef
from .priors import NormalPrior, chol_solve, cholesky, solve_lower
from .sparse import SparseMatrix


class MFState(NamedTuple):
    """Full sampler state -- everything needed to restart the chain."""

    key: torch.Tensor                   # (2,) threefry key
    factors: Tuple[torch.Tensor, ...]   # per entity (N_e, K)
    hypers: Tuple[Dict[str, torch.Tensor], ...]   # per entity prior state
    noises: Tuple[Dict[str, torch.Tensor], ...]   # per block noise state
    step: int                           # sweep counter


class MFData(NamedTuple):
    """Observed data -- static across the chain."""

    blocks: Tuple[SparseMatrix, ...]
    sides: Tuple[Optional[torch.Tensor], ...]   # per entity side info


def _check_slice(model: ModelDef, data: MFData) -> None:
    for ent in model.entities:
        if not isinstance(ent.prior, NormalPrior):
            raise ValueError(
                f"entity {ent.name!r} has prior {type(ent.prior).__name__}"
                "; the port supports NormalPrior only so far (see "
                "ROADMAP.md, queue A)")
    for bi, blk in enumerate(model.blocks):
        if not blk.sparse or not isinstance(data.blocks[bi], SparseMatrix):
            raise ValueError(
                f"block {bi} is dense; the port supports sparse blocks "
                "only so far (see ROADMAP.md, queue A)")
    if any(s is not None for s in data.sides):
        raise ValueError("side information (Macau) is not ported yet; "
                         "see ROADMAP.md, queue A")


def init_state(model: ModelDef, data: MFData, seed: int = 0) -> MFState:
    """Fresh chain state from the static graph alone, on
    ``model.device``; ``data`` is accepted for signature symmetry and
    never read."""
    dev = model.device
    keys = random.split(random.PRNGKey(seed, device=dev),
                        len(model.entities) + 1)
    factors = []
    hypers = []
    for e, ent in enumerate(model.entities):
        factors.append(random.normal(keys[e],
                                     (ent.n_rows, model.num_latent)))
        hypers.append(ent.prior.init(keys[e], ent.n_rows, dev))
    noises = tuple(b.noise.init(dev) for b in model.blocks)
    return MFState(keys[-1], tuple(factors), tuple(hypers), noises, 0)


# ---------------------------------------------------------------------------
# per-block contributions to an entity's conditional
# ---------------------------------------------------------------------------

def _sparse_contrib(mat: SparseMatrix, as_row: bool, fixed: torch.Tensor,
                    noise, nstate, key, acc=None, lam=None):
    """alpha-weighted (gram, rhs) of one sparse block for one entity,
    (R,K,K) and (R,K); added in place to ``acc`` = (gram, rhs) when
    given, and ``lam`` added to the Gram when given."""
    padded = mat.rows if as_row else mat.cols
    vals, alpha = noise.augment(key, nstate, None, padded.val, padded.mask)
    return ops.gathered_gram_and_rhs(fixed, padded.idx, vals, padded.mask,
                                     alpha, acc=acc, lam=lam)


# ---------------------------------------------------------------------------
# factor conditionals
# ---------------------------------------------------------------------------

def row_normals(key, n_rows: int, num_latent: int, row_offset=0):
    """(n_rows, K) standard normals drawn row-by-row, counter-based.

    Row i's draw comes from ``fold_in(key, row_offset + i)`` -- a pure
    function of the sweep key and the row's GLOBAL index, never of the
    batch shape, so a shard holding rows [off, off + n) draws exactly
    the numbers the single-device sweep draws for those rows.
    """
    rows = row_offset + torch.arange(n_rows, device=key.device)
    return random.normal(random.fold_in(key, rows), (num_latent,))


def _sample_normal_factor(key, Lam, rhs, b_p):
    """u_i ~ N(Lam_i^{-1} b_i, Lam_i^{-1}) batched over rows.

    Lam (N,K,K) the precision (the blocks' Grams with Lambda_p added),
    rhs (N,K), b_p (K,).
    """
    b = rhs + b_p[None, :]
    z = row_normals(key, b.shape[0], b.shape[1])
    L = cholesky(Lam)                                        # (N,K,K)
    mean = chol_solve(L, b)
    dz = solve_lower(L, z[..., None], transpose=True)[..., 0]
    return mean + dz


def _entity_update(model: ModelDef, data: MFData, key, e: int,
                   factors, hypers, noises):
    """Hyper-sample + factor-sample for one entity; returns updates."""
    ent = model.entities[e]
    prior = ent.prior
    k_hyp, k_fac, k_blk = random.split(key, 3)
    u = factors[e]

    # 1. hyper-parameters from the current factor (Algorithm 1 line 2/5)
    hyper = prior.sample_hyper(k_hyp, u, hypers[e])

    # 2. factor matrix from its conditional
    Lam_p = prior.precision_term(hyper)
    b_p = prior.mean_term(hyper, ent.n_rows)

    # each block adds its alpha-weighted Gram and rhs to the entity's
    # in place; the last adds Lambda_p too
    acc = None
    bkeys = random.split(k_blk, max(1, len(model.blocks)))
    touching = list(model.blocks_touching(e))
    for n, (bi, as_row) in enumerate(touching):
        blk = model.blocks[bi]
        acc = _sparse_contrib(data.blocks[bi], as_row, factors[blk.other(e)],
                              blk.noise, noises[bi], bkeys[bi], acc=acc,
                              lam=Lam_p if n == len(touching) - 1 else None)
    if acc is None:
        K = model.num_latent
        acc = (torch.zeros((ent.n_rows, K, K), dtype=torch.float32,
                           device=u.device).add_(Lam_p[None, :, :]),
               torch.zeros((ent.n_rows, K), dtype=torch.float32,
                           device=u.device))
    u_new = _sample_normal_factor(k_fac, *acc, b_p)
    return u_new, hyper


def _block_pred_observed(model: ModelDef, data: MFData, bi: int, factors):
    """Predictions + (vals, mask) at a block's observed entries."""
    blk = model.blocks[bi]
    U = factors[blk.row_entity]
    V = factors[blk.col_entity]
    payload = data.blocks[bi]
    pred = ops.sddmm(U.index_select(0, payload.coo_i),
                     V.index_select(0, payload.coo_j))
    return pred, payload.coo_v, payload.coo_mask


def gibbs_step(model: ModelDef, data: MFData, state: MFState
               ) -> Tuple[MFState, Dict[str, torch.Tensor]]:
    """One full Gibbs sweep over all entities + noise states."""
    _check_slice(model, data)
    keys = random.split(state.key, len(model.entities) + 2)
    key, ekeys = keys[0], keys[1:]
    nkey = ekeys[-1]
    factors = list(state.factors)
    hypers = list(state.hypers)
    noises = list(state.noises)

    for e in range(len(model.entities)):
        u_new, hyper = _entity_update(model, data, ekeys[e], e,
                                      tuple(factors), tuple(hypers),
                                      tuple(noises))
        factors[e] = u_new
        hypers[e] = hyper

    metrics = {}
    nkeys = random.split(nkey, max(1, len(model.blocks)))
    for bi, blk in enumerate(model.blocks):
        pred, vals, mask = _block_pred_observed(model, data, bi,
                                                tuple(factors))
        noises[bi] = blk.noise.sample_state(nkeys[bi], noises[bi], pred,
                                            vals, mask)
        se = torch.sum(((vals - pred) * mask) ** 2)
        # all-masked blocks have nnz == 0: report rmse 0, not 0/0
        metrics[f"rmse_train_{bi}"] = torch.sqrt(
            se / torch.clamp_min(torch.sum(mask), 1.0))
        metrics[f"alpha_{bi}"] = noises[bi]["alpha"]

    new_state = MFState(key, tuple(factors), tuple(hypers), tuple(noises),
                        state.step + 1)
    return new_state, metrics


def run_sweeps(model: ModelDef, data: MFData, state: MFState, n: int
               ) -> Tuple[MFState, Dict[str, Any]]:
    """n sweeps; returns the final state and the metrics stacked over
    sweeps, as the reference's ``lax.scan`` does."""
    trace: Dict[str, list] = {}
    for _ in range(n):
        state, m = gibbs_step(model, data, state)
        for k, v in m.items():
            trace.setdefault(k, []).append(v)
    return state, {k: torch.stack(v) for k, v in trace.items()}
