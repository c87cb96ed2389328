"""The Gibbs sweep (paper Algorithm 1) in PyTorch.

The counterpart of ``repro/core/gibbs.py``.  One ``gibbs_step``
performs, per entity in order:

  1. resample the entity's prior hyper-parameters from its current
     factor matrix (Normal-Wishart; Macau adds its link matrix beta;
     spike-and-slab its inclusion odds and slab precisions),
  2. resample the whole factor matrix from its conditional in one
     batched pass.  A sparse block gathers the fixed factor's rows over
     its padded rows, and their masked Gram + rhs, weighted by the
     noise's alpha and, for the entity's last block, with Lambda_p
     added, come from ``kernels/ops.gathered_gram_and_rhs`` (one CUDA
     kernel a block on the card, which gathers in its loads); probit
     noise first draws its latents around the predictions at every
     padded slot (``kernels/ops.gathered_sddmm_padded``).  A fully observed
     dense block adds one (K, K) Gram shared by all rows, a masked one
     a per-row Gram.  Then batched Cholesky and triangular solves (one
     Cholesky and matrix solves when every row shares its precision)
     and one counter-based N(0, 1) draw per row.  Spike-and-slab
     entities take the coordinate-wise update of
     ``_sample_sns_factor`` instead,

then resamples every block's noise state from the residuals at the
observed entries (``kernels/ops.gathered_sddmm`` for sparse blocks,
``U @ V.T`` for dense ones) and reports train-RMSE metrics.  The keys
are split in the reference's order, so the chain draws the same numbers
as ``repro``'s.  ``multi_chain_step`` runs several chains, one after the
other: chain c is the single-chain run keyed ``chain_keys(seed, C)[c]``.

With ``ModelDef.bf16_gather`` every consumer of an entity update reads
one bf16 copy of each other entity's current factor (``gather_view``),
and the sweep-end metrics one more of every factor: the Gram of the
gathered rows (``gathered_gram_and_rhs``'s bf16 entry), probit's padded
predictions (fp32 u against the bf16 rows), the dense contributions,
the spike-and-slab update and the predictions at the observed entries
(``gathered_sddmm``'s bf16 entry).  Every product reads the bf16 values
widened exactly, so it is exact in fp32: where JAX types a product of
two bf16 operands bf16 (a dense block's shared Gram ``fixed.T @ fixed``,
the dense predictions ``U @ V.T``, spike-and-slab's ``f_k * f_k``), its
only consumers are fp32, and XLA's compiled program computes it in fp32
(the convert folds into the dot or the multiply; the reference's
``gibbs_step`` is jitted).  The roundings that remain are the
reference's explicit ones: ``val * mask`` to bf16 in the Gram's rhs,
and the bf16 result of ``jnp.sum`` over a fully observed view in the
spike-and-slab update.  Without the flag the program is the fp32 one,
bit for bit.

Unlike the reference's pure functions, the factor update works in place
on the freshly allocated (N, K, K) Gram: at 131,072 rows and K = 128
each such buffer is 8.6 GB, and an out-of-place sum would hold two.
The float program is the reference's, ``(g1 * a1 + g2 * a2) + Lam_p``,
each operation rounded apart, on the CPU and on the card.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from .. import random
from ..kernels import ops
from .blocks import DenseBlock, ModelDef
from .noise import ProbitNoise
from .priors import (FixedNormalPrior, MacauPrior, SpikeAndSlabPrior,
                     chol_solve, cholesky, solve_lower)
from .sparse import SparseMatrix


class MFState(NamedTuple):
    """Full sampler state -- everything needed to restart the chain."""

    key: torch.Tensor                   # (2,) threefry key
    factors: Tuple[torch.Tensor, ...]   # per entity (N_e, K)
    hypers: Tuple[Dict[str, torch.Tensor], ...]   # per entity prior state
    noises: Tuple[Dict[str, torch.Tensor], ...]   # per block noise state
    step: int                           # sweep counter


class MFData(NamedTuple):
    """Observed data -- static across the chain.

    ``side_grams`` holds side^T side of each entity's side information
    (None where it has none), the (D, D) product Macau's hyper-sample
    needs: the reference recomputes it in every sweep, the port once
    with the data (``with_side_grams``, which ``ModelBuilder.build`` and
    ``convert.data_from_reference`` call).  A sweep over data with side
    information and no ``side_grams`` raises.
    """

    blocks: Tuple[Any, ...]                     # SparseMatrix | DenseBlock
    sides: Tuple[Optional[torch.Tensor], ...]   # per entity side info
    side_grams: Optional[Tuple[Optional[torch.Tensor], ...]] = None


def with_side_grams(data: MFData) -> MFData:
    """``data`` with side^T side computed once for every side matrix."""
    return data._replace(side_grams=tuple(
        None if s is None else s.T @ s for s in data.sides))


def init_state(model: ModelDef, data: MFData, seed: int = 0,
               key: Optional[torch.Tensor] = None) -> MFState:
    """Fresh chain state from the static graph alone, on
    ``model.device``; ``data`` is accepted for signature symmetry and
    never read.  ``key`` overrides ``PRNGKey(seed)``: the multi-chain
    layer passes ``chain_keys(seed, C)[c]``."""
    dev = model.device
    if key is None:
        key = random.PRNGKey(seed, device=dev)
    keys = random.split(key.to(dev), len(model.entities) + 1)
    factors = []
    hypers = []
    for e, ent in enumerate(model.entities):
        factors.append(random.normal(keys[e],
                                     (ent.n_rows, model.num_latent)))
        hypers.append(ent.prior.init(keys[e], ent.n_rows, dev))
    noises = tuple(b.noise.init(dev) for b in model.blocks)
    return MFState(keys[-1], tuple(factors), tuple(hypers), noises, 0)


# ---------------------------------------------------------------------------
# several chains
# ---------------------------------------------------------------------------

def chain_keys(seed: int, chains: int, device="cpu") -> List[torch.Tensor]:
    """Per-chain root keys: chain 0 is ``PRNGKey(seed)`` itself (not
    folded), so chain 0 of any C-chain run is the single-chain run;
    chain c > 0 folds c into it."""
    base = random.PRNGKey(seed, device=device)
    return [base if c == 0 else random.fold_in(base, c)
            for c in range(chains)]


def init_chain_states(model: ModelDef, data: MFData, seed: int,
                      chains: int) -> List[MFState]:
    """C independent fresh states, one per chain key."""
    return [init_state(model, data, seed, key=k)
            for k in chain_keys(seed, chains, model.device)]


def _stack(xs):
    x0 = xs[0]
    if isinstance(x0, dict):
        return {k: _stack([x[k] for x in xs]) for k in x0}
    if isinstance(x0, tuple):
        return tuple(_stack(list(t)) for t in zip(*xs))
    return torch.stack(xs)


def _take(x, c: int):
    if isinstance(x, dict):
        return {k: _take(v, c) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_take(v, c) for v in x)
    return x[c].clone()


def stack_states(states: List[MFState]) -> MFState:
    """Stack per-chain states along a new leading chain axis; the sweep
    counter is shared."""
    steps = {s.step for s in states}
    if len(steps) != 1:
        raise ValueError(f"chains at different sweeps: {sorted(steps)}")
    return MFState(torch.stack([s.key for s in states]),
                   _stack([s.factors for s in states]),
                   _stack([s.hypers for s in states]),
                   _stack([s.noises for s in states]), states[0].step)


def unstack_state(stacked: MFState, c: int) -> MFState:
    """Chain ``c`` of a stacked state, in tensors of its own."""
    return MFState(stacked.key[c].clone(), _take(stacked.factors, c),
                   _take(stacked.hypers, c), _take(stacked.noises, c),
                   stacked.step)


def multi_chain_step(model: ModelDef, data: MFData, stacked: MFState
                     ) -> Tuple[MFState, Dict[str, torch.Tensor]]:
    """One Gibbs sweep of every chain of a stacked state, a loop over the
    chains: each runs ``gibbs_step`` on its own tensors, so chain c is
    bitwise the single-chain run (batching the chains into wider ops
    would sum in another order).  Metrics come back stacked with a
    leading (C,) axis."""
    C = stacked.key.shape[0]
    outs = [gibbs_step(model, data, unstack_state(stacked, c))
            for c in range(C)]
    metrics = {k: torch.stack([m[k] for _, m in outs]) for k in outs[0][1]}
    return stack_states([s for s, _ in outs]), metrics


# ---------------------------------------------------------------------------
# per-block contributions to an entity's conditional
# ---------------------------------------------------------------------------

def _sparse_contrib(mat: SparseMatrix, as_row: bool, fixed: torch.Tensor,
                    noise, nstate, key, acc=None, lam=None, u_cur=None,
                    row_offset=0):
    """alpha-weighted (gram, rhs) of one sparse block for one entity,
    (R,K,K) and (R,K); added in place to ``acc`` = (gram, rhs) when
    given, and ``lam`` added to the Gram when given.  Probit noise draws
    its latents around the predictions of the current factor ``u_cur``
    at every padded slot (padded slots gather row 0; ``augment`` zeroes
    them).  ``row_offset`` is the global index of the padded rows' row
    0: nonzero on a row shard of the distributed sweep."""
    padded = mat.rows if as_row else mat.cols
    pred = None
    if isinstance(noise, ProbitNoise):
        pred = ops.gathered_sddmm_padded(u_cur, fixed, padded.idx)
    vals, alpha = noise.augment(key, nstate, pred, padded.val, padded.mask,
                                row_offset=row_offset)
    return ops.gathered_gram_and_rhs(fixed, padded.idx, vals, padded.mask,
                                     alpha, acc=acc, lam=lam)


def _dense_contrib(payload: DenseBlock, as_row: bool, fixed: torch.Tensor,
                   u_cur: torch.Tensor, noise, nstate, key, row_offset=0):
    """Contributions of a dense block: (gram_shared | None,
    gram_rows | None, rhs).  A fully observed block gives one (K, K)
    Gram for every row, a masked one a (R, K, K) Gram per row.
    ``row_offset`` as in ``_sparse_contrib``."""
    X, m = payload.oriented(as_row)             # (R, C)
    wide = fixed.float()     # a bf16 fixed, widened exactly
    pred = u_cur @ wide.T if isinstance(noise, ProbitNoise) else None
    vals, alpha = noise.augment(key, nstate, pred, X, m,
                                row_offset=row_offset)
    if payload.fully:
        return alpha * (wide.T @ wide), None, alpha * (vals @ wide)
    gram_rows = alpha * torch.einsum("rc,ck,cl->rkl", m, wide, wide)
    return None, gram_rows, alpha * ((vals * m) @ wide)


def _dense_chunk_contrib(vals: torch.Tensor, m: torch.Tensor, fully: bool,
                         chunk: torch.Tensor, c0: int):
    """The moments of ``_dense_contrib`` for the fixed factor's rows
    ``[c0, c0 + Cc)`` (``chunk``): summed over any partition of the
    columns they equal the whole block's up to f32 summation order.
    ``vals``/``m`` are the full oriented (R, C) payload, already
    augmented; alpha is applied by the caller after the sum.  A bf16
    chunk (``bf16_gather``) is widened exactly, as in ``_dense_contrib``."""
    vs = vals[:, c0:c0 + chunk.shape[0]]
    wide = chunk.float()
    if fully:
        return wide.T @ wide, None, vs @ wide
    ms = m[:, c0:c0 + chunk.shape[0]]
    gram_rows = torch.einsum("rc,ck,cl->rkl", ms, wide, wide)
    return None, gram_rows, (vs * ms) @ wide


# ---------------------------------------------------------------------------
# counter-based per-row draws
# ---------------------------------------------------------------------------

def _row_keys(key, n_rows: int, row_offset: int) -> torch.Tensor:
    rows = row_offset + torch.arange(n_rows, device=key.device)
    return random.fold_in(key, rows)


def row_normals(key, n_rows: int, num_latent: int, row_offset=0):
    """(n_rows, K) standard normals drawn row-by-row, counter-based.

    Row i's draw comes from ``fold_in(key, row_offset + i)`` -- a pure
    function of the sweep key and the row's GLOBAL index, never of the
    batch shape, so a shard holding rows [off, off + n) draws exactly
    the numbers the single-device sweep draws for those rows.
    """
    return random.normal(_row_keys(key, n_rows, row_offset), (num_latent,))


def row_uniforms(key, n_rows: int, width: int, row_offset=0, *,
                 minval=0.0, maxval=1.0):
    """(n_rows, width) uniforms drawn row-by-row, counter-based, with
    :func:`row_normals`' contract; probit's latents consume them."""
    return random.uniform(_row_keys(key, n_rows, row_offset), (width,),
                          minval, maxval)


def row_bernoulli(key, p: torch.Tensor, row_offset=0) -> torch.Tensor:
    """Bernoulli(p) draws, counter-based row-by-row: ``p`` is (n_rows,)
    or (n_rows, W), row i's draws the uniforms of
    ``fold_in(key, row_offset + i)``; the spike-and-slab inclusion
    indicators consume them."""
    width = 1 if p.dim() == 1 else p.shape[1]
    u = row_uniforms(key, p.shape[0], width, row_offset)
    if p.dim() == 1:
        u = u[:, 0]
    return u < p


# ---------------------------------------------------------------------------
# factor conditionals
# ---------------------------------------------------------------------------

def _sample_normal_factor(key, rhs, b_p, *, Lam_rows=None, Lam_shared=None,
                          row_offset=0):
    """u_i ~ N(Lam_i^{-1} b_i, Lam_i^{-1}) batched over rows.

    ``Lam_rows`` (N, K, K) is the per-row precision (the blocks' Grams
    with Lambda_p added), or ``Lam_shared`` (K, K) the one precision of
    every row: then one Cholesky and matrix solves.  rhs (N, K); b_p
    (K,) or (N, K).  ``row_offset`` is the global index of row 0.
    """
    b = rhs + b_p if b_p.dim() == 2 else rhs + b_p[None, :]
    z = row_normals(key, b.shape[0], b.shape[1], row_offset)
    if Lam_rows is None:
        L = cholesky(Lam_shared)                             # (K, K)
        mean = solve_lower(L, solve_lower(L, b.T), transpose=True).T
        dz = solve_lower(L, z.T, transpose=True).T
        return mean + dz
    L = cholesky(Lam_rows)                                   # (N, K, K)
    mean = chol_solve(L, b)
    dz = solve_lower(L, z[..., None], transpose=True)[..., 0]
    return mean + dz


def _sample_sns_factor(model: ModelDef, data: MFData, key, e: int,
                       u: torch.Tensor, hyper, fixed_view, noises,
                       row_offset=0,
                       trace: Optional[list] = None) -> torch.Tensor:
    """Coordinate-wise spike-and-slab update for entity ``e``.

    For each latent component k in order (the conditionals are coupled
    through the residual), vectorized over rows:

        q_ik = tau_k + sum_b alpha_b sum_t m f_k^2
        l_ik = sum_b alpha_b sum_t m (r - pred_{-k}) f_k
        odds = rho/(1-rho) * sqrt(tau_k/q) * exp(l^2 / 2q)
        s ~ Bern(odds/(1+odds));  u_ik = s * N(l/q, 1/q)

    The inclusion draw folds k into ``k_incl`` and the slab draw into
    ``k_slab`` (``split(key)``), as the reference's loop does.  A dense
    block's running prediction (R, C) is updated in place.
    ``fixed_view(o)`` is the whole factor of entity ``o``; ``u`` and the
    blocks' rows may be a row shard whose row 0 has the global index
    ``row_offset``: q and l are row-local, and both draws are
    counter-based on the global row.  A bf16 view (``bf16_gather``) is
    widened exactly at every product; a fully observed block's
    sum_c f_k^2 is rounded to bf16, as the reference's ``jnp.sum`` of a
    bf16 vector is.
    ``trace``, when a list, receives ``(k, p_incl, s)`` per component
    (the tests read the inclusion odds there).
    """
    touching = model.blocks_touching(e)
    views = []
    for bi, as_row in touching:
        blk = model.blocks[bi]
        payload = data.blocks[bi]
        fixed = fixed_view(blk.other(e))
        alpha = noises[bi]["alpha"]
        if blk.sparse:
            padded = payload.rows if as_row else payload.cols
            R, T = padded.idx.shape
            vg = fixed.index_select(0, padded.idx.reshape(-1)).reshape(
                R, T, -1)                                # (R, T, K)
            pred = torch.einsum("rtk,rk->rt", vg.float(), u)
            views.append(["sp", vg, padded.val, padded.mask, pred, alpha])
        else:
            X, m = payload.oriented(as_row)
            kind = "df" if payload.fully else "dn"
            views.append([kind, fixed, X, m, u @ fixed.float().T, alpha])

    rho, tau = hyper["rho"], hyper["tau"]
    k_incl, k_slab = random.split(key)
    u = u.clone()
    n = u.shape[0]
    for k in range(model.num_latent):
        q = tau[k]
        l = torch.zeros(n, dtype=torch.float32, device=u.device)
        for view in views:
            kind, Fv, val, m, pred, alpha = view
            if kind == "sp":
                fk = Fv[:, :, k].float()                 # (R, T)
                pred = pred - u[:, k][:, None] * fk
                view[4] = pred
                q = q + alpha * torch.sum(fk * fk * m, dim=-1)
                l = l + alpha * torch.sum((val - pred) * m * fk, dim=-1)
                continue
            fk = Fv[:, k].float()                        # (C,)
            pred.addr_(u[:, k], fk, alpha=-1.0)
            if kind == "df":
                # fully observed: every row shares sum_c fk_c^2 and the
                # mask multiply drops
                q = q + alpha * torch.sum(fk * fk).to(Fv.dtype).float()
                l = l + alpha * ((val - pred) @ fk)
            else:
                q = q + alpha * (m @ (fk * fk))
                l = l + alpha * (((val - pred) * m) @ fk)

        mu = l / q
        log_odds = (torch.log(rho[k]) - torch.log1p(-rho[k])
                    + 0.5 * (torch.log(tau[k]) - torch.log(q))
                    + 0.5 * mu * l)
        p_incl = torch.sigmoid(log_odds)
        s = row_bernoulli(random.fold_in(k_incl, k), p_incl,
                          row_offset).to(torch.float32)
        eps = row_normals(random.fold_in(k_slab, k), n, 1, row_offset)[:, 0]
        u_k = s * (mu + eps / torch.sqrt(q))
        u[:, k] = u_k
        if trace is not None:
            trace.append((k, p_incl, s))

        # fold the new component back into the predictions
        for view in views:
            kind, Fv, _, _, pred, _ = view
            if kind == "sp":
                view[4] = pred + u_k[:, None] * Fv[:, :, k].float()
            else:
                pred.addr_(u_k, Fv[:, k].float())
    return u


# ---------------------------------------------------------------------------
# the full sweep
# ---------------------------------------------------------------------------

def _side_gram(data: MFData, e: int) -> torch.Tensor:
    if data.side_grams is None or data.side_grams[e] is None:
        raise ValueError(
            f"entity {e} has side information but MFData.side_grams has "
            "no side^T side for it: build the data with "
            "gibbs.with_side_grams (ModelBuilder and "
            "convert.data_from_reference do)")
    return data.side_grams[e]


def _prior_terms(prior, hyper, n_rows: int, side, device):
    """(Lambda_p, b_p) of an entity's prior."""
    if isinstance(prior, FixedNormalPrior):
        return (prior.precision_term(hyper, device),
                prior.mean_term(hyper, n_rows, device))
    if isinstance(prior, MacauPrior):
        return (prior.precision_term(hyper),
                prior.mean_term(hyper, n_rows, side=side))
    return prior.precision_term(hyper), prior.mean_term(hyper, n_rows)


def gather_view(model: ModelDef, factors):
    """``fixed_view(o)``: the factor of entity ``o`` as the gathers and
    contractions read it.  With ``bf16_gather`` a bf16 copy, made at the
    first call for ``o`` and shared by every later one (the reference's
    ``_gather_view``, which one XLA program shares among its consumers);
    without it the factor itself."""
    if not model.bf16_gather:
        return factors.__getitem__
    copies: Dict[int, torch.Tensor] = {}

    def view(o: int) -> torch.Tensor:
        if o not in copies:
            copies[o] = factors[o].to(torch.bfloat16)
        return copies[o]
    return view


def _entity_update(model: ModelDef, data: MFData, key, e: int,
                   factors, hypers, noises):
    """Hyper-sample + factor-sample for one entity; returns updates."""
    prior = model.entities[e].prior
    side = data.sides[e]
    k_hyp, k_fac, k_blk = random.split(key, 3)
    u = factors[e]

    # 1. hyper-parameters from the current factor (Algorithm 1 line 2/5)
    if isinstance(prior, MacauPrior):
        hyper = prior.sample_hyper(k_hyp, u, hypers[e], side=side,
                                   FtF=_side_gram(data, e))
    else:
        hyper = prior.sample_hyper(k_hyp, u, hypers[e])

    # 2. factor matrix from its conditional
    return _factor_update(model, data, k_fac, k_blk, e, u, hyper,
                          gather_view(model, factors), noises), hyper


def _factor_update(model: ModelDef, data: MFData, k_fac, k_blk, e: int,
                   u: torch.Tensor, hyper, fixed_view, noises,
                   row_offset=0, skip=(), pre=None) -> torch.Tensor:
    """Entity ``e``'s rows drawn from their conditional given ``hyper``.

    ``fixed_view(o)`` is the whole factor of entity ``o``; ``u``, the
    blocks' rows and the side information may be a row shard whose row
    0 has the global index ``row_offset`` (the distributed sweep).
    Blocks in ``skip`` are already summed into ``pre`` = (gram_shared,
    gram_rows, rhs), the accumulators the rest add to (the ring
    exchange's streamed dense blocks); with neither, this is the
    single-device float program.
    """
    ent = model.entities[e]
    prior = ent.prior
    if isinstance(prior, SpikeAndSlabPrior):
        return _sample_sns_factor(model, data, k_fac, e, u, hyper,
                                  fixed_view, noises, row_offset=row_offset)

    Lam_p, b_p = _prior_terms(prior, hyper, ent.n_rows, data.sides[e],
                              u.device)
    touching = [(bi, r) for bi, r in model.blocks_touching(e)
                if bi not in skip]
    # with sparse blocks alone, each adds its alpha-weighted Gram and rhs
    # to the entity's in place and the last adds Lambda_p too; a dense
    # block's Gram joins in the reference's order after the loop
    fold_lam = pre is None and all(model.blocks[bi].sparse
                                   for bi, _ in touching)
    gram_shared, gram_rows, rhs = pre or (None, None, None)
    bkeys = random.split(k_blk, max(1, len(model.blocks)))
    for n, (bi, as_row) in enumerate(touching):
        blk = model.blocks[bi]
        fixed = fixed_view(blk.other(e))
        if blk.sparse:
            acc = None if gram_rows is None else (gram_rows, rhs)
            lam = Lam_p if fold_lam and n == len(touching) - 1 else None
            g, r = _sparse_contrib(data.blocks[bi], as_row, fixed,
                                   blk.noise, noises[bi], bkeys[bi],
                                   acc=acc, lam=lam, u_cur=u,
                                   row_offset=row_offset)
            if acc is None and rhs is not None:
                r = rhs.add_(r)
            gram_rows, rhs = g, r
            continue
        gs, gr, r = _dense_contrib(data.blocks[bi], as_row, fixed, u,
                                   blk.noise, noises[bi], bkeys[bi],
                                   row_offset=row_offset)
        if gs is not None:
            gram_shared = gs if gram_shared is None else gram_shared + gs
        if gr is not None:
            gram_rows = gr if gram_rows is None else gram_rows.add_(gr)
        rhs = r if rhs is None else rhs.add_(r)

    if rhs is None:
        rhs = torch.zeros((u.shape[0], model.num_latent),
                          dtype=torch.float32, device=u.device)
    if gram_rows is None:
        # one precision shared by every row: one Cholesky
        Lam = Lam_p if gram_shared is None else gram_shared + Lam_p
        return _sample_normal_factor(k_fac, rhs, b_p, Lam_shared=Lam,
                                     row_offset=row_offset)
    if not fold_lam:
        gram_rows.add_(Lam_p if gram_shared is None
                       else gram_shared + Lam_p)
    return _sample_normal_factor(k_fac, rhs, b_p, Lam_rows=gram_rows,
                                 row_offset=row_offset)


def _block_pred_observed(model: ModelDef, data: MFData, bi: int, factors):
    """Predictions + (vals, mask) at a block's observed entries, fp32;
    bf16 factors (``bf16_gather``) go through ``gathered_sddmm``'s bf16
    entry (sparse) or are widened exactly (dense)."""
    blk = model.blocks[bi]
    U = factors[blk.row_entity]
    V = factors[blk.col_entity]
    payload = data.blocks[bi]
    if blk.sparse:
        pred = ops.gathered_sddmm(U, V, payload.coo_i, payload.coo_j)
        return pred, payload.coo_v, payload.coo_mask
    return U.float() @ V.float().T, payload.X, payload.mask


def gibbs_step(model: ModelDef, data: MFData, state: MFState
               ) -> Tuple[MFState, Dict[str, torch.Tensor]]:
    """One full Gibbs sweep over all entities + noise states."""
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

    noises, metrics = _sweep_end(model, data, nkey, tuple(factors), noises)
    new_state = MFState(key, tuple(factors), tuple(hypers), tuple(noises),
                        state.step + 1)
    return new_state, metrics


def _sweep_end(model: ModelDef, data: MFData, nkey, factors, noises):
    """Every block's noise state resampled from the residuals at its
    observed entries, and the metrics: (noises, metrics)."""
    noises = list(noises)
    metrics = {}
    nkeys = random.split(nkey, max(1, len(model.blocks)))
    view = gather_view(model, factors)
    views = [view(e) for e in range(len(factors))]
    for bi, blk in enumerate(model.blocks):
        pred, vals, mask = _block_pred_observed(model, data, bi, views)
        noises[bi] = blk.noise.sample_state(nkeys[bi], noises[bi], pred,
                                            vals, mask)
        se = torch.sum(((vals - pred) * mask) ** 2)
        del pred
        # all-masked blocks have nnz == 0: report rmse 0, not 0/0
        metrics[f"rmse_train_{bi}"] = torch.sqrt(
            se / torch.clamp_min(torch.sum(mask), 1.0))
        metrics[f"alpha_{bi}"] = noises[bi]["alpha"]
    return noises, metrics


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
