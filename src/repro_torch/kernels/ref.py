"""Plain PyTorch versions of the kernels, in fp32.

The counterpart of ``gram_ref``, ``sddmm_ref`` and ``topk_score_ref``
in ``repro/kernels/ref.py``.  ``kernels/ops.py`` runs these on CPU
tensors, the CPU tests hold them against the JAX package, and
``chip_smoke.py`` holds the CUDA kernels against them on the card.
The bf16 branches of the reference belong to the ``bf16_gather`` slice
(ROADMAP) and are not ported yet.
"""
from __future__ import annotations

import torch


def gram_ref(vg: torch.Tensor, val: torch.Tensor, mask: torch.Tensor):
    """Masked batched Gram + rhs -- the SMURFF per-row hot loop.

    For each row r (paper Algorithm 1 inner loop):
        gram[r] = sum_t mask[r,t] * vg[r,t,:] vg[r,t,:]^T     (K x K)
        rhs[r]  = sum_t mask[r,t] * val[r,t] * vg[r,t,:]      (K,)

    vg (R, T, K), val (R, T), mask (R, T) -> gram (R, K, K), rhs (R, K).
    """
    vg = vg.to(torch.float32)
    w = (val * mask).to(torch.float32)
    m = mask.to(torch.float32)
    gram = torch.einsum("rtk,rtl->rkl", vg * m[..., None], vg)
    rhs = torch.einsum("rtk,rt->rk", vg, w)
    return gram, rhs


def sddmm_ref(ug: torch.Tensor, vg: torch.Tensor) -> torch.Tensor:
    """Gathered-operand SDDMM: pred[e] = ug[e] . vg[e] -> (E,) fp32."""
    return torch.einsum("ek,ek->e", ug.to(torch.float32),
                        vg.to(torch.float32))


def topk_score_ref(us: torch.Tensor, v: torch.Tensor, excl: torch.Tensor,
                   k: int):
    """Posterior scoring + stable top-K -- the serving oracle.

    For each user b, scored against every item across every retained
    posterior sample:
        score[s, n] = us[b, s] . v[s, n]
        mean[n]     = 1/S sum_s score[s, n]
        ex2[n]      = 1/S sum_s score[s, n]^2
    ranked by mean with excluded items at -inf; ties go to the LOWEST
    item id (a stable sort of ``-rank``, in which -0.0 and +0.0 are
    equal, as in ``jnp.argsort``).  Excluded items keep their true mean
    and ex2.

    Users are scored one at a time, as the reference's ``lax.map``
    does: one identical float program per user whatever the batch, so a
    batched call is bitwise equal to B single-user calls.

    us (B, S, K), v (S, N, K), excl (B, N) with 1.0 = excluded, k <= N
    -> ids (B, k) int32, mean (B, k) f32, ex2 (B, k) f32.  The std is
    finalized by ``ops.topk_score``.  fp32 only; the reference's bf16
    operands are a later slice.
    """
    S = v.shape[0]
    us = us.to(torch.float32)
    v = v.to(torch.float32)
    # fp32 1/S, as the reference's jnp.float32(1.0) / jnp.float32(S)
    inv_s = torch.ones((), dtype=torch.float32, device=v.device) / S
    ids, means, ex2s = [], [], []
    for b in range(us.shape[0]):
        scores = torch.einsum("snk,sk->sn", v, us[b])       # (S, N)
        mean = torch.sum(scores, dim=0) * inv_s
        ex2 = torch.sum(scores * scores, dim=0) * inv_s
        rank = torch.where(excl[b] > 0, -torch.inf, mean)
        order = torch.sort(-rank, stable=True).indices[:k]
        ids.append(order.to(torch.int32))
        means.append(mean[order])
        ex2s.append(ex2[order])
    return torch.stack(ids), torch.stack(means), torch.stack(ex2s)


# The stated tolerance of one top-K result against another of the same
# inputs (kernel against plain version, port against reference):
# * mean: fp32 sums in another order.  A dot product's rounding error
#   grows with the sum of its terms' magnitudes, so the rtol applies to
#   (1/S) sum_s sum_k |u_sk| |v_snk|, the same function of |inputs|;
# * std = sqrt(ex2 - mean^2): where the posterior spread is small
#   against the mean the difference cancels, and an error of d in ex2
#   moves std by up to sqrt(d).  With d about 1e-6 * ex2 (a few fp32
#   roundings of the sums) that is 1e-3 * sqrt(ex2);
# * ids: equal, except where the selected means of neighbouring slots
#   lie within the mean tolerance of each other (near-ties, which
#   another summation order may swap).  Exact ties agree.
TOPK_MEAN_RTOL = 1e-5
TOPK_STD_RTOL = 1e-3


def check_topk_score(got, want, us: torch.Tensor, v: torch.Tensor,
                     what: str = "topk_score"):
    """Hold ``got`` = (ids, mean, std) against ``want`` from the same
    inputs ``us`` (B, S, K) and ``v`` (S, N, K) within the tolerance
    above; raises AssertionError naming the slots that disagree and
    returns (max |mean diff|, max |std diff|) over the valid slots."""
    ids, mean, std = (torch.as_tensor(x).to(v.device) for x in got)
    wids, wmean, wstd = (torch.as_tensor(x).to(v.device) for x in want)
    valid = wids >= 0
    if not torch.equal(ids >= 0, valid):
        raise AssertionError(f"{what}: the -1 slots differ")
    S = v.shape[0]
    B, k = wids.shape
    safe = wids.clamp_min(0).long().reshape(-1)
    vr = v.index_select(1, safe).abs().reshape(S, B, k, -1)
    scale = torch.einsum("bsk,sbrk->br", us.abs().to(v.dtype), vr) / S
    mtol = TOPK_MEAN_RTOL * scale
    stol = TOPK_STD_RTOL * torch.sqrt(wmean * wmean + wstd * wstd)
    zero = torch.zeros_like(wmean)
    dm = torch.where(valid, (mean - wmean).abs(), zero)
    ds = torch.where(valid, (std - wstd).abs(), zero)
    pair_tol = torch.maximum(mtol[:, 1:], mtol[:, :-1])
    gap = (wmean[:, 1:] - wmean[:, :-1]).abs() <= pair_tol
    no = torch.zeros((B, 1), dtype=torch.bool, device=v.device)
    # the last slot may tie with the first item left out
    near = torch.cat([no, gap], 1) | torch.cat([gap, ~no], 1)
    bad = {"mean": dm > mtol, "std": ds > stol,
           "ids": (ids != wids) & valid & ~near}
    for name, b in bad.items():
        if b.any():
            raise AssertionError(
                f"{what}: {name} disagrees at {int(b.sum())} of "
                f"{int(valid.sum())} slots (first at {b.nonzero()[0].tolist()}"
                f"); max |mean diff| {dm.max().item():.3e}, max |std diff| "
                f"{ds.max().item():.3e}; tolerance mean rtol "
                f"{TOPK_MEAN_RTOL} of sum |terms|, std "
                f"{TOPK_STD_RTOL} * sqrt(ex2)")
    return dm.max().item(), ds.max().item()
