"""Plain PyTorch versions of the kernels, accumulating in fp32.

The counterpart of ``gram_ref``, ``sddmm_ref``, ``topk_score_ref`` and
``attention_ref`` in ``repro/kernels/ref.py``.  ``kernels/ops.py`` runs these on CPU
tensors, the CPU tests hold them against the JAX package, and
``chip_smoke.py`` holds the CUDA kernels against them on the card.
``gathered_gram_ref``, ``gathered_sddmm_ref`` and
``gathered_sddmm_padded_ref`` are the plain versions of the port's own
fused entries, and ``attention_bwd_ref`` that of the attention
backward (``flash_bwd.py``), which has no Pallas kernel in the
reference.  Each keeps the reference's bf16 branch, the operands of its
``bf16_gather`` sweep: ``gram_ref`` rounds the masked rows and
``val * mask`` to bf16; ``sddmm_ref`` and ``topk_score_ref`` take bf16 x
bf16, whose products are exact in fp32, with fp32 sums; a bf16 operand
against an fp32 one is the fp32 product JAX's promotion gives.
"""
from __future__ import annotations

import math

import torch


def gram_ref(vg: torch.Tensor, val: torch.Tensor, mask: torch.Tensor):
    """Masked batched Gram + rhs -- the SMURFF per-row hot loop.

    For each row r (paper Algorithm 1 inner loop):
        gram[r] = sum_t mask[r,t] * vg[r,t,:] vg[r,t,:]^T     (K x K)
        rhs[r]  = sum_t mask[r,t] * val[r,t] * vg[r,t,:]      (K,)

    vg (R, T, K), val (R, T), mask (R, T) -> gram (R, K, K), rhs (R, K).

    bf16 ``vg`` (the reference's ``bf16_gather`` operands) runs the
    reference's bf16 program: the mask and ``val * mask`` in bf16, the
    masked operand ``vg * m`` rounded to bf16, the products and sums in
    fp32 (exact widening of the bf16 operands).
    """
    if vg.dtype == torch.bfloat16:
        m = mask.to(torch.bfloat16)
        w = (val * mask).to(torch.bfloat16)
        gram = torch.einsum("rtk,rtl->rkl", (vg * m[..., None]).float(),
                            vg.float())
        rhs = torch.einsum("rtk,rt->rk", vg.float(), w.float())
        return gram, rhs
    vg = vg.to(torch.float32)
    w = (val * mask).to(torch.float32)
    m = mask.to(torch.float32)
    gram = torch.einsum("rtk,rtl->rkl", vg * m[..., None], vg)
    rhs = torch.einsum("rtk,rt->rk", vg, w)
    return gram, rhs


def gathered_gram_ref(fixed: torch.Tensor, idx: torch.Tensor,
                      val: torch.Tensor, mask: torch.Tensor, alpha, *,
                      acc=None, lam=None):
    """The sweep's alpha-weighted Gram of gathered rows, in the float
    program of separate ops: ``fixed.index_select`` over ``idx`` (the (R, T,
    K) slab), ``gram_ref``, ``* alpha``, then ``acc + x`` and ``x + lam``,
    each rounded apart.  A bf16 ``fixed`` (the ``bf16_gather`` sweep's copy)
    gathers a bf16 slab and takes ``gram_ref``'s bf16 program, which rounds
    ``val * mask`` to bf16 before the rhs product; alpha, acc and lam stay
    fp32.  ``acc`` = (gram, rhs) is updated in place and returned.  An idx
    outside [0, n_fixed) raises here (the kernel reads zeros there)."""
    R, T = idx.shape
    vg = fixed.index_select(0, idx.reshape(-1)).reshape(R, T,
                                                         fixed.shape[1])
    gram, rhs = gram_ref(vg, val, mask)
    del vg
    gram.mul_(alpha)
    rhs.mul_(alpha)
    if acc is not None:
        gram = acc[0].add_(gram)
        rhs = acc[1].add_(rhs)
    if lam is not None:
        gram.add_(lam)
    return gram, rhs


def sddmm_ref(ug: torch.Tensor, vg: torch.Tensor) -> torch.Tensor:
    """Gathered-operand SDDMM: pred[e] = ug[e] . vg[e] -> (E,) fp32.

    Both of the reference's branches are one program here: bf16 x bf16
    (``einsum`` with ``preferred_element_type=float32``) widens each
    operand exactly, so every product is exact in fp32 and the sum is
    fp32; any other pair is cast to fp32 first (a bf16 operand against
    an fp32 one: JAX's promotion)."""
    return torch.einsum("ek,ek->e", ug.to(torch.float32),
                        vg.to(torch.float32))


def gathered_sddmm_ref(U: torch.Tensor, V: torch.Tensor, i: torch.Tensor,
                       j: torch.Tensor) -> torch.Tensor:
    """SDDMM over gathered rows: pred[e] = U[i[e]] . V[j[e]], in the float
    program of the pipeline the fused entry replaces (``index_select`` of
    both operands, then ``sddmm_ref``)."""
    return sddmm_ref(U.index_select(0, i), V.index_select(0, j))


def slot_rows(R: int, T: int, device) -> torch.Tensor:
    """(R * T,) int32: the row of each slot of a (R, T) padded layout."""
    return torch.arange(R, dtype=torch.int32,
                        device=device).repeat_interleave(T)


def gathered_sddmm_padded_ref(u: torch.Tensor, fixed: torch.Tensor,
                              idx: torch.Tensor) -> torch.Tensor:
    """pred (R, T) with pred[r, t] = u[r] . fixed[idx[r, t]]: the
    gathered SDDMM at every slot of a padded layout, over the vector of
    slot rows.  fp32 ``u`` against a bf16 ``fixed`` (probit in the
    ``bf16_gather`` sweep) is the fp32 product of the widened rows, as
    the reference's ``einsum`` promotes it."""
    R, T = idx.shape
    return gathered_sddmm_ref(u, fixed, slot_rows(R, T, idx.device),
                              idx.reshape(-1)).reshape(R, T)


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
    finalized by ``ops.topk_score``.  us and v both bf16 are the
    reference's bf16 branch, one program with the fp32 one here: the
    scores are products of bf16 values, exact in fp32, summed in fp32
    (``preferred_element_type``), so the operands are widened exactly;
    any other pair is cast to fp32 first, as the reference does.
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
#   another summation order may swap).  Exact ties agree.  The std is
#   held item for item (by id), so a swapped near-tie compares each
#   item's std with its own.
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
    # std item for item: a near-tie may hold two items in the other order
    # on the two sides (the ids rule below), and then the slot holds
    # another item's std; an item that only one side selected (the last
    # slot against the first item left out) has no std to compare
    gids, order = torch.sort(ids.long(), dim=1)
    at = torch.searchsorted(gids, wids.long().contiguous()).clamp_max(k - 1)
    same = valid & (gids.gather(1, at) == wids.long())
    ds = torch.where(same, (std.gather(1, order.gather(1, at)) - wstd).abs(),
                     zero)
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


def _scores(q, k, causal, window, q_offset, inplace=True):
    """The fp32 scaled scores (B, H, Sq, Sk) of q and GQA-repeated k,
    -inf where the mask hides a key (updated out of place when
    ``inplace`` is False, for ``attention_ref``'s autograd witness: the
    same values)."""
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    kf = torch.repeat_interleave(k.to(torch.float32), H // KVH, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), kf)
    root = torch.sqrt(torch.tensor(hd, dtype=torch.float32))
    s = s.div_(root) if inplace else s / root
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Sk, device=q.device)[None, :]
        ok = kpos <= qpos
        if window > 0:
            ok &= kpos > qpos - window
        s = s.masked_fill_(~ok, -torch.inf) if inplace \
            else s.masked_fill(~ok, -torch.inf)
    return s


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  q_offset: int = 0, return_lse: bool = False):
    """Plain-softmax attention, the plain version of the flash kernel.

    Materialises the full (Sq, Sk) fp32 score matrix -- exactly what the
    kernel exists to avoid -- and masks by position: query position
    ``q_offset + row``, causal ``kpos <= qpos``, and with a window also
    ``kpos > qpos - window`` (the window applies to causal attention
    only, as in the reference).  GQA (H a multiple of KVH) repeats each
    kv head over its G query heads.  Rows with every key masked return
    0, as the kernel's ``l == 0`` guard does.  The score matrix is
    updated in place, so one (B, H, Sq, Sk) fp32 buffer is the peak.
    Where autograd records the call (an operand that requires grad) the
    same operations run out of place, with the same values; no path of
    the package records it (the attention Function calls this with
    autograd off), so that branch serves only the tests that hold
    ``attention_bwd_ref`` against ``torch.autograd.grad`` through it.

    q (B, Sq, H, hd), k (B, Sk, KVH, hd), v (B, Sk, KVH, hdv) -> (B, Sq,
    H, hdv) in q's dtype, scale 1/sqrt(hd) (MLA's prefill: hd = nope +
    rope against a narrower hdv);
    with ``return_lse`` also each row's log-sum-exp m + log(l) of the
    scaled scores, (B, H, Sq) fp32, +inf where l == 0 (the backward's
    exp(s - lse) is then 0).
    """
    H, KVH = q.shape[2], k.shape[2]
    vf = torch.repeat_interleave(v.to(torch.float32), H // KVH, dim=2)
    inplace = not (torch.is_grad_enabled()
                   and any(x.requires_grad for x in (q, k, v)))
    s = _scores(q, k, causal, window, q_offset, inplace)
    m = torch.amax(s, dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    s = s.sub_(m).exp_() if inplace else (s - m).exp()
    l = torch.sum(s, dim=-1, keepdim=True)
    s = s.div_(torch.where(l == 0.0, 1.0, l)) if inplace \
        else s / torch.where(l == 0.0, 1.0, l)
    out = torch.einsum("bhqk,bkhd->bqhd", s, vf).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l == 0.0, torch.inf, m + torch.log(l))
    return out, lse[..., 0]


# The stated tolerance of the flash kernel against ``attention_ref`` on
# the same inputs: |kernel - plain| <= rtol * (|plain| + sum_k p|v|),
# sum_k p|v| = attention_ref(q, k, |v|), the magnitude of an output's
# terms.
# * fp32: the scores are summed in another order and the kernel takes
#   exp2 of log2-scaled scores; each p moves by a few 1e-7 relative.
#   rtol 1e-5;
# * bf16: the q.k products are exact in the tensor cores (fp32
#   accumulation), but the kernel rounds p to bf16 for the tensor-core
#   P.V (at most 2^-9 of sum_k p|v|; the denominator sums the fp32 p),
#   and both sides round the output to bf16 (2^-9 of |out| each).
#   rtol 2^-8 covers the three roundings and leaves 2^-9 of the terms'
#   magnitude for the fp32 sums.
FLASH_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8}


def check_attention(got: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, *, causal: bool, window: int = 0,
                    q_offset: int = 0, what: str = "flash") -> float:
    """Hold ``got`` against ``attention_ref`` of the same inputs within
    ``FLASH_RTOL``; raises AssertionError with the worst element and
    returns the max |got - plain|."""
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = attention_ref(q, k, v, **kw).to(torch.float32)
    mag = attention_ref(q.to(torch.float32), k.to(torch.float32),
                        v.to(torch.float32).abs(), **kw)
    got = got.to(torch.float32)
    rtol = FLASH_RTOL[q.dtype]
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: output is not finite")
    diff = (got - want).abs()
    bad = diff > rtol * (want.abs() + mag)
    if bad.any():
        i = bad.nonzero()[0].tolist()
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {bad.numel()} elements disagree "
            f"with the plain version, first at {i}: got "
            f"{got[tuple(i)].item():.6e}, plain {want[tuple(i)].item():.6e}"
            f"; max |diff| {diff.max().item():.3e}; tolerance rtol {rtol} "
            "of |plain| + sum p|v| (kernels/ref.py states why)")
    return diff.max().item()


def _attention_bwd(q, k, v, out, lse, dout, causal, window, q_offset,
                   magnitude=False):
    """One batch row of the backward in fp32 (see attention_bwd_ref);
    with ``magnitude``, the same sums over the terms' magnitudes:
    |q|, |k|, |v|, |out|, |dout| in, and dS = P (dP + D) / sqrt(hd), so
    that each output is the sum of |terms| of the true one."""
    B, Sq, H, hd = q.shape
    KVH, hdv = k.shape[2], v.shape[-1]
    G = H // KVH
    f32 = [x.to(torch.float32) for x in (q, k, v, out, dout)]
    if magnitude:
        f32 = [x.abs() for x in f32]
    qf, kf, vf, of, gf = f32
    kf, vf = (torch.repeat_interleave(x, G, dim=2) for x in (kf, vf))
    p = _scores(q, k, causal, window, q_offset)         # the true scores
    p.sub_(lse[..., None]).exp_()                       # 0 where masked
    D = torch.einsum("bqhd,bqhd->bhq", gf, of)
    ds = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    if magnitude:
        ds.add_(D[..., None])
    else:
        ds.sub_(D[..., None])
    ds.mul_(p).mul_(1.0 / math.sqrt(hd))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    Sk = k.shape[1]
    dk = dk.reshape(B, Sk, KVH, G, hd).sum(3)
    dv = dv.reshape(B, Sk, KVH, G, hdv).sum(3)
    return dq, dk, dv


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, lse: torch.Tensor,
                      dout: torch.Tensor, *, causal: bool = True,
                      window: int = 0, q_offset: int = 0):
    """Plain attention backward, the plain version of the flash_bwd
    kernel (the reference's counterpart is the jnp custom_vjp
    ``layers._flash_vjp_bwd``).

    Materialises, batch row by batch row, the fp32 P = exp(s - lse) of
    the masked scaled scores (0 where masked or where lse is +inf), then
    D = rowsum(dout . out), dS = P (dP - D) / sqrt(hd) with
    dP = dout v^T, dq = dS k, dk = dS^T q and dv = P^T dout, summing dk
    and dv over each kv head's G query heads.  Two (H, Sq, Sk) fp32
    buffers a batch row are the peak.

    q (B, Sq, H, hd), k (B, Sk, KVH, hd), v (B, Sk, KVH, hdv), out and
    dout (B, Sq, H, hdv), lse (B, H, Sq) fp32 (``attention_ref(...,
    return_lse=True)``'s) -> (dq, dk, dv) in the dtypes and shapes of q,
    k and v.  hdv = hd but in MLA's prefill (q/k 192 against v 128); the
    scale is 1/sqrt(hd), q and k's width.
    """
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    parts = [_attention_bwd(*(x[b:b + 1] for x in (q, k, v, out, lse,
                                                   dout)), **kw)
             for b in range(q.shape[0])]
    return tuple(torch.cat([p[i] for p in parts]).to(x.dtype)
                 for i, x in enumerate((q, k, v)))


def attention_bwd_magnitude(q, k, v, out, lse, dout, *, causal: bool = True,
                            window: int = 0, q_offset: int = 0):
    """(dq, dk, dv)-shaped fp32 sums of the magnitudes of each output's
    terms: ``attention_bwd_ref``'s sums over |q|, |k|, |v|, |out|,
    |dout| with dS = P (|dP| + |D|) / sqrt(hd), P of the true scores."""
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    return tuple(torch.cat(parts) for parts in zip(*(
        _attention_bwd(*(x[b:b + 1] for x in (q, k, v, out, lse, dout)),
                       **kw, magnitude=True)
        for b in range(q.shape[0]))))


# The stated tolerance of the kernels' row log-sum-exp against
# ``attention_ref``'s: both take the max and the sum of exp in fp32, the
# kernels in log2 units (scores times log2(e) / sqrt(hd), then ex2 and
# log2), so the exponent moves by a few fp32 roundings of |lse|-sized
# values (2^-24 each) and log(l) by the sum's 1e-6 relative error:
# |kernel - plain| <= 1e-5 (1 + |plain|), and +inf exactly where the
# plain version's row sees no key.
LSE_RTOL = 1e-5


def check_lse(got: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, *, causal: bool, window: int = 0,
              q_offset: int = 0, what: str = "flash lse") -> float:
    """Hold a kernel's ``lse`` against ``attention_ref``'s within
    ``LSE_RTOL``; returns the max |got - plain| over the finite rows."""
    _, want = attention_ref(q, k, v, causal=causal, window=window,
                            q_offset=q_offset, return_lse=True)
    inf = torch.isinf(want)
    if not torch.equal(torch.isinf(got), inf) or (got[inf] < 0).any():
        raise AssertionError(f"{what}: the +inf rows differ from the plain "
                             "version's")
    g, w = got[~inf], want[~inf]
    diff = (g - w).abs()
    if not torch.isfinite(g).all() or (
            diff > LSE_RTOL * (1 + w.abs())).any():
        raise AssertionError(
            f"{what}: disagrees with the plain version, max |diff| "
            f"{diff.max().item():.3e}, tolerance {LSE_RTOL} (1 + |lse|)")
    return diff.max().item() if diff.numel() else 0.0


# The stated tolerance of the flash_bwd kernel against
# ``attention_bwd_ref`` on the same inputs, output by output:
# |kernel - plain| <= rtol * (|plain| + m), m the sum of the output's
# terms' magnitudes (``attention_bwd_ref`` over |inputs|, with
# dS = P (|dP| + |D|) / sqrt(hd); ``check_attention_bwd``).
# * fp32: two fp32 sums in sequence (dP and D over hd, then dq over the
#   keys or dk, dv over the rows) in another order, and P through exp2
#   of log2-scaled scores (a few 1e-7 relative).  rtol 2e-5;
# * bf16: the kernel rounds P to bf16 for dV = P^T dout and dS to bf16
#   for dq = dS k and dk = dS^T q (2^-9 of the terms' magnitude each),
#   and both sides round the output to bf16 (2^-9 of |out| each); the
#   products are exact in the tensor cores with fp32 sums.  rtol 2^-8,
#   as the forward's.
FLASH_BWD_RTOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -8}


def check_attention_bwd(got, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor, *,
                        causal: bool, window: int = 0, q_offset: int = 0,
                        what: str = "flash_bwd") -> float:
    """Hold ``got`` = (dq, dk, dv) against ``attention_bwd_ref`` of the
    same inputs within ``FLASH_BWD_RTOL``; raises AssertionError naming
    the output and its worst element, returns the max |got - plain|."""
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    mags = attention_bwd_magnitude(q, k, v, out, lse, dout, **kw)
    return check_bwd_close(got, want, mags, q.dtype, what=what)


def check_bwd_close(got, want, mags, dtype: torch.dtype,
                    what: str = "flash_bwd") -> float:
    """Hold ``got`` = (dq, dk, dv) against ``want`` within
    ``FLASH_BWD_RTOL[dtype]`` of |want| + ``mags`` (the terms'
    magnitudes, ``attention_bwd_magnitude``): ``check_attention_bwd``
    with the plain version as ``want``, or one design against another;
    raises AssertionError naming the output and its worst element,
    returns the max |got - want|."""
    rtol = FLASH_BWD_RTOL[dtype]
    worst = 0.0
    for name, g, w, m in zip(("dq", "dk", "dv"), got, want, mags):
        g, w = g.to(torch.float32), w.to(torch.float32)
        if tuple(g.shape) != tuple(w.shape):
            raise AssertionError(f"{what}: {name} {tuple(g.shape)}, want "
                                 f"{tuple(w.shape)}")
        if not torch.isfinite(g).all():
            raise AssertionError(f"{what}: {name} is not finite")
        diff = (g - w).abs()
        bad = diff > rtol * (w.abs() + m)
        if bad.any():
            i = tuple(bad.nonzero()[0].tolist())
            raise AssertionError(
                f"{what}: {name} is outside the tolerance at "
                f"{int(bad.sum())} of {bad.numel()} elements, first at "
                f"{list(i)}: got {g[i].item():.6e}, want {w[i].item():.6e}"
                f", magnitude {m[i].item():.3e}; max |diff| "
                f"{diff.max().item():.3e}; tolerance rtol {rtol} of "
                "|want| + sum |terms| (kernels/ref.py states why)")
        worst = max(worst, diff.max().item() if diff.numel() else 0.0)
    return worst
