"""Public kernel entry points, dispatched by the tensors' device.

The counterpart of ``gram_and_rhs``, ``sddmm``, ``topk_score`` and the
``flash`` kernel's entry in ``repro/kernels/ops.py``.  Where the reference chooses between the
Pallas kernel and the jnp oracle with a ``use_pallas`` flag, here the
device decides: a CUDA tensor launches the hand-written kernel (or the
wrapper raises), a CPU tensor runs the plain version of ``ref.py``.
There is no fallback from the kernel to the plain version.  The CUDA
kernels mask ragged edges themselves, so no padding happens here.  The
operands' dtypes pick the kernel's entry inside each wrapper: fp32, or
the bf16 copies of the reference's ``bf16_gather`` sweep (gram's
gathered entry, every sddmm entry, fp32 u against bf16 rows at probit's
padded slots, topk_score).  A bf16 CUDA tensor reaches a bf16 entry or
the wrapper raises; nothing is widened here to reach an fp32 kernel.

``KERNELS`` lists each kernel with its probe shapes: the ``ops.KERNELS``
envelope of the reference (gram's probes with their dtypes; fp32 probes
of sddmm and topk_score; flash's probes with their dtypes), and the
port's own ``sddmm_bf16`` and ``topk_score_bf16`` probes, the shapes of
sddmm's and topk_score's run in bf16 (the reference registers bf16
probes for gram and flash alone).  ``gathered_gram_and_rhs``,
``gathered_sddmm`` and ``gathered_sddmm_padded`` are the port's own
entries: the sweep's gather, Gram, alpha and Lambda_p in one launch,
and the predictions at gathered rows (or at every slot of a padded
layout) without the (E, K) copies; their probes are the port's own.
``flash_attention_fwd`` (the forward with its row log-sum-exp) and
``flash_attention_bwd`` are the attention gradient's entries, which
the reference computes outside any Pallas kernel; ``flash_bwd``'s
probes are flash's plus GQA groups of 3 at hd 64.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import flash as _flash
from . import flash_bwd as _flash_bwd
from . import gram as _gram
from . import ref
from . import sddmm as _sddmm
from . import topk_score as _topk


def gram_and_rhs(vg: torch.Tensor, val: torch.Tensor, mask: torch.Tensor):
    """Fused masked batched Gram; see kernels/gram.py."""
    if vg.is_cuda:
        return _gram.gram_cuda(vg.contiguous(), val.contiguous(),
                               mask.contiguous())
    return ref.gram_ref(vg, val, mask)


def gathered_gram_and_rhs(fixed: torch.Tensor, idx: torch.Tensor,
                          val: torch.Tensor, mask: torch.Tensor, alpha, *,
                          acc=None, lam=None):
    """The sweep's alpha-weighted Gram of gathered rows; see
    kernels/gram.py.

    fixed (n_fixed, K) fp32 or bf16, idx (R, T) int32, val and mask (R, T)
    fp32, alpha a 0-d tensor -> gram (R, K, K) = (alpha * g + acc[0]) + lam
    and rhs (R, K) = alpha * b + acc[1], where g and b are ``gram_and_rhs``
    of ``fixed[idx]``.  ``acc`` = (gram, rhs) is updated in place and
    returned; ``lam`` (K, K) is added at each place's own index.  On the
    card the kernel gathers in its loads; on the CPU the plain version
    gathers the (R, T, K) slab.
    """
    if fixed.is_cuda:
        return _gram.gathered_gram_cuda(
            fixed.contiguous(), idx.contiguous(), val.contiguous(),
            mask.contiguous(), alpha, acc=acc, lam=lam)
    return ref.gathered_gram_ref(fixed, idx, val, mask, alpha, acc=acc,
                                 lam=lam)


def sddmm(ug: torch.Tensor, vg: torch.Tensor) -> torch.Tensor:
    """Gathered-operand SDDMM; see kernels/sddmm.py."""
    if ug.is_cuda:
        return _sddmm.sddmm_cuda(ug.contiguous(), vg.contiguous())
    return ref.sddmm_ref(ug, vg)


def gathered_sddmm(U: torch.Tensor, V: torch.Tensor, i: torch.Tensor,
                   j: torch.Tensor) -> torch.Tensor:
    """pred (E,) with pred[e] = U[i[e]] . V[j[e]]; see kernels/sddmm.py.
    U (n_u, K), V (n_v, K) both fp32 or both bf16, i and j (E,) int32,
    pred fp32.  On the card one
    launch reads the rows in its loads; on the CPU the plain version
    gathers them."""
    if U.is_cuda:
        return _sddmm.sddmm_gathered_cuda(U.contiguous(), V.contiguous(),
                                          i.contiguous(), j.contiguous())
    return ref.gathered_sddmm_ref(U, V, i, j)


def gathered_sddmm_padded(u: torch.Tensor, fixed: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """pred (R, T) with pred[r, t] = u[r] . fixed[idx[r, t]], row r of u
    serving the T slots of idx[r]: ``gathered_sddmm`` at every slot of a
    padded layout, counted under ``sddmm_gathered`` (fp32 x fp32,
    bf16 x bf16 under ``sddmm_gathered_bf16``), or fp32 u against bf16
    fixed (the bf16 sweep's probit) under ``sddmm_padded_mixed``; see
    kernels/sddmm.py."""
    if u.is_cuda:
        return _sddmm.sddmm_padded_cuda(u.contiguous(), fixed.contiguous(),
                                        idx.contiguous())
    return ref.gathered_sddmm_padded_ref(u, fixed, idx)


def topk_score(us: torch.Tensor, v: torch.Tensor, k: int, *,
               exclude: Optional[torch.Tensor] = None):
    """Batched posterior scoring + top-K; see kernels/topk_score.py.

    us (B, S, K) user rows per sample, v (S, N, K) item factor stack
    (both fp32 or both bf16 on the card; the plain version widens any
    other pair, as the reference does), ``exclude`` (B, N) truthy =
    leave out of the ranking ->
    (ids (B, k') int32, mean (B, k') f32, std (B, k') f32) with
    k' = min(k, N).  Slots past the number of rankable (non-excluded)
    items of a row carry id -1 and NaN mean/std, on both paths.
    """
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    B, S, K = us.shape
    N = v.shape[1]
    k_eff = min(int(k), N)
    excl = exclusion_mask(exclude, B, N, us.device)
    if us.is_cuda:
        ids, mean, ex2 = _topk.topk_score_cuda(
            us.contiguous(), v.contiguous(), excl.contiguous(), k_eff)
    else:
        ids, mean, ex2 = ref.topk_score_ref(us, v, excl, k_eff)
    return finalize_topk(ids, mean, ex2, excl)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """GQA attention forward; see kernels/flash.py.

    q (B, Sq, H, hd), k (B, Sk, KVH, hd), v (B, Sk, KVH, hdv) -> (B, Sq,
    H, hdv) in q's dtype (hdv = hd but in MLA's prefill, 192 against
    128).  Query position ``q_offset + s``; causal ``kpos <= qpos``, and
    with a window ``kpos > qpos - window``; softmax scale 1/sqrt(hd); a
    row with no visible key is 0.
    """
    if q.is_cuda:
        return _flash.flash_cuda(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
    return ref.attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, window: int = 0, q_offset: int = 0):
    """``flash_attention`` that also returns each row's log-sum-exp:
    (out, lse (B, H, Sq) fp32, +inf for a row that sees no key), which
    ``flash_attention_bwd`` takes.  ``out`` is the same bits as
    ``flash_attention``'s.  Counted under ``flash``."""
    if q.is_cuda:
        return _flash.flash_cuda(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, return_lse=True)
    return ref.attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, return_lse=True)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool, window: int = 0,
                        q_offset: int = 0):
    """(dq, dk, dv) of attention from its inputs, the forward's ``out``
    and ``lse`` and dout; see kernels/flash_bwd.py.  q (B, Sq, H, hd), k
    (B, Sk, KVH, hd), v (B, Sk, KVH, hdv), out and dout (B, Sq, H, hdv):
    v may be narrower than q and k (MLA's prefill, 192 against 128).  On
    the card one call of the CUDA kernels on contiguous copies where an
    operand is not contiguous (autograd may hand a strided dout, and
    MLA's v is a view); a call the kernels do not take raises.  On the
    CPU ``ref.attention_bwd_ref``."""
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if q.is_cuda:
        return _flash_bwd.flash_bwd_cuda(
            *(x.contiguous() for x in (q, k, v, out, lse, dout)), **kw)
    return ref.attention_bwd_ref(q, k, v, out, lse, dout, **kw)


def exclusion_mask(exclude, B: int, N: int, device) -> torch.Tensor:
    """(B, N) float32, 1.0 where ``exclude`` is truthy (zeros for None);
    raises the reference's error on another shape."""
    if exclude is None:
        return torch.zeros((B, N), dtype=torch.float32, device=device)
    excl = torch.as_tensor(exclude, device=device)
    if tuple(excl.shape) != (B, N):
        raise ValueError(
            f"exclude shape {tuple(excl.shape)} != (B, N) = {(B, N)}")
    return (excl > 0).to(torch.float32)


def finalize_topk(ids, mean, ex2, excl):
    """(ids, mean, std) from a selection's (ids, mean, ex2): the std as
    sqrt(max(ex2 - mean^2, 0)), one (B, k) float program for the kernel
    and the plain version, and the slots past a row's count of rankable
    items as -1 / NaN."""
    std = torch.sqrt(torch.clamp_min(ex2 - mean * mean, 0.0))
    n_valid = torch.sum(excl <= 0, dim=1).to(torch.int32)      # (B,)
    slot = torch.arange(ids.shape[1], dtype=torch.int32, device=ids.device)
    bad = slot[None, :] >= n_valid[:, None]
    return (torch.where(bad, -1, ids), torch.where(bad, torch.nan, mean),
            torch.where(bad, torch.nan, std))


def launch_counts() -> Dict[str, int]:
    """Launches of each CUDA kernel since the last reset, the bf16
    entries apart: ``gram`` (the fp32 entries and the pre-gathered bf16
    one), ``gram_gathered_bf16``, ``sddmm`` / ``sddmm_bf16`` (pre-gathered),
    ``sddmm_gathered`` (the fp32 gathered and padded entries),
    ``sddmm_gathered_bf16``, ``sddmm_padded_bf16``, ``sddmm_padded_mixed``
    (fp32 u against bf16 rows), ``topk_score`` / ``topk_score_bf16``."""
    return {**_gram.launches, **_sddmm.launches, **_topk.launches,
            "flash": _flash.launches, "flash_bwd": _flash_bwd.launches}


def reset_launch_counts() -> None:
    for counts in (_gram.launches, _sddmm.launches, _topk.launches,
                   _flash.design_launches, _flash_bwd.design_launches):
        counts.update(dict.fromkeys(counts, 0))
    _flash.launches = 0
    _flash_bwd.launches = 0


# probe shapes of the reference's ops.KERNELS envelope (and of the
# port's sddmm_gathered entry): the operands' shapes; for gram the
# (R, T, K) shape and the dtype of all three operands; for topk_score k;
# for flash the q and k/v shapes, the dtype and the masking arguments
KERNELS = {
    "gram": {"production r64 t256 K128": ((64, 256, 128), torch.float32),
             "uneven tail r13 t257 K33": ((13, 257, 33), torch.float32),
             "bf16 gathered operands": ((16, 130, 32), torch.bfloat16)},
    "sddmm": {"production e4096 K128": (4096, 128),
              "uneven tail e1025 K200": (1025, 200)},
    # the port's fused-gather entry: (E, K, rows of U, rows of V, run
    # lengths of i); runs None: i drawn at random (the tail gathers
    # 1,025 entries from 97 and 61 rows, so rows repeat); 64: i sorted
    # in runs of 64, as a row-major COO with 64 entries a row; a tuple:
    # run lengths drawn from that range, so that runs end inside the
    # kernel's 32-entry tiles and cross from one warp's tiles to the
    # next's
    "sddmm_gathered": {
        "production e4096 K128": (4096, 128, 4096, 4096, None),
        "uneven tail e1025 K200, repeated indices": (1025, 200, 97, 61,
                                                     None),
        "sorted runs of 64 e4096 K128": (4096, 128, 64, 4096, 64),
        "uneven runs 1-70 e4096 K33": (4096, 33, 4096, 300, (1, 70))},
    "topk_score": {
        "serving b8 s32 n4096 K32 k100": ((8, 32, 32), (32, 4096, 32), 100),
        "catalogue b4 s64 n2048 K64 k100": ((4, 64, 64), (64, 2048, 64),
                                            100),
        "uneven tail + exclusions b3 s8 n130 k7": ((3, 8, 16), (8, 130, 16),
                                                   7)},
    "flash": {
        "causal GQA b2 s256 h4/2 hd128": (
            (2, 256, 4, 128), (2, 256, 2, 128), torch.float32,
            dict(causal=True)),
        "windowed decode offset s64 vs 256": (
            (1, 64, 4, 16), (1, 256, 2, 16), torch.float32,
            dict(causal=True, window=128, q_offset=192)),
        "noncausal bf16 uneven s130": (
            (1, 130, 2, 8), (1, 130, 1, 8), torch.bfloat16,
            dict(causal=False))},
}
# the port's own bf16 probes: sddmm's and topk_score's shapes in bf16
KERNELS["sddmm_bf16"] = {f"{label} bf16": shape
                         for label, shape in KERNELS["sddmm"].items()}
KERNELS["topk_score_bf16"] = {f"{label} bf16": probe for label, probe
                              in KERNELS["topk_score"].items()}
# the backward's: flash's probes, then GQA groups of 3 at hd 64 (the LM
# path's widths), causal from 0 and windowed from an offset
KERNELS["flash_bwd"] = {
    **KERNELS["flash"],
    "causal GQA3 b2 s200 h9/3 hd64 bf16": (
        (2, 200, 9, 64), (2, 200, 3, 64), torch.bfloat16,
        dict(causal=True)),
    "windowed offset GQA3 s100 vs 300 hd64 bf16": (
        (1, 100, 6, 64), (1, 300, 2, 64), torch.bfloat16,
        dict(causal=True, window=80, q_offset=200))}


def gathered_sddmm_probe(E: int, K: int, n_u: int, n_v: int, runs, device,
                         seed: int = 0):
    """The operands (U, V, i, j) of a ``KERNELS["sddmm_gathered"]``
    probe: N(0, 1) factors, j uniform over V's rows, i uniform over U's
    rows (``runs`` None) or sorted in runs of distinct rows whose
    lengths are ``runs`` (an int) or drawn from the range ``runs`` (a
    (lo, hi) pair, both included).  Drawn by torch's CPU generator from
    ``seed``, then moved to ``device``."""
    g = torch.Generator().manual_seed(seed)
    U = torch.randn(n_u, K, generator=g)
    V = torch.randn(n_v, K, generator=g)
    j = torch.randint(0, n_v, (E,), generator=g, dtype=torch.int32)
    if runs is None:
        i = torch.randint(0, n_u, (E,), generator=g, dtype=torch.int32)
    else:
        lo, hi = (runs, runs) if isinstance(runs, int) else runs
        lengths = torch.randint(lo, hi + 1, (E // max(lo, 1) + 1,),
                                generator=g)
        n_runs = int((lengths.cumsum(0) < E).sum()) + 1
        if n_runs > n_u:
            raise ValueError(f"{n_runs} runs need distinct rows of U, "
                             f"which has {n_u}")
        rows = torch.randperm(n_u, generator=g)[:n_runs].sort().values
        i = rows.repeat_interleave(lengths[:n_runs])[:E].to(torch.int32)
    return tuple(x.to(device) for x in (U, V, i, j))
