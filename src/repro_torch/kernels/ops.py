"""Public kernel entry points, dispatched by the tensors' device.

The counterpart of ``gram_and_rhs``, ``sddmm`` and ``topk_score`` in
``repro/kernels/ops.py``.  Where the reference chooses between the
Pallas kernel and the jnp oracle with a ``use_pallas`` flag, here the
device decides: a CUDA tensor launches the hand-written kernel (or the
wrapper raises), a CPU tensor runs the plain version of ``ref.py``.
There is no fallback from the kernel to the plain version.  The CUDA
kernels mask ragged edges themselves, so no padding happens here.

``KERNELS`` lists each kernel with its probe shapes: the ``ops.KERNELS``
envelope of the reference (fp32 probes; bf16 is a later slice).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

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


def sddmm(ug: torch.Tensor, vg: torch.Tensor) -> torch.Tensor:
    """Gathered-operand SDDMM; see kernels/sddmm.py."""
    if ug.is_cuda:
        return _sddmm.sddmm_cuda(ug.contiguous(), vg.contiguous())
    return ref.sddmm_ref(ug, vg)


def topk_score(us: torch.Tensor, v: torch.Tensor, k: int, *,
               exclude: Optional[torch.Tensor] = None):
    """Batched posterior scoring + top-K; see kernels/topk_score.py.

    us (B, S, K) user rows per sample, v (S, N, K) item factor stack,
    ``exclude`` (B, N) truthy = leave out of the ranking ->
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
    """Launches of each CUDA kernel since the last reset."""
    return {"gram": _gram.launches, "sddmm": _sddmm.launches,
            "topk_score": _topk.launches}


def reset_launch_counts() -> None:
    _gram.launches = 0
    _sddmm.launches = 0
    _topk.launches = 0


# probe shapes of the reference's ops.KERNELS envelope, fp32: the
# operands' shapes and, for topk_score, k
KERNELS = {
    "gram": {"production r64 t256 K128": (64, 256, 128),
             "uneven tail r13 t257 K33": (13, 257, 33)},
    "sddmm": {"production e4096 K128": (4096, 128),
              "uneven tail e1025 K200": (1025, 200)},
    "topk_score": {
        "serving b8 s32 n4096 K32 k100": ((8, 32, 32), (32, 4096, 32), 100),
        "catalogue b4 s64 n2048 K64 k100": ((4, 64, 64), (64, 2048, 64),
                                            100),
        "uneven tail + exclusions b3 s8 n130 k7": ((3, 8, 16), (8, 130, 16),
                                                   7)},
}
