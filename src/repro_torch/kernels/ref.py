"""Plain PyTorch versions of the kernels, in fp32.

The counterpart of ``gram_ref`` and ``sddmm_ref`` in
``repro/kernels/ref.py``.  ``kernels/ops.py`` runs these on CPU
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
