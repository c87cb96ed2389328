"""Launch wrapper of the hand-written CUDA SDDMM kernel.

The kernel (``csrc/sddmm.cu``) replaces the Pallas-TPU kernel
``repro/kernels/sddmm.py::sddmm_pallas``; its header says what bounds it
on the card and how the design answers that.  Its plain version is
``ref.sddmm_ref``.  It is CUDA rather than Triton so that one build
path serves both kernels of the slice.  ``launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import torch

from . import _build

launches = 0


def sddmm_cuda(ug: torch.Tensor, vg: torch.Tensor) -> torch.Tensor:
    """pred (E,) = rowwise dot of fp32 contiguous CUDA tensors ug and
    vg (E, K).  Raises on anything the kernel does not take."""
    global launches
    for name, x in (("ug", ug), ("vg", vg)):
        if not x.is_cuda:
            raise ValueError(f"sddmm_cuda: {name} is not a CUDA tensor")
        if x.dtype != torch.float32:
            raise TypeError(f"sddmm_cuda: {name} is {x.dtype}; the kernel "
                            "takes float32 (bf16 is not ported yet)")
        if not x.is_contiguous():
            raise ValueError(f"sddmm_cuda: {name} is not contiguous")
    if ug.shape != vg.shape or ug.dim() != 2:
        raise ValueError(f"sddmm_cuda: ug {tuple(ug.shape)} and vg "
                         f"{tuple(vg.shape)} must both be (E, K)")
    if ug.device != vg.device:
        raise ValueError("sddmm_cuda: operands on different devices")
    E, K = ug.shape
    fn = _build.load("sddmm").sddmm_f32
    out = torch.empty((E,), dtype=torch.float32, device=ug.device)
    vec = int(K % 4 == 0 and ug.data_ptr() % 16 == 0
              and vg.data_ptr() % 16 == 0)
    with torch.cuda.device(ug.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ug.data_ptr(), vg.data_ptr(), out.data_ptr(), E, K, vec,
                 stream)
    _build.check(err, "sddmm_f32")
    launches += 1
    return out
