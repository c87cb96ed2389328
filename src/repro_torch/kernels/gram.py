"""Launch wrapper of the hand-written CUDA masked-Gram kernel.

The kernel (``csrc/gram.cu``) replaces the Pallas-TPU kernel
``repro/kernels/gram.py::gram_pallas``; its header says what bounds it
on the card and how the design answers that.  Its plain version is
``ref.gram_ref``.  ``launches`` counts the kernel's launches, so a run
can show that its main path went through the kernel: one per call for
K <= 128, two above (``gram_f32`` starts the tiles on the diagonal,
then those below it).
"""
from __future__ import annotations

import torch

from . import _build

launches = 0
TILE = 128  # output tile edge of csrc/gram.cu


def gram_cuda(vg: torch.Tensor, val: torch.Tensor, mask: torch.Tensor):
    """gram (R, K, K), rhs (R, K) of fp32 CUDA tensors vg (R, T, K),
    val (R, T), mask (R, T), all contiguous.  Raises on anything the
    kernel does not take (bf16 operands are a later slice)."""
    global launches
    for name, x in (("vg", vg), ("val", val), ("mask", mask)):
        if not x.is_cuda:
            raise ValueError(f"gram_cuda: {name} is not a CUDA tensor")
        if x.dtype != torch.float32:
            raise TypeError(f"gram_cuda: {name} is {x.dtype}; the kernel "
                            "takes float32 (bf16 is not ported yet)")
        if not x.is_contiguous():
            raise ValueError(f"gram_cuda: {name} is not contiguous")
    R, T, K = vg.shape
    if val.shape != (R, T) or mask.shape != (R, T):
        raise ValueError(f"gram_cuda: val {tuple(val.shape)} and mask "
                         f"{tuple(mask.shape)} must be {(R, T)}")
    if not (vg.device == val.device == mask.device):
        raise ValueError("gram_cuda: operands on different devices")
    fn = _build.load("gram").gram_f32
    gram = torch.empty((R, K, K), dtype=torch.float32, device=vg.device)
    rhs = torch.empty((R, K), dtype=torch.float32, device=vg.device)
    vec = int(K % 4 == 0 and vg.data_ptr() % 16 == 0)
    with torch.cuda.device(vg.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(vg.data_ptr(), val.data_ptr(), mask.data_ptr(),
                 gram.data_ptr(), rhs.data_ptr(), R, T, K, vec, stream)
    _build.check(err, "gram_f32")
    launches += 1 if K <= TILE else 2
    return gram, rhs
