"""Launch wrappers of the hand-written CUDA SDDMM kernel.

The kernel (``csrc/sddmm.cu``) replaces the Pallas-TPU kernel
``repro/kernels/sddmm.py::sddmm_pallas``; its header says what bounds it
on the card and how the design answers that.  It has two entries:

* ``sddmm_cuda(ug, vg)``: the reference's, on gathered (E, K) operands;
  plain version ``ref.sddmm_ref``;
* ``sddmm_gathered_cuda(U, V, i, j)``: the sweep's, which reads the rows
  ``U[i[e]]`` and ``V[j[e]]`` in its loads and gives bitwise what
  ``sddmm_cuda`` gives on ``U.index_select(0, i)`` and
  ``V.index_select(0, j)``; plain version ``ref.gathered_sddmm_ref``.

It is CUDA rather than Triton so that one build path serves every
kernel of the sweep.  ``launches`` and ``gathered_launches`` count each
entry's launches.
"""
from __future__ import annotations

import torch

from . import _build

launches = 0
gathered_launches = 0


def _check_f32(name: str, x: torch.Tensor, what: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{what}: {name} is not a CUDA tensor")
    if x.dtype != torch.float32:
        raise TypeError(f"{what}: {name} is {x.dtype}; the kernel "
                        "takes float32 (bf16 is not ported yet)")
    if not x.is_contiguous():
        raise ValueError(f"{what}: {name} is not contiguous")


def sddmm_cuda(ug: torch.Tensor, vg: torch.Tensor) -> torch.Tensor:
    """pred (E,) = rowwise dot of fp32 contiguous CUDA tensors ug and
    vg (E, K).  Raises on anything the kernel does not take."""
    global launches
    for name, x in (("ug", ug), ("vg", vg)):
        _check_f32(name, x, "sddmm_cuda")
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


def sddmm_gathered_cuda(U: torch.Tensor, V: torch.Tensor, i: torch.Tensor,
                        j: torch.Tensor) -> torch.Tensor:
    """pred (E,) with pred[e] = U[i[e]] . V[j[e]]: U (n_u, K) and V
    (n_v, K) fp32 contiguous CUDA tensors that start on a 16-byte
    boundary, i and j (E,) int32 contiguous on the same device.  An index outside its factor's rows reads a zero
    row.  Raises on anything the kernel does not take."""
    global gathered_launches
    what = "sddmm_gathered_cuda"
    for name, x in (("U", U), ("V", V)):
        _check_f32(name, x, what)
        if x.dim() != 2:
            raise ValueError(f"{what}: {name} {tuple(x.shape)} is not "
                             "(rows, K)")
    if U.shape[1] != V.shape[1]:
        raise ValueError(f"{what}: U {tuple(U.shape)} and V "
                         f"{tuple(V.shape)} differ in K")
    for name, x in (("i", i), ("j", j)):
        if not x.is_cuda:
            raise ValueError(f"{what}: {name} is not a CUDA tensor")
        if x.dtype != torch.int32:
            raise TypeError(f"{what}: {name} is {x.dtype}; the kernel "
                            "takes int32 indices")
        if x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous (E,) "
                             "vector")
    if i.shape != j.shape:
        raise ValueError(f"{what}: i {tuple(i.shape)} and j "
                         f"{tuple(j.shape)} differ")
    if len({U.device, V.device, i.device, j.device}) != 1:
        raise ValueError(f"{what}: operands on different devices")
    if U.data_ptr() % 16 or V.data_ptr() % 16:
        raise ValueError(f"{what}: U and V must start on a 16-byte "
                         "boundary (the kernel loads float4)")
    E, K = i.shape[0], U.shape[1]
    fn = _build.load("sddmm").sddmm_gathered_f32
    out = torch.empty((E,), dtype=torch.float32, device=U.device)
    by4 = int(K % 4 == 0)
    with torch.cuda.device(U.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(U.data_ptr(), V.data_ptr(), i.data_ptr(), j.data_ptr(),
                 out.data_ptr(), E, K, U.shape[0], V.shape[0], by4,
                 stream)
    _build.check(err, "sddmm_gathered_f32")
    gathered_launches += 1
    return out
