"""Launch wrappers of the hand-written CUDA SDDMM kernel.

The kernel (``csrc/sddmm.cu``) replaces the Pallas-TPU kernel
``repro/kernels/sddmm.py::sddmm_pallas``; its header says what bounds it
on the card and how the design answers that.  It has three entries:

* ``sddmm_cuda(ug, vg)``: the reference's, on gathered (E, K) operands;
  plain version ``ref.sddmm_ref``;
* ``sddmm_gathered_cuda(U, V, i, j)``: the sweep's, which reads the rows
  ``U[i[e]]`` and ``V[j[e]]`` in its loads, a row of U once for a run of
  equal ``i``, and gives bitwise what ``sddmm_cuda`` gives on
  ``U.index_select(0, i)`` and ``V.index_select(0, j)``; plain version
  ``ref.gathered_sddmm_ref``;
* ``sddmm_padded_cuda(u, fixed, idx)``: the same entry over a padded
  layout, row r of ``u`` against the rows ``fixed[idx[r]]``, without the
  (R * T,) vector of slot rows; plain version
  ``ref.gathered_sddmm_padded_ref``.

It is CUDA rather than Triton so that one build path serves every
kernel of the sweep.  ``launches`` counts the first entry's launches,
``gathered_launches`` the other two's.
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


def _check_factors(what: str, **factors: torch.Tensor) -> None:
    """Two fp32 contiguous (rows, K) CUDA factors of one K, each on a
    16-byte boundary."""
    for name, x in factors.items():
        _check_f32(name, x, what)
        if x.dim() != 2:
            raise ValueError(f"{what}: {name} {tuple(x.shape)} is not "
                             "(rows, K)")
        if x.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must start on a 16-byte "
                             "boundary (the kernel loads float4)")
    (a, x), (b, y) = factors.items()
    if x.shape[1] != y.shape[1]:
        raise ValueError(f"{what}: {a} {tuple(x.shape)} and {b} "
                         f"{tuple(y.shape)} differ in K")


def _check_index(what: str, name: str, x: torch.Tensor, dim: int) -> None:
    if not x.is_cuda:
        raise ValueError(f"{what}: {name} is not a CUDA tensor")
    if x.dtype != torch.int32:
        raise TypeError(f"{what}: {name} is {x.dtype}; the kernel takes "
                        "int32 indices")
    if x.dim() != dim or not x.is_contiguous():
        raise ValueError(f"{what}: {name} must be a contiguous "
                         f"{dim}-d tensor")


def _launch(entry: str, device, *args) -> None:
    fn = getattr(_build.load("sddmm"), entry)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    _build.check(err, entry)


def sddmm_gathered_cuda(U: torch.Tensor, V: torch.Tensor, i: torch.Tensor,
                        j: torch.Tensor) -> torch.Tensor:
    """pred (E,) with pred[e] = U[i[e]] . V[j[e]]: U (n_u, K) and V
    (n_v, K) fp32 contiguous CUDA tensors that start on a 16-byte
    boundary, i and j (E,) int32 contiguous on the same device.  An
    index outside its factor's rows reads a zero row.  Raises on
    anything the kernel does not take."""
    global gathered_launches
    what = "sddmm_gathered_cuda"
    _check_factors(what, U=U, V=V)
    for name, x in (("i", i), ("j", j)):
        _check_index(what, name, x, 1)
    if i.shape != j.shape:
        raise ValueError(f"{what}: i {tuple(i.shape)} and j "
                         f"{tuple(j.shape)} differ")
    if len({U.device, V.device, i.device, j.device}) != 1:
        raise ValueError(f"{what}: operands on different devices")
    E, K = i.shape[0], U.shape[1]
    out = torch.empty((E,), dtype=torch.float32, device=U.device)
    _launch("sddmm_gathered_f32", U.device, U.data_ptr(), V.data_ptr(),
            i.data_ptr(), j.data_ptr(), out.data_ptr(), E, K, U.shape[0],
            V.shape[0], int(K % 4 == 0))
    gathered_launches += 1
    return out


def sddmm_padded_cuda(u: torch.Tensor, fixed: torch.Tensor,
                      idx: torch.Tensor) -> torch.Tensor:
    """pred (R, T) with pred[r, t] = u[r] . fixed[idx[r, t]]: u (R, K)
    and fixed (n, K) fp32 contiguous CUDA tensors that start on a
    16-byte boundary, idx (R, T) int32 contiguous on the same device.
    Counted under ``gathered_launches``; an index outside fixed's rows
    reads a zero row.  Raises on anything the kernel does not take."""
    global gathered_launches
    what = "sddmm_padded_cuda"
    _check_factors(what, u=u, fixed=fixed)
    _check_index(what, "idx", idx, 2)
    if idx.shape[0] != u.shape[0]:
        raise ValueError(f"{what}: idx {tuple(idx.shape)} does not have "
                         f"a row for each of u's {u.shape[0]} rows")
    if len({u.device, fixed.device, idx.device}) != 1:
        raise ValueError(f"{what}: operands on different devices")
    (R, T), K = idx.shape, u.shape[1]
    out = torch.empty((R, T), dtype=torch.float32, device=u.device)
    _launch("sddmm_padded_f32", u.device, u.data_ptr(), fixed.data_ptr(),
            idx.data_ptr(), out.data_ptr(), R, T, K, fixed.shape[0],
            int(K % 4 == 0))
    gathered_launches += 1
    return out
