"""Launch wrappers of the hand-written CUDA SDDMM kernel.

The kernel (``csrc/sddmm.cu``) replaces the Pallas-TPU kernel
``repro/kernels/sddmm.py::sddmm_pallas``; its header says what bounds it
on the card and how the design answers that.  It has three entries,
each for the operand dtypes that the reference's sweep gives it (fp32,
and the bf16 copies of its ``bf16_gather`` path); any other pair
raises, and none is widened here:

* ``sddmm_cuda(ug, vg)``: the reference's, on gathered (E, K) operands,
  fp32 x fp32 or bf16 x bf16; plain version ``ref.sddmm_ref``;
* ``sddmm_gathered_cuda(U, V, i, j)``: the sweep's, which reads the rows
  ``U[i[e]]`` and ``V[j[e]]`` in its loads, a row of U once for a run of
  equal ``i``, and gives bitwise what ``sddmm_cuda`` gives on
  ``U.index_select(0, i)`` and ``V.index_select(0, j)``; fp32 x fp32 or
  bf16 x bf16 (the bf16 sweep's predictions at the observed entries);
  plain version ``ref.gathered_sddmm_ref``;
* ``sddmm_padded_cuda(u, fixed, idx)``: the same entry over a padded
  layout, row r of ``u`` against the rows ``fixed[idx[r]]``, without the
  (R * T,) vector of slot rows; fp32 x fp32, fp32 u against bf16 fixed
  (probit's predictions in the bf16 sweep, where the reference promotes
  the product to fp32) or bf16 x bf16 (the bf16 distributed sweep's
  residuals); plain version ``ref.gathered_sddmm_padded_ref``.

It is CUDA rather than Triton so that one build path serves every
kernel of the sweep.  ``launches`` counts the launches under
``ops.launch_counts()``'s keys: ``sddmm`` (``sddmm_f32``),
``sddmm_gathered`` (the fp32 gathered and padded entries), and each
bf16 entry under its C name.
"""
from __future__ import annotations

import torch

from . import _build

launches = {"sddmm": 0, "sddmm_gathered": 0, "sddmm_bf16": 0,
            "sddmm_gathered_bf16": 0, "sddmm_padded_bf16": 0,
            "sddmm_padded_mixed": 0}
_COUNTED_AS = {"sddmm_f32": "sddmm", "sddmm_gathered_f32": "sddmm_gathered",
               "sddmm_padded_f32": "sddmm_gathered"}

F32, BF16 = torch.float32, torch.bfloat16
_NAMES = {F32: "float32", BF16: "bfloat16"}


def _check_dense(name: str, x: torch.Tensor, what: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{what}: {name} is not a CUDA tensor")
    if x.dtype not in _NAMES:
        raise TypeError(f"{what}: {name} is {x.dtype}; the kernel takes "
                        "float32 or bfloat16")
    if not x.is_contiguous():
        raise ValueError(f"{what}: {name} is not contiguous")


def _pair(what: str, a, x: torch.Tensor, b, y: torch.Tensor, pairs):
    """The (dtype, dtype) of two operands, one of ``pairs``."""
    got = (x.dtype, y.dtype)
    if got not in pairs:
        raise TypeError(
            f"{what}: {a} is {x.dtype} and {b} {y.dtype}; the kernel takes "
            + " or ".join(f"{_NAMES[p]} x {_NAMES[q]}" for p, q in pairs))
    return got


def sddmm_cuda(ug: torch.Tensor, vg: torch.Tensor) -> torch.Tensor:
    """pred (E,) fp32 = rowwise dot of contiguous CUDA tensors ug and vg
    (E, K), both fp32 or both bf16.  Raises on anything the kernel does
    not take."""
    for name, x in (("ug", ug), ("vg", vg)):
        _check_dense(name, x, "sddmm_cuda")
    pair = _pair("sddmm_cuda", "ug", ug, "vg", vg, ((F32, F32), (BF16, BF16)))
    if ug.shape != vg.shape or ug.dim() != 2:
        raise ValueError(f"sddmm_cuda: ug {tuple(ug.shape)} and vg "
                         f"{tuple(vg.shape)} must both be (E, K)")
    if ug.device != vg.device:
        raise ValueError("sddmm_cuda: operands on different devices")
    E, K = ug.shape
    bf16 = pair[0] == BF16
    entry = "sddmm_bf16" if bf16 else "sddmm_f32"
    out = torch.empty((E,), dtype=torch.float32, device=ug.device)
    align = 8 if bf16 else 16   # a step of 4 elements a lane
    vec = int(K % 4 == 0 and ug.data_ptr() % align == 0
              and vg.data_ptr() % align == 0)
    _launch(entry, ug.device, ug.data_ptr(), vg.data_ptr(), out.data_ptr(),
            E, K, vec)
    return out


def _check_factors(what: str, **factors: torch.Tensor) -> None:
    """Two contiguous (rows, K) CUDA factors of one K (fp32 or bf16),
    each on a 16-byte boundary."""
    for name, x in factors.items():
        _check_dense(name, x, what)
        if x.dim() != 2:
            raise ValueError(f"{what}: {name} {tuple(x.shape)} is not "
                             "(rows, K)")
        if x.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must start on a 16-byte "
                             "boundary (the kernel loads 4 elements a "
                             "step)")
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
    launches[_COUNTED_AS.get(entry, entry)] += 1


def sddmm_gathered_cuda(U: torch.Tensor, V: torch.Tensor, i: torch.Tensor,
                        j: torch.Tensor) -> torch.Tensor:
    """pred (E,) fp32 with pred[e] = U[i[e]] . V[j[e]]: U (n_u, K) and V
    (n_v, K) contiguous CUDA tensors, both fp32 or both bf16, that start
    on a 16-byte boundary, i and j (E,) int32 contiguous on the same
    device.  An index outside its factor's rows reads a zero row.
    Raises on anything the kernel does not take."""
    what = "sddmm_gathered_cuda"
    _check_factors(what, U=U, V=V)
    pair = _pair(what, "U", U, "V", V, ((F32, F32), (BF16, BF16)))
    for name, x in (("i", i), ("j", j)):
        _check_index(what, name, x, 1)
    if i.shape != j.shape:
        raise ValueError(f"{what}: i {tuple(i.shape)} and j "
                         f"{tuple(j.shape)} differ")
    if len({U.device, V.device, i.device, j.device}) != 1:
        raise ValueError(f"{what}: operands on different devices")
    E, K = i.shape[0], U.shape[1]
    out = torch.empty((E,), dtype=torch.float32, device=U.device)
    bf16 = pair[0] == BF16
    _launch("sddmm_gathered_bf16" if bf16 else "sddmm_gathered_f32",
            U.device, U.data_ptr(), V.data_ptr(), i.data_ptr(),
            j.data_ptr(), out.data_ptr(), E, K, U.shape[0], V.shape[0],
            int(K % 4 == 0))
    return out


def sddmm_padded_cuda(u: torch.Tensor, fixed: torch.Tensor,
                      idx: torch.Tensor) -> torch.Tensor:
    """pred (R, T) fp32 with pred[r, t] = u[r] . fixed[idx[r, t]]: u
    (R, K) and fixed (n, K) contiguous CUDA tensors that start on a
    16-byte boundary, fp32 x fp32, fp32 u x bf16 fixed or bf16 x bf16;
    idx (R, T) int32 contiguous on the same device.  An index outside
    fixed's rows reads a zero row.  Raises on anything the kernel does
    not take."""
    what = "sddmm_padded_cuda"
    _check_factors(what, u=u, fixed=fixed)
    pair = _pair(what, "u", u, "fixed", fixed,
                 ((F32, F32), (F32, BF16), (BF16, BF16)))
    _check_index(what, "idx", idx, 2)
    if idx.shape[0] != u.shape[0]:
        raise ValueError(f"{what}: idx {tuple(idx.shape)} does not have "
                         f"a row for each of u's {u.shape[0]} rows")
    if len({u.device, fixed.device, idx.device}) != 1:
        raise ValueError(f"{what}: operands on different devices")
    (R, T), K = idx.shape, u.shape[1]
    out = torch.empty((R, T), dtype=torch.float32, device=u.device)
    entry = {(F32, F32): "sddmm_padded_f32", (F32, BF16): "sddmm_padded_mixed",
             (BF16, BF16): "sddmm_padded_bf16"}[pair]
    _launch(entry, u.device, u.data_ptr(), fixed.data_ptr(), idx.data_ptr(),
            out.data_ptr(), R, T, K, fixed.shape[0], int(K % 4 == 0))
    return out
