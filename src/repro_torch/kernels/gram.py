"""Launch wrappers of the hand-written CUDA masked-Gram kernel.

The kernel (``csrc/gram.cu``) replaces the Pallas-TPU kernel
``repro/kernels/gram.py::gram_pallas``; its header says what bounds it
on the card and how the design answers that.  It has two entries:

* ``gram_cuda(vg, val, mask)`` takes the gathered (R, T, K) operands,
  fp32 or bf16: ``ops.gram_and_rhs``, the reference's entry and its
  ``ops.KERNELS`` probes.  Plain version ``ref.gram_ref``;
* ``gathered_gram_cuda(fixed, idx, val, mask, alpha, acc=, lam=)``
  gathers ``fixed[idx]`` in its loads and writes the precision's part
  ``(alpha * g + acc) + lam`` once: ``ops.gathered_gram_and_rhs``, the
  sweep's entry, for an fp32 ``fixed`` (``gram_gathered_f32``) or the
  bf16 copy of the reference's ``bf16_gather`` sweep
  (``gram_gathered_bf16``: the bf16 program of ``ref.gram_ref``).
  Plain version ``ref.gathered_gram_ref``.

``launches`` counts the kernel's launches under ``ops.launch_counts()``'s
keys, ``gram`` (the fp32 entries and the pre-gathered bf16 one) and
``gram_gathered_bf16``, so a run can show that its main path went
through the kernel: one per call for K <= 128, two above (the tiled
path starts the tiles on the diagonal, then those below).
"""
from __future__ import annotations

import torch

from . import _build

launches = {"gram": 0, "gram_gathered_bf16": 0}
TILE = 128  # K up to which one persistent launch serves a call


def _check(name, x, dtypes, shape=None):
    if not x.is_cuda:
        raise ValueError(f"gram: {name} is not a CUDA tensor")
    if x.dtype not in dtypes:
        raise TypeError(f"gram: {name} is {x.dtype}; the kernel takes "
                        + " or ".join(str(d)[6:] for d in dtypes))
    if not x.is_contiguous():
        raise ValueError(f"gram: {name} is not contiguous")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"gram: {name} is {tuple(x.shape)}, want "
                         f"{tuple(shape)}")


def _same_device(*xs):
    if any(x.device != xs[0].device for x in xs):
        raise ValueError("gram: operands on different devices")


def _count(K: int) -> int:
    return 1 if K <= TILE else 2


def gram_cuda(vg: torch.Tensor, val: torch.Tensor, mask: torch.Tensor):
    """gram (R, K, K), rhs (R, K) fp32 of CUDA tensors vg (R, T, K)
    (fp32, or bf16 as the reference's ``bf16_gather`` operands), val and
    mask (R, T) (fp32 or bf16, widened exactly), all contiguous."""
    _check("vg", vg, (torch.float32, torch.bfloat16))
    R, T, K = vg.shape
    for name, x in (("val", val), ("mask", mask)):
        _check(name, x, (torch.float32, torch.bfloat16), (R, T))
    _same_device(vg, val, mask)
    val, mask = val.float(), mask.float()
    bf16 = vg.dtype == torch.bfloat16
    lib = _build.load("gram")
    fn = lib.gram_bf16 if bf16 else lib.gram_f32
    gram = torch.empty((R, K, K), dtype=torch.float32, device=vg.device)
    rhs = torch.empty((R, K), dtype=torch.float32, device=vg.device)
    vec = int(K % (8 if bf16 else 4) == 0 and vg.data_ptr() % 16 == 0)
    with torch.cuda.device(vg.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(vg.data_ptr(), val.data_ptr(), mask.data_ptr(),
                 gram.data_ptr(), rhs.data_ptr(), R, T, K, vec, stream)
    _build.check(err, fn.__name__)
    launches["gram"] += _count(K)
    return gram, rhs


def gathered_gram_cuda(fixed: torch.Tensor, idx: torch.Tensor,
                       val: torch.Tensor, mask: torch.Tensor, alpha, *,
                       acc=None, lam=None):
    """(alpha * gram + acc[0]) + lam (R, K, K) and alpha * rhs + acc[1]
    (R, K), fp32, of the rows ``fixed[idx]`` (fixed (n_fixed, K) fp32 or
    bf16, idx (R, T) int32) with val and mask (R, T) fp32, all contiguous
    CUDA tensors.  A bf16 ``fixed`` runs ``gram_gathered_bf16``: the masked
    rows and ``val * mask`` rounded to bf16, the products and sums in fp32,
    as ``ref.gram_ref``'s bf16 branch.  ``alpha`` is read on the device (a
    0-d tensor, or a number copied there); ``acc`` = (gram, rhs) is updated
    in place and returned; ``lam`` (K, K) is added at each place's own
    index.  An idx outside [0, n_fixed) reads as a row of zeros (no host
    sync checks it)."""
    _check("fixed", fixed, (torch.float32, torch.bfloat16))
    n_fixed, K = fixed.shape
    _check("idx", idx, (torch.int32,))
    R, T = idx.shape
    for name, x in (("val", val), ("mask", mask)):
        _check(name, x, (torch.float32,), (R, T))
    dev = fixed.device
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    if alpha.numel() != 1:
        raise ValueError(f"gram: alpha has {alpha.numel()} elements")
    alpha = alpha.reshape(()).contiguous()
    tensors = [fixed, idx, val, mask, alpha]
    if acc is not None:
        out_g, out_r = acc
        _check("acc gram", out_g, (torch.float32,), (R, K, K))
        _check("acc rhs", out_r, (torch.float32,), (R, K))
        tensors += [out_g, out_r]
    else:
        out_g = torch.empty((R, K, K), dtype=torch.float32, device=dev)
        out_r = torch.empty((R, K), dtype=torch.float32, device=dev)
    if lam is not None:
        lam = lam.contiguous()
        _check("lam", lam, (torch.float32,), (K, K))
        tensors.append(lam)
    _same_device(*tensors)
    bf16 = fixed.dtype == torch.bfloat16
    entry = "gram_gathered_bf16" if bf16 else "gram_gathered_f32"
    fn = getattr(_build.load("gram"), entry)
    acc_g, acc_r = (out_g.data_ptr(), out_r.data_ptr()) if acc is not None \
        else (None, None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(fixed.data_ptr(), idx.data_ptr(), val.data_ptr(),
                 mask.data_ptr(), alpha.data_ptr(), acc_g, acc_r,
                 None if lam is None else lam.data_ptr(), out_g.data_ptr(),
                 out_r.data_ptr(), R, T, K, n_fixed, stream)
    _build.check(err, entry)
    launches[entry if bf16 else "gram"] += _count(K)
    return out_g, out_r
