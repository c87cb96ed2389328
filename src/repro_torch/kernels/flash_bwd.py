"""Launch wrapper of the hand-written CUDA flash-attention backward.

``csrc/flash_bwd.cu`` computes (dq, dk, dv) from q, k, v, the forward's
output and row log-sum-exp (``flash.flash_cuda(..., return_lse=True)``)
and dout: fp32 on the CUDA cores, bf16 on the tensor cores, GQA, causal,
windowed and from ``q_offset``, with no floating-point atomics, so that
a gradient is the same bits run after run.  It replaces no Pallas
kernel: the reference's attention gradient is the jnp custom_vjp
``repro/models/layers.py::_flash_vjp_bwd``.  The source's header says
what bounds it on the card and how the design answers that.  Its plain
version is ``ref.attention_bwd_ref``.  ``launches`` counts the calls
that launched it (three kernels a call), one per call.
"""
from __future__ import annotations

import torch

from . import _build
from .flash import HD_MAX

launches = 0


def flash_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                   *, causal: bool, window: int = 0, q_offset: int = 0):
    """(dq, dk, dv) in the operands' dtype from CUDA tensors q, out, dout
    (B, Sq, H, hd), k, v (B, Sk, KVH, hd) and lse (B, H, Sq) fp32, all
    contiguous.  Raises on what the kernels do not take: another dtype,
    mixed dtypes, a tensor that is not contiguous or off a 16-byte
    boundary, a head width that is not a multiple of 8 or is above 128,
    H not a multiple of KVH, B * KVH above the grid's 65535, or a
    negative window or offset."""
    global launches
    named = (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout))
    for name, x in named + (("lse", lse),):
        if not x.is_cuda:
            raise ValueError(f"flash_bwd_cuda: {name} is not a CUDA tensor")
        if x.device != q.device:
            raise ValueError("flash_bwd_cuda: operands on different devices")
        if not x.is_contiguous():
            raise ValueError(f"flash_bwd_cuda: {name} is not contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"flash_bwd_cuda: {name} is not 16-byte "
                             "aligned")
    for name, x in named:
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"flash_bwd_cuda: {name} is {x.dtype}; the "
                            "kernel takes float32 or bfloat16")
        if x.dtype != q.dtype:
            raise TypeError(f"flash_bwd_cuda: {name} is {x.dtype}, q is "
                            f"{q.dtype}")
    if lse.dtype != torch.float32:
        raise TypeError(f"flash_bwd_cuda: lse is {lse.dtype}, not float32")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_bwd_cuda: q and k must be 4-d")
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Sk, KVH, hd) or v.shape != k.shape \
            or out.shape != q.shape or dout.shape != q.shape \
            or tuple(lse.shape) != (B, H, Sq):
        raise ValueError(
            f"flash_bwd_cuda: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, out {tuple(out.shape)}, dout "
            f"{tuple(dout.shape)} and lse {tuple(lse.shape)} do not fit "
            "(B, Sq, H, hd), (B, Sk, KVH, hd) and (B, H, Sq)")
    if KVH < 1 or H % KVH:
        raise ValueError(f"flash_bwd_cuda: H={H} is not a multiple of "
                         f"KVH={KVH}")
    if hd % 8 or not 8 <= hd <= HD_MAX:
        raise ValueError(f"flash_bwd_cuda: head width {hd} must be a "
                         f"multiple of 8 in [8, {HD_MAX}]")
    if B * KVH > 65535:
        raise ValueError(f"flash_bwd_cuda: B*KVH = {B * KVH} exceeds the "
                         "grid's 65535")
    if window < 0 or q_offset < 0:
        raise ValueError(f"flash_bwd_cuda: window={window} and q_offset="
                         f"{q_offset} must be >= 0")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    fn = _build.load("flash_bwd").flash_bwd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H,
                 KVH, hd, int(bool(causal)), int(window), int(q_offset),
                 int(q.dtype == torch.bfloat16), stream)
    _build.check(err, "flash_bwd")
    launches += 1
    return dq, dk, dv
