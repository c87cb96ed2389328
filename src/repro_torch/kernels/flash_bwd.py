"""Launch wrapper of the hand-written CUDA flash-attention backward.

Two sources compute (dq, dk, dv) from q, k, v, the forward's output and
row log-sum-exp (``flash.flash_cuda(..., return_lse=True)``) and dout,
chosen by :func:`design` from the dtype and the (q/k, v) head widths:
``csrc/flash_bwd_sm90.cu`` (wgmma, TMA, warp specialisation, a template
on both widths) takes bf16 at the pairs of ``SM90_HEAD_DIMS``: 64/64
and 128/128, the head widths of every GQA config, and 192/128, MLA's
prefill (q/k nope + rope against v_head_dim); ``csrc/flash_bwd.cu``
(mma.sync in bf16, CUDA cores in fp32) takes fp32 and the other bf16
widths, one or two, q/k up to 192 and v up to 128.  Both do GQA,
causal, windowed and from ``q_offset``, with no floating-point atomics,
so that a gradient is the same bits run after run.  They replace no
Pallas kernel: the reference's attention gradient is the jnp
custom_vjp ``repro/models/layers.py::_flash_vjp_bwd``.  Each header
says what bounds it on the card and how the design answers that.
Their plain version is ``ref.attention_bwd_ref``.  ``launches`` counts
the calls that launched a design (three kernels a call), one per call,
and ``design_launches`` splits that count by source.
"""
from __future__ import annotations

import torch

from . import _build

# widest q/k and v that the kernels hold
HD_MAX, HDV_MAX = 192, 128

launches = 0
design_launches = {"flash_bwd_sm90": 0, "flash_bwd": 0}
# (q/k, v) widths that flash_bwd_sm90.cu instantiates
SM90_HEAD_DIMS = ((64, 64), (128, 128), (192, 128))
SM90_ROWS = 128   # flash_bwd_sm90's statistics pad Sq to a multiple of this


def design(dtype: torch.dtype, hd: int, hdv: int = None) -> str:
    """The source whose kernels serve a call: ``flash_bwd_sm90`` for
    bf16 whose q/k width hd and v width ``hdv`` (default hd) are a pair
    of ``SM90_HEAD_DIMS``, ``flash_bwd`` otherwise."""
    pair = (hd, hd if hdv is None else hdv)
    if dtype == torch.bfloat16 and pair in SM90_HEAD_DIMS:
        return "flash_bwd_sm90"
    return "flash_bwd"


def flash_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                   *, causal: bool, window: int = 0, q_offset: int = 0):
    """(dq, dk, dv) in the operands' dtype from CUDA tensors q (B, Sq,
    H, hd), k (B, Sk, KVH, hd), v (B, Sk, KVH, hdv), out and dout (B,
    Sq, H, hdv) and lse (B, H, Sq) fp32, all contiguous, by the kernels
    of :func:`design`.  Raises on what the kernels do not take: another
    dtype, mixed dtypes, a tensor that is not contiguous or off a
    16-byte boundary, a q/k width that is not a multiple of 8 in [8,
    192] or a v width not one in [8, 128], H not a multiple of KVH,
    B * KVH above the grid's 65535 (flash_bwd.cu), or a negative window
    or offset."""
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
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_bwd_cuda: q, k and v must be 4-d")
    B, Sq, H, hd = q.shape
    Sk, KVH, hdv = k.shape[1], k.shape[2], v.shape[3]
    if tuple(k.shape) != (B, Sk, KVH, hd) \
            or tuple(v.shape) != (B, Sk, KVH, hdv) \
            or tuple(out.shape) != (B, Sq, H, hdv) \
            or dout.shape != out.shape or tuple(lse.shape) != (B, H, Sq):
        raise ValueError(
            f"flash_bwd_cuda: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, out {tuple(out.shape)}, dout "
            f"{tuple(dout.shape)} and lse {tuple(lse.shape)} do not fit "
            "(B, Sq, H, hd), (B, Sk, KVH, hd), (B, Sk, KVH, hdv), (B, Sq, "
            "H, hdv) and (B, H, Sq)")
    if KVH < 1 or H % KVH:
        raise ValueError(f"flash_bwd_cuda: H={H} is not a multiple of "
                         f"KVH={KVH}")
    if hd % 8 or not 8 <= hd <= HD_MAX:
        raise ValueError(f"flash_bwd_cuda: q/k width {hd} must be a "
                         f"multiple of 8 in [8, {HD_MAX}]")
    if hdv % 8 or not 8 <= hdv <= HDV_MAX:
        raise ValueError(f"flash_bwd_cuda: v width {hdv} must be a "
                         f"multiple of 8 in [8, {HDV_MAX}]")
    source = design(q.dtype, hd, hdv)
    # flash_bwd.cu's grids have B*KVH in y; flash_bwd_sm90.cu's are
    # one-dimensional
    if source == "flash_bwd" and B * KVH > 65535:
        raise ValueError(f"flash_bwd_cuda: B*KVH = {B * KVH} exceeds the "
                         "grid's 65535")
    if window < 0 or q_offset < 0:
        raise ValueError(f"flash_bwd_cuda: window={window} and q_offset="
                         f"{q_offset} must be >= 0")
    grads = launch(source, q, k, v, out, lse, dout, causal=causal,
                   window=window, q_offset=q_offset)
    launches += 1
    design_launches[source] += 1
    return grads


def launch(source: str, q, k, v, out, lse, dout, *, causal: bool,
           window: int = 0, q_offset: int = 0):
    """One launch of ``source``'s kernels (the C entry named in
    ``_build._SIGNATURES[source]``, which takes ``flash_bwd.cu``'s
    arguments) on tensors that :func:`flash_bwd_cuda` has checked, on
    the current stream; counts nothing (``chip_smoke.py`` and the card's
    tests call it to run one design beside the other).  The scratch
    buffer of the row statistics is (B, H, Sq) fp32 for ``flash_bwd``
    and (B, H, 2, Sq rounded up to 128) for ``flash_bwd_sm90``."""
    B, Sq, H, hd = q.shape
    Sk, KVH, hdv = k.shape[1], k.shape[2], v.shape[3]
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if source == "flash_bwd_sm90":
        sqp = -(-Sq // SM90_ROWS) * SM90_ROWS
        delta = torch.empty((B, H, 2, sqp), dtype=torch.float32,
                            device=q.device)
    else:
        delta = torch.empty((B, H, Sq), dtype=torch.float32,
                            device=q.device)
    (fn_name,) = _build._SIGNATURES[source]
    fn = getattr(_build.load(source), fn_name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H,
                 KVH, hd, hdv, int(bool(causal)), int(window), int(q_offset),
                 int(q.dtype == torch.bfloat16), stream)
    _build.check(err, fn_name)
    return dq, dk, dv
