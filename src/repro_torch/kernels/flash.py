"""Launch wrapper of the hand-written CUDA flash-attention kernels.

Two sources replace the Pallas-TPU kernel
``repro/kernels/flash.py::flash_fwd_pallas``, chosen by :func:`design`
from the dtype and the head widths: ``csrc/flash_sm90.cu`` (wgmma, TMA,
warp specialisation) takes bf16 at the (q/k, v) widths of
``SM90_HEAD_DIMS``: 64/64 and 128/128, the head widths of every GQA
config, and 192/128, MLA's prefill; ``csrc/flash.cu`` (mma.sync in
bf16, CUDA cores in fp32) takes fp32 and the other bf16 widths, one or
two.  Each header says what bounds it on the card and how the design
answers that.  Their plain version is ``ref.attention_ref``.
``launches`` counts the calls that launched a kernel, one per call, and
``design_launches`` splits that count by source.

With ``return_lse`` both kernels also write each row's log-sum-exp
(B, H, Sq) fp32, which the backward (``flash_bwd.py``) reads; ``out``
is the same bits with and without it.  The C entries take the buffer's
address as an integer after ``q_offset`` (0 for none).
"""
from __future__ import annotations

import torch

from . import _build

launches = 0
design_launches = {"flash_sm90": 0, "flash": 0}
# widest q/k and v that flash.cu's registers and shared memory hold
HD_MAX, HDV_MAX = 192, 128
# (q/k, v) widths that flash_sm90.cu instantiates
SM90_HEAD_DIMS = ((64, 64), (128, 128), (192, 128))


def design(dtype: torch.dtype, hd: int, hdv: int = None) -> str:
    """The source whose kernel serves a call: ``flash_sm90`` for bf16
    whose q/k width hd and v width ``hdv`` (default hd) are a pair of
    ``SM90_HEAD_DIMS``, ``flash`` otherwise."""
    pair = (hd, hd if hdv is None else hdv)
    if dtype == torch.bfloat16 and pair in SM90_HEAD_DIMS:
        return "flash_sm90"
    return "flash"


def flash_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool, window: int = 0, q_offset: int = 0,
               return_lse: bool = False):
    """out (B, Sq, H, hdv) in q's dtype from CUDA tensors q (B, Sq, H, hd),
    k (B, Sk, KVH, hd) and v (B, Sk, KVH, hdv), read in place through
    their strides; with ``return_lse``, (out, lse (B, H, Sq) fp32): each
    row's log-sum-exp of its scaled scores (scale 1/sqrt(hd)), +inf for a
    row that sees no key.  fp32 (CUDA cores, no TF32) or bf16 (tensor
    cores), by the kernel of :func:`design`: bf16 at 64/64, 128/128 and
    192/128 (MLA's prefill) on ``flash_sm90.cu``, the rest on
    ``flash.cu``; a call the chosen kernel refuses raises, and never
    goes to the other.  Raises on what the kernels do not take: another
    dtype, mixed dtypes, a width that is not a
    multiple of 8, hd above 192 or hdv above 128, H not a multiple of
    KVH, a last dimension that is not contiguous, bf16 rows that are not
    16-byte aligned, or a negative window or offset."""
    global launches
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda:
            raise ValueError(f"flash_cuda: {name} is not a CUDA tensor")
        if x.dim() != 4:
            raise ValueError(f"flash_cuda: {name} {tuple(x.shape)} is not "
                             "4-d")
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"flash_cuda: {name} is {x.dtype}; the kernel "
                            "takes float32 or bfloat16")
        if x.dtype != q.dtype:
            raise TypeError(f"flash_cuda: {name} is {x.dtype}, q is "
                            f"{q.dtype}")
        if x.device != q.device:
            raise ValueError("flash_cuda: operands on different devices")
        if x.shape[-1] > 1 and x.stride(-1) != 1:
            raise ValueError(f"flash_cuda: {name}'s last dimension is not "
                             "contiguous")
    B, Sq, H, hd = q.shape
    Sk, KVH, hdv = k.shape[1], k.shape[2], v.shape[3]
    if tuple(k.shape) != (B, Sk, KVH, hd) or \
            tuple(v.shape) != (B, Sk, KVH, hdv):
        raise ValueError(f"flash_cuda: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} do not fit "
                         "(B, Sq, H, hd), (B, Sk, KVH, hd), (B, Sk, KVH, hdv)")
    if KVH < 1 or H % KVH:
        raise ValueError(f"flash_cuda: H={H} is not a multiple of KVH={KVH}")
    for what, width, top in (("q/k", hd, HD_MAX), ("v", hdv, HDV_MAX)):
        if width % 8 or not 8 <= width <= top:
            raise ValueError(f"flash_cuda: {what} head width {width} must "
                             f"be a multiple of 8 in [8, {top}]")
    if window < 0 or q_offset < 0:
        raise ValueError(f"flash_cuda: window={window} and q_offset="
                         f"{q_offset} must be >= 0")
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        for name, x in (("q", q), ("k", k), ("v", v)):
            if x.data_ptr() % 16 or any(s % 8 for s in x.stride()[:3]):
                raise ValueError(
                    f"flash_cuda: {name}'s bf16 rows are not 16-byte "
                    "aligned (data pointer and strides)")
    source = design(q.dtype, hd, hdv)
    # flash.cu's grid has B*KVH in y; flash_sm90.cu's is one-dimensional
    if source == "flash" and B * KVH > 65535:
        raise ValueError(f"flash_cuda: B*KVH = {B * KVH} exceeds the grid's "
                         "65535")
    lse = torch.empty((B, H, Sq), dtype=torch.float32,
                      device=q.device) if return_lse else None
    out = launch(source, q, k, v, causal=causal, window=window,
                 q_offset=q_offset, lse=lse)
    launches += 1
    design_launches[source] += 1
    return (out, lse) if return_lse else out


def launch(source: str, q, k, v, *, causal: bool, window: int = 0,
           q_offset: int = 0, lse=None) -> torch.Tensor:
    """One launch of ``source``'s kernel on tensors that
    :func:`flash_cuda` has checked, on the current stream, writing the
    rows' log-sum-exp into ``lse`` (B, H, Sq) fp32 when it is given;
    counts nothing (``chip_smoke.py`` and the card's tests call it to
    run one design beside the other)."""
    out = torch.empty(q.shape[:3] + v.shape[3:], dtype=q.dtype,
                      device=q.device)
    (fn_name,) = _build._SIGNATURES[source]
    fn = getattr(_build.load(source), fn_name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*launch_args(q, k, v, out, causal=causal, window=window,
                              q_offset=q_offset, source=source, lse=lse),
                 stream)
    _build.check(err, fn_name)
    return out


def launch_args(q, k, v, out, *, causal: bool, window: int,
                q_offset: int, source: str = "flash", lse=None) -> tuple:
    """The C entry's arguments but the stream: the four data pointers,
    the (batch, sequence, head) strides of q, k and v in elements, then
    B, Sq, Sk, H, KVH, hd (q and k's width), hdv (v's), causal, window,
    q_offset, the address of ``lse`` (0 for None) and, for ``flash.cu``'s
    entry alone, is_bf16."""
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            B, Sq, Sk, H, KVH, hd, v.shape[3], int(bool(causal)), int(window),
            int(q_offset), 0 if lse is None else lse.data_ptr())
    if source == "flash":
        return args + (int(q.dtype == torch.bfloat16),)
    return args
