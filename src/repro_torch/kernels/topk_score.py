"""Launch wrapper of the hand-written CUDA posterior-scoring top-k kernel.

The kernel (``csrc/topk_score.cu``) replaces the Pallas-TPU kernel
``repro/kernels/topk_score.py::topk_score_pallas``; its header says what
bounds it on the card and how its two passes answer that.  Its plain
version is ``ref.topk_score_ref``.

It takes us and v both fp32 (``topk_score_f32``) or both bf16
(``topk_score_bf16``: the reference's bf16 branch, whose scores are
products of bf16 values summed in fp32); excl is fp32.  ``launches``
counts the calls that launched the kernel, one per call, under
``ops.launch_counts()``'s keys ``topk_score`` and ``topk_score_bf16``.
A call launches ``2 + merges`` CUDA kernels when k <= 1,024 (scoring,
the first selecting round over chunks, the later rounds over their
lists) and ``3 + merges`` above (scoring, the radix select, the tile
sort, the merge rounds); :func:`plan` gives ``merges``.  Any 1 <= k <= N, S and K are taken: the limit is device
memory, for the scratch of 12 bytes per (user, item) and the sorted
runs of 64-bit keys (:func:`scratch_bytes`).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import _build

launches = {"topk_score": 0, "topk_score_bf16": 0}
GROUP = 8             # users a scoring block serves
SELECT_CAP = 1024     # largest k of the chunk route; above, radix select
SEGMENT = 8192        # keys a selecting block holds
SORT_CAP = 4096       # keys a sorting block holds
_n_sm = {}            # multiprocessors, by device index


class Plan(NamedTuple):
    tn: int           # items a scoring block scores: 256, 128, 64 or 32
    route: str        # "chunk" (k <= 1,024) or "radix"
    chunk: int        # chunk: items a block selects from in the first
                      # round; radix: keys a block sorts
    group: int        # lists (chunk) or sorted runs (radix) a later
                      # round folds into one
    lists: int        # lists or runs per user after the first round
    merges: int       # rounds after it


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def plan(B: int, N: int, k: int, n_sm: int = 132) -> Plan:
    """The launch plan of a (B users, N items, top-k) call.  Scoring
    tiles of 256 items are halved (down to 32) while the halved grid
    still fits one wave of ``n_sm`` blocks.  k <= 1,024: chunks of up to
    8,192 items, then rounds over groups of ``8192 // k`` of their
    lists; above, the k survivors of the radix select sorted in tiles of
    4,096 and merged in pairs.  Scoring is one float program per
    (user, item) and selection is exact, so the plan changes no
    answer."""
    if not 1 <= k <= N:
        raise ValueError(f"topk_score_cuda: k={k} must be in [1, N={N}]")
    groups = math.ceil(B / GROUP)
    tn = 256
    while tn > 32 and math.ceil(N / (tn // 2)) * groups <= n_sm:
        tn //= 2
    if k <= SELECT_CAP:
        route = "chunk"
        chunk = min(SEGMENT, _pow2_at_least(N))
        group = SEGMENT // k
        lists = math.ceil(N / chunk)
    else:
        route, chunk, group = "radix", SORT_CAP, 2
        lists = math.ceil(k / chunk)
    merges, n = 0, lists
    while n > 1:
        n = math.ceil(n / group)
        merges += 1
    return Plan(tn, route, chunk, group, lists, merges)


def _align256(n: int) -> int:
    return (n + 255) // 256 * 256


def scratch_bytes(B: int, N: int, k: int, p: Plan) -> int:
    """Device scratch of a call: (B, N) rank keys, means and ex2, then
    two sets of sorted runs of 64-bit keys, each part 256-byte aligned
    (the layout ``topk_score_f32`` takes)."""
    runs = B * (p.lists if p.route == "chunk" else 1) * k
    return 3 * _align256(4 * B * N) + 2 * _align256(8 * runs)


def _check(us: torch.Tensor, v: torch.Tensor, excl: torch.Tensor, k: int):
    for name, x in (("us", us), ("v", v), ("excl", excl)):
        if not x.is_cuda:
            raise ValueError(f"topk_score_cuda: {name} is not a CUDA "
                             "tensor")
        if not x.is_contiguous():
            raise ValueError(f"topk_score_cuda: {name} is not contiguous")
    if (us.dtype, v.dtype) not in ((torch.float32, torch.float32),
                                   (torch.bfloat16, torch.bfloat16)):
        raise TypeError(f"topk_score_cuda: us is {us.dtype} and v "
                        f"{v.dtype}; the kernel takes float32 x float32 or "
                        "bfloat16 x bfloat16")
    if excl.dtype != torch.float32:
        raise TypeError(f"topk_score_cuda: excl is {excl.dtype}; the "
                        "kernel takes float32")
    if us.dim() != 3 or v.dim() != 3:
        raise ValueError(f"topk_score_cuda: us {tuple(us.shape)} must be "
                         f"(B, S, K) and v {tuple(v.shape)} (S, N, K)")
    B, S, K = us.shape
    S2, N, K2 = v.shape
    if (S, K) != (S2, K2) or tuple(excl.shape) != (B, N):
        raise ValueError(f"topk_score_cuda: us {tuple(us.shape)}, v "
                         f"{tuple(v.shape)} and excl {tuple(excl.shape)} "
                         "do not fit (B, S, K), (S, N, K), (B, N)")
    if not (us.device == v.device == excl.device):
        raise ValueError("topk_score_cuda: operands on different devices")
    if not 1 <= k <= N:
        raise ValueError(f"topk_score_cuda: k={k} must be in [1, N={N}]")
    dev = us.device.index
    if dev not in _n_sm:
        _n_sm[dev] = torch.cuda.get_device_properties(
            us.device).multi_processor_count
    return B, S, N, K, plan(B, N, k, _n_sm[dev])


def buffers(B: int, N: int, k: int, p: Plan, device):
    """(ids, mean, ex2, scratch) of a call with plan ``p``; the three
    outputs share one allocation."""
    out = torch.empty((3, B, k), dtype=torch.int32, device=device)
    return (out[0], out[1].view(torch.float32), out[2].view(torch.float32),
            torch.empty((scratch_bytes(B, N, k, p),), dtype=torch.uint8,
                        device=device))


def launch(us: torch.Tensor, v: torch.Tensor, excl: torch.Tensor, k: int,
           passes: int = 3, bufs=None):
    """Run the kernel's passes without counting the call: 1 scoring, 2
    selection (over the scratch of ``bufs`` that a scoring pass left),
    3 both.  How ``chip_smoke.py`` times the two passes apart.  Returns
    ``bufs`` (ids, mean, ex2, scratch)."""
    B, S, N, K, p = _check(us, v, excl, k)
    ids, mean, ex2, scratch = (buffers(B, N, k, p, us.device)
                               if bufs is None else bufs)
    bf16 = us.dtype == torch.bfloat16
    # TMA: rows of a whole number of 16 bytes, operands on 16 bytes
    tma = int(K % (8 if bf16 else 4) == 0 and us.data_ptr() % 16 == 0
              and v.data_ptr() % 16 == 0)
    entry = "topk_score_bf16" if bf16 else "topk_score_f32"
    fn = getattr(_build.load("topk_score"), entry)
    with torch.cuda.device(us.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(us.data_ptr(), v.data_ptr(), excl.data_ptr(),
                 ids.data_ptr(), mean.data_ptr(), ex2.data_ptr(),
                 scratch.data_ptr(), scratch.numel(), B, S, N, K, k, p.tn,
                 p.chunk, p.group, tma, passes, stream)
    _build.check(err, entry)
    return ids, mean, ex2, scratch


def topk_score_cuda(us: torch.Tensor, v: torch.Tensor, excl: torch.Tensor,
                    k: int):
    """ids (B, k) int32, mean (B, k), ex2 (B, k) fp32 of contiguous CUDA
    tensors us (B, S, K) and v (S, N, K), both fp32 or both bf16, and
    excl (B, N) fp32 (1.0 = excluded), for 1 <= k <= N.  Raises on
    anything the kernel does not take: a CPU tensor, a mixed pair, or a
    tensor that is not contiguous."""
    ids, mean, ex2, _ = launch(us, v, excl, k)
    launches["topk_score_bf16" if us.dtype == torch.bfloat16
             else "topk_score"] += 1
    return ids, mean, ex2
