"""Launch wrapper of the hand-written CUDA posterior-scoring top-k kernel.

The kernel (``csrc/topk_score.cu``) replaces the Pallas-TPU kernel
``repro/kernels/topk_score.py::topk_score_pallas``; its header says what
bounds it on the card and how the two-pass design answers that.  Its
plain version is ``ref.topk_score_ref``.  ``launches`` counts the calls
that launched the kernel: one scoring pass and its merge passes each
(:func:`plan` gives their number).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import _build

launches = 0
CHUNK = 1024          # most items one scoring block ranks; k's limit
MIN_CHUNK = 128
MERGE_CAP = 4096      # candidates one merge block sorts
SMEM_LIMIT = 232448   # shared memory a block may use on Hopper (bytes)


class Plan(NamedTuple):
    chunk: int        # items per scoring block, a power of 2
    group: int        # candidate lists per merge block
    lists: int        # scoring blocks per user
    merges: int       # merge passes after the scoring pass


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def plan(B: int, N: int, k: int, n_sm: int = 132) -> Plan:
    """Chunk size and merge fan-in for a (B users, N items, top-k)
    call.  Chunks of up to ``CHUNK`` items; at small B * N they are
    halved (down to ``MIN_CHUNK``, and never below k) until the scoring
    grid has two blocks per SM.  Selection is exact, so the chunk size
    changes no answer."""
    if k > CHUNK:
        raise ValueError(
            f"topk_score_cuda: k={k} exceeds the kernel's chunk of "
            f"{CHUNK} items (one scoring block keeps its chunk's top k)")
    chunk = min(CHUNK, _pow2_at_least(max(N, k)))
    while chunk > MIN_CHUNK and chunk // 2 >= k \
            and B * math.ceil(N / chunk) < 2 * n_sm:
        chunk //= 2
    group = MERGE_CAP // k
    lists = math.ceil(N / chunk)
    merges, n = 0, lists
    while n > 1:
        n = math.ceil(n / group)
        merges += 1
    return Plan(chunk, group, lists, merges)


def topk_score_cuda(us: torch.Tensor, v: torch.Tensor, excl: torch.Tensor,
                    k: int):
    """ids (B, k) int32, mean (B, k), ex2 (B, k) of fp32 contiguous CUDA
    tensors us (B, S, K), v (S, N, K), excl (B, N) (1.0 = excluded),
    for 1 <= k <= N.  Raises on anything the kernel does not take: bf16,
    a tensor that is not contiguous, k above the chunk size, or us[b]
    too large for shared memory."""
    global launches
    for name, x in (("us", us), ("v", v), ("excl", excl)):
        if not x.is_cuda:
            raise ValueError(f"topk_score_cuda: {name} is not a CUDA "
                             "tensor")
        if x.dtype != torch.float32:
            raise TypeError(f"topk_score_cuda: {name} is {x.dtype}; the "
                            "kernel takes float32 (bf16 is not ported "
                            "yet)")
        if not x.is_contiguous():
            raise ValueError(f"topk_score_cuda: {name} is not contiguous")
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
    n_sm = torch.cuda.get_device_properties(us.device).multi_processor_count
    p = plan(B, N, k, n_sm)
    # a scoring block holds us[b] and its chunk's keys, means and E[s^2]
    if 4 * ((S * K + 3) // 4 * 4) + 16 * p.chunk > SMEM_LIMIT:
        raise ValueError(
            f"topk_score_cuda: S*K = {S}*{K} floats of a user's rows do "
            f"not fit the {SMEM_LIMIT} bytes of shared memory a block "
            "may use")
    if p.lists > 65535:
        raise ValueError(f"topk_score_cuda: N={N} needs {p.lists} "
                         "chunks; the grid takes at most 65535")
    fn = _build.load("topk_score").topk_score_f32
    dev = us.device
    ids = torch.empty((B, k), dtype=torch.int32, device=dev)
    mean = torch.empty((B, k), dtype=torch.float32, device=dev)
    ex2 = torch.empty((B, k), dtype=torch.float32, device=dev)
    # two sets of (B, lists, k) candidate lists, 16 bytes an entry
    scratch = torch.empty((2 * 4 * B * p.lists * k,), dtype=torch.int32,
                          device=dev)
    vec = int(K % 4 == 0 and us.data_ptr() % 16 == 0
              and v.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(us.data_ptr(), v.data_ptr(), excl.data_ptr(),
                 ids.data_ptr(), mean.data_ptr(), ex2.data_ptr(),
                 scratch.data_ptr(), B, S, N, K, k, p.chunk, p.group, vec,
                 stream)
    _build.check(err, "topk_score_f32")
    launches += 1
    return ids, mean, ex2
