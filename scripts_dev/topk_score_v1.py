"""The first design of the topk_score kernel, kept to be timed beside the
current one (``chip_smoke.py`` reports it as the kernel's
``previous_ms``).

    import topk_score_v1 as prev
    prev.register()          # before kernels._build.build_all()
    ids, mean, ex2 = prev.topk(us, v, excl, k)

``register`` adds ``scripts_dev/topk_score_v1.cu`` to the sources
``repro_torch.kernels._build`` builds; ``topk`` launches it with the
first wrapper's plan (chunks of up to 1,024 items halved until the grid
has two blocks per SM, merge groups of 4,096 // k lists).  It takes
k <= 1,024 and S * K up to about 54,000 floats, as that design did.
"""
import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import _build

NAME = "topk_score_v1"
SOURCE = Path(__file__).resolve().parent / "topk_score_v1.cu"


def register() -> None:
    _build.register(NAME, SOURCE, "topk_score_f32",
                    [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 7
                    + [ctypes.c_int, ctypes.c_void_p])


def plan(B: int, N: int, k: int, n_sm: int):
    """(chunk, group, lists) of the first design's wrapper."""
    chunk = min(1024, 1 << max(0, max(N, k) - 1).bit_length())
    while chunk > 128 and chunk // 2 >= k \
            and B * math.ceil(N / chunk) < 2 * n_sm:
        chunk //= 2
    return chunk, 4096 // k, math.ceil(N / chunk)


def topk(us: torch.Tensor, v: torch.Tensor, excl: torch.Tensor, k: int):
    """ids, mean, ex2 of contiguous fp32 CUDA operands, uncounted."""
    B, S, K = us.shape
    N = v.shape[1]
    if k > 1024 or 4 * ((S * K + 3) // 4 * 4) + 16 * 1024 > 232448:
        raise ValueError(f"the first topk_score design does not take k={k}, S*K="
                         f"{S * K}")
    chunk, group, lists = plan(B, N, k, torch.cuda.get_device_properties(
        us.device).multi_processor_count)
    dev = us.device
    ids = torch.empty((B, k), dtype=torch.int32, device=dev)
    mean = torch.empty((B, k), dtype=torch.float32, device=dev)
    ex2 = torch.empty((B, k), dtype=torch.float32, device=dev)
    scratch = torch.empty((8 * B * lists * k,), dtype=torch.int32,
                          device=dev)
    vec = int(K % 4 == 0 and us.data_ptr() % 16 == 0
              and v.data_ptr() % 16 == 0)
    fn = _build.load(NAME).topk_score_f32
    with torch.cuda.device(dev):
        err = fn(us.data_ptr(), v.data_ptr(), excl.data_ptr(),
                 ids.data_ptr(), mean.data_ptr(), ex2.data_ptr(),
                 scratch.data_ptr(), B, S, N, K, k, chunk, group, vec,
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, NAME)
    return ids, mean, ex2
