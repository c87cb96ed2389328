"""The first design of the gram kernel, kept to be timed beside the
current one (``chip_smoke.py`` reports the pipeline it served, gather +
this kernel + ``mul_`` + ``add_``, as the kernel's ``previous_ms``).

    import gram_v1 as prev
    prev.register()          # before kernels._build.build_all()
    gram, rhs = prev.gram(vg, val, mask)
    gram, rhs = prev.pipeline(fixed, idx, val, mask, alpha, lam)

``register`` adds ``scripts_dev/gram_v1.cu`` to the sources
``repro_torch.kernels._build`` builds; ``gram`` launches it on a
pre-gathered fp32 slab, uncounted; ``pipeline`` is the sweep's
Gram as it ran before the fused entry.
"""
import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

NAME = "gram_v1"
SOURCE = Path(__file__).resolve().parent / "gram_v1.cu"


def register() -> None:
    _build.register(NAME, SOURCE, "gram_f32",
                    [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 3
                    + [ctypes.c_int, ctypes.c_void_p])


def gram(vg: torch.Tensor, val: torch.Tensor, mask: torch.Tensor):
    """gram (R, K, K), rhs (R, K) of contiguous fp32 CUDA operands."""
    R, T, K = vg.shape
    g = torch.empty((R, K, K), dtype=torch.float32, device=vg.device)
    r = torch.empty((R, K), dtype=torch.float32, device=vg.device)
    vec = int(K % 4 == 0 and vg.data_ptr() % 16 == 0)
    fn = _build.load(NAME).gram_f32
    with torch.cuda.device(vg.device):
        err = fn(vg.data_ptr(), val.data_ptr(), mask.data_ptr(),
                 g.data_ptr(), r.data_ptr(), R, T, K, vec,
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, NAME)
    return g, r


def gather(fixed: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The (R, T, K) slab of the rows ``fixed[idx]``."""
    R, T = idx.shape
    return fixed.index_select(0, idx.reshape(-1)).reshape(R, T,
                                                          fixed.shape[1])


def pipeline(fixed, idx, val, mask, alpha, lam=None, acc=None):
    """The sweep's alpha-weighted Gram before the fused entry: gather,
    this kernel, ``mul_`` by alpha, ``add_`` into acc, ``add_`` lam."""
    vg = gather(fixed, idx)
    g, r = gram(vg, val, mask)
    del vg
    g.mul_(alpha)
    r.mul_(alpha)
    if acc is not None:
        g = acc[0].add_(g)
        r = acc[1].add_(r)
    if lam is not None:
        g.add_(lam)
    return g, r
