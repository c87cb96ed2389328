"""The first design of sddmm's fused-gather entry, kept to be timed
beside the current one and held bitwise against it (``chip_smoke.py``
reports it as the entry's ``previous_ms``).

    import sddmm_v1 as prev
    prev.register()          # before kernels._build.build_all()
    pred = prev.gathered(U, V, i, j)

``register`` adds ``scripts_dev/sddmm_v1.cu`` to the sources
``repro_torch.kernels._build`` builds; ``gathered`` launches it on fp32
contiguous CUDA factors (16-byte aligned) and int32 indices, uncounted.
"""
import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

NAME = "sddmm_v1"
SOURCE = Path(__file__).resolve().parent / "sddmm_v1.cu"


def register() -> None:
    _build.register(NAME, SOURCE, "sddmm_v1_gathered_f32",
                    [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 4
                    + [ctypes.c_int, ctypes.c_void_p])


def gathered(U: torch.Tensor, V: torch.Tensor, i: torch.Tensor,
             j: torch.Tensor) -> torch.Tensor:
    """pred (E,) with pred[e] = U[i[e]] . V[j[e]] (a zero row where an
    index is out of range)."""
    E, K = i.shape[0], U.shape[1]
    out = torch.empty((E,), dtype=torch.float32, device=U.device)
    fn = _build.load(NAME).sddmm_v1_gathered_f32
    with torch.cuda.device(U.device):
        err = fn(U.data_ptr(), V.data_ptr(), i.data_ptr(), j.data_ptr(),
                 out.data_ptr(), E, K, U.shape[0], V.shape[0],
                 int(K % 4 == 0), torch.cuda.current_stream().cuda_stream)
    _build.check(err, NAME)
    return out
