"""Public kernel entry points, dispatched by the tensors' device.

The counterpart of ``gram_and_rhs`` and ``sddmm`` in
``repro/kernels/ops.py``.  Where the reference chooses between the
Pallas kernel and the jnp oracle with a ``use_pallas`` flag, here the
device decides: a CUDA tensor launches the hand-written kernel (or the
wrapper raises), a CPU tensor runs the plain version of ``ref.py``.
There is no fallback from the kernel to the plain version.  The CUDA
kernels mask ragged edges themselves, so no padding happens here.

``KERNELS`` lists each kernel with its probe shapes: the ``ops.KERNELS``
envelope of the reference (fp32 probes; bf16 is a later slice).
"""
from __future__ import annotations

from typing import Dict

import torch

from . import gram as _gram
from . import ref
from . import sddmm as _sddmm


def gram_and_rhs(vg: torch.Tensor, val: torch.Tensor, mask: torch.Tensor):
    """Fused masked batched Gram; see kernels/gram.py."""
    if vg.is_cuda:
        return _gram.gram_cuda(vg.contiguous(), val.contiguous(),
                               mask.contiguous())
    return ref.gram_ref(vg, val, mask)


def sddmm(ug: torch.Tensor, vg: torch.Tensor) -> torch.Tensor:
    """Gathered-operand SDDMM; see kernels/sddmm.py."""
    if ug.is_cuda:
        return _sddmm.sddmm_cuda(ug.contiguous(), vg.contiguous())
    return ref.sddmm_ref(ug, vg)


def launch_counts() -> Dict[str, int]:
    """Launches of each CUDA kernel since the last reset."""
    return {"gram": _gram.launches, "sddmm": _sddmm.launches}


def reset_launch_counts() -> None:
    _gram.launches = 0
    _sddmm.launches = 0


# probe shapes of the reference's ops.KERNELS envelope, fp32
KERNELS = {
    "gram": {"production r64 t256 K128": (64, 256, 128),
             "uneven tail r13 t257 K33": (13, 257, 33)},
    "sddmm": {"production e4096 K128": (4096, 128),
              "uneven tail e1025 K200": (1025, 200)},
}
