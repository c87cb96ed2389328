"""Where the port runs: the card unless the caller names the CPU."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The current CUDA device when ``device`` is None, else the named
    device; a CUDA device always carries its index, so two spellings of
    one device compare equal.

    With no card and no explicit device this raises instead of carrying
    on quietly on the CPU: a run that was meant for the card must not
    turn into a CPU run without saying so.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device "
                "is available; pass device='cpu' to run on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for the card's queued work when ``device`` is a CUDA device."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
