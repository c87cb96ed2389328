"""The wall clock of the port, in one module.

A copy of ``repro/obs/clock.py``.  Durations and request timestamps go
through these two functions, or through :class:`~.recorder.Recorder`
spans, so that timing stays in ``obs/``.  Nothing here may feed back
into a computation: wall-clock values are only reported, which keeps
sampled chains the same bits with the recorder on or off.
"""
from __future__ import annotations

import time as _time


def perf_counter() -> float:
    """Monotonic high-resolution timer for durations (seconds)."""
    return _time.perf_counter()


def monotonic() -> float:
    """Monotonic timer for request timestamps (seconds)."""
    return _time.monotonic()
