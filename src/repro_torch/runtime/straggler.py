"""Straggler detection.

A copy of ``repro/runtime/straggler.py``.  A synchronous sweep cannot
run ahead of a slow rank, so mitigation happens at two levels:

1. **By construction**: the padded-bucket layout gives every rank equal
   rows and equal per-row work.

2. **Detection + restart**: a persistently slow rank is found by its
   step times and treated like a failure (save, start a smaller world,
   restore; see ``runtime/fault.py``).  ``StragglerMonitor`` flags a
   step slower than ``threshold`` x the rolling median more than
   ``patience`` times in a row.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Optional


class StragglerMonitor:
    def __init__(self, window: int = 50, threshold: float = 2.0,
                 patience: int = 3):
        self.times: Deque[float] = deque(maxlen=window)
        self.threshold = threshold
        self.patience = patience
        self._slow_streak = 0

    def record(self, step_time_s: float) -> bool:
        """Record one step; True => persistent straggler, restart."""
        median = self.median()
        self.times.append(step_time_s)
        if median is None:
            return False
        if step_time_s > self.threshold * median:
            self._slow_streak += 1
        else:
            self._slow_streak = 0
        return self._slow_streak >= self.patience

    def median(self) -> Optional[float]:
        if len(self.times) < 5:
            return None
        s = sorted(self.times)
        return s[len(s) // 2]
