"""Posterior-predictive evaluation over collected samples.

The counterpart of the in-session part of ``repro/core/predict.py``:
``TestSet``, ``make_test_set``, ``predict_one``, ``rmse`` and
``PredictAccumulator``.  ``PredictSession``, the resident posterior
cache and the recommenders are still to be ported (ROADMAP A7).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..kernels import ops


class TestSet(NamedTuple):
    i: torch.Tensor   # (E,) int32 row ids
    j: torch.Tensor   # (E,) int32 col ids
    v: torch.Tensor   # (E,) f32 true values


def make_test_set(i, j, v, device: DeviceLike = None) -> TestSet:
    dev = resolve_device(device)
    return TestSet(torch.as_tensor(np.asarray(i, np.int32), device=dev),
                   torch.as_tensor(np.asarray(j, np.int32), device=dev),
                   torch.as_tensor(np.asarray(v, np.float32), device=dev))


def predict_one(U: torch.Tensor, V: torch.Tensor, test: TestSet
                ) -> torch.Tensor:
    """Single-sample prediction at the test entries."""
    return ops.sddmm(U.index_select(0, test.i), V.index_select(0, test.j))


def rmse(pred: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean((pred - truth) ** 2))


class PredictAccumulator:
    """Streaming average of per-sample predictions (posterior mean)."""

    def __init__(self, test: TestSet):
        self.test = test
        self._sum = torch.zeros_like(test.v)
        self._sum2 = torch.zeros_like(test.v)
        self.n = 0

    def update(self, U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
        p = predict_one(U, V, self.test)
        self._sum = self._sum + p
        self._sum2 = self._sum2 + p * p
        self.n += 1
        return p

    @property
    def mean(self) -> torch.Tensor:
        return self._sum / max(self.n, 1)

    @property
    def var(self) -> torch.Tensor:
        """Population variance over the posterior samples of the
        per-sample predictions, ``E[p^2] - E[p]^2``."""
        m = self.mean
        return torch.clamp_min(self._sum2 / max(self.n, 1) - m * m, 0.0)

    def rmse(self) -> float:
        return float(rmse(self.mean, self.test.v))
