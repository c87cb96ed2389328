"""Carry a chain's state and data over from the JAX package.

``state_from_reference`` and ``data_from_reference`` take the leaves of
``repro``'s ``MFState``/``MFData`` as numpy arrays -- or any objects
with the same fields whose leaves ``numpy.asarray`` accepts -- and
return the port's on a given device.  The parity tests use them to
start both packages from the same state.  This module imports nothing
of JAX or ``repro``: it reads fields by name.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .core.gibbs import MFData, MFState
from .core.sparse import PaddedRows, SparseMatrix


def _t(x, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(dev)


def state_from_reference(key, factors: Sequence[Any],
                         hypers: Sequence[Dict[str, Any]],
                         noises: Sequence[Dict[str, Any]], step,
                         device: DeviceLike = None) -> MFState:
    """The port's ``MFState`` from the reference's leaves.  ``key`` is
    the raw (2,) uint32 threefry key; it is held as int64."""
    dev = resolve_device(device)
    key = torch.from_numpy(np.asarray(key, np.uint32).astype(np.int64))
    return MFState(
        key.to(dev),
        tuple(_t(np.asarray(f, np.float32), dev) for f in factors),
        tuple({k: _t(np.asarray(v, np.float32), dev) for k, v in h.items()}
              for h in hypers),
        tuple({k: _t(np.asarray(v, np.float32), dev) for k, v in n.items()}
              for n in noises),
        int(np.asarray(step)))


def _padded(p, dev: torch.device) -> PaddedRows:
    return PaddedRows(_t(np.asarray(p.idx, np.int32), dev),
                      _t(np.asarray(p.val, np.float32), dev),
                      _t(np.asarray(p.mask, np.float32), dev),
                      int(p.n_other))


def sparse_from_reference(mat, device: DeviceLike = None) -> SparseMatrix:
    """The port's ``SparseMatrix`` from a reference ``SparseMatrix``."""
    dev = resolve_device(device)
    i32 = {name: _t(np.asarray(getattr(mat, name), np.int32), dev)
           for name in ("coo_i", "coo_j", "coo_rpos", "coo_cpos")}
    f32 = {name: _t(np.asarray(getattr(mat, name), np.float32), dev)
           for name in ("coo_v", "coo_mask")}
    return SparseMatrix(rows=_padded(mat.rows, dev),
                        cols=_padded(mat.cols, dev),
                        shape=tuple(int(s) for s in mat.shape),
                        **i32, **f32)


def data_from_reference(blocks: Sequence[Any], sides: Sequence[Any],
                        device: DeviceLike = None) -> MFData:
    """The port's ``MFData`` from the reference's sparse blocks and
    per-entity side information (not ported yet: all must be None)."""
    if any(s is not None for s in sides):
        raise ValueError("side information (Macau) is not ported yet; "
                         "see ROADMAP.md, queue A")
    dev = resolve_device(device)
    return MFData(tuple(sparse_from_reference(b, dev) for b in blocks),
                  (None,) * len(sides))
