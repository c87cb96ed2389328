"""Padded sparse matrices on the device.

The counterpart of ``repro/core/sparse.py``.  Every row's nonzeros are
padded to a common ``max_nnz`` ("padded-bucket CSR"), so a Gibbs
half-sweep is one gather of a ``(rows, max_nnz, K)`` slab followed by
the masked Gram kernel, with no load imbalance between rows.  Both
orientations are kept (rows for the row-entity update, columns for the
column-entity update) plus a flat COO view for the predictions at the
observed entries.

Construction is host-side numpy, line for line the reference's, so the
same COO input gives the same padded arrays; the finished arrays then
move to the device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class PaddedRows:
    """One orientation of a sparse matrix: per-row padded nonzeros.

    idx[i, t]  = column index of the t-th nonzero of row i (0 when padded)
    val[i, t]  = value of that nonzero (0 when padded)
    mask[i, t] = 1.0 for real entries, 0.0 for padding
    """

    idx: torch.Tensor   # (n_rows, max_nnz) int32
    val: torch.Tensor   # (n_rows, max_nnz) float32
    mask: torch.Tensor  # (n_rows, max_nnz) float32
    n_other: int        # number of columns in this orientation

    @property
    def n_rows(self) -> int:
        return self.idx.shape[0]

    @property
    def max_nnz(self) -> int:
        return self.idx.shape[1]

    @property
    def nnz(self) -> torch.Tensor:
        return self.mask.sum()


@dataclasses.dataclass(frozen=True)
class SparseMatrix:
    """A sparse matrix held in both orientations plus flat COO."""

    rows: PaddedRows
    cols: PaddedRows
    coo_i: torch.Tensor     # (nnz_pad,) int32
    coo_j: torch.Tensor     # (nnz_pad,) int32
    coo_v: torch.Tensor     # (nnz_pad,) float32
    coo_mask: torch.Tensor  # (nnz_pad,) float32
    coo_rpos: torch.Tensor  # (nnz_pad,) int32 flat pos into rows.val
    coo_cpos: torch.Tensor  # (nnz_pad,) int32 flat pos into cols.val
    shape: Tuple[int, int]

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> torch.Tensor:
        return self.coo_mask.sum()

    @property
    def device(self) -> torch.device:
        return self.coo_v.device

    def transpose(self) -> "SparseMatrix":
        return SparseMatrix(self.cols, self.rows, self.coo_j, self.coo_i,
                            self.coo_v, self.coo_mask, self.coo_cpos,
                            self.coo_rpos, (self.shape[1], self.shape[0]))


def _pad_axis(n_items: int, ids: np.ndarray, other: np.ndarray,
              vals: np.ndarray, max_nnz: Optional[int],
              round_to: int
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Group COO entries by ``ids`` and pad to a common width.

    Also returns, per original-COO-order entry, its flat position in the
    padded ``val`` buffer (for value re-scatter).
    """
    order = np.argsort(ids, kind="stable")
    ids_s, other_s, vals_s = ids[order], other[order], vals[order]
    counts = np.bincount(ids_s, minlength=n_items)
    width = int(counts.max()) if counts.size and counts.max() > 0 else 1
    if max_nnz is not None:
        width = max(width, 1)
        if width > max_nnz:
            raise ValueError(f"row with {width} nnz exceeds max_nnz={max_nnz}")
        width = max_nnz
    width = max(1, -(-width // round_to) * round_to)  # round up

    idx = np.zeros((n_items, width), dtype=np.int32)
    val = np.zeros((n_items, width), dtype=np.float32)
    mask = np.zeros((n_items, width), dtype=np.float32)
    # position of each entry within its row
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(ids_s.size) - starts[ids_s]
    idx[ids_s, pos] = other_s
    val[ids_s, pos] = vals_s
    mask[ids_s, pos] = 1.0
    # flat position in COO order (invert the sort permutation)
    flat = np.zeros(ids.size, dtype=np.int64)
    flat[order] = ids_s * width + pos
    return idx, val, mask, flat


def from_coo(i: np.ndarray, j: np.ndarray, v: np.ndarray,
             shape: Tuple[int, int], *,
             max_nnz_row: Optional[int] = None,
             max_nnz_col: Optional[int] = None,
             round_to: int = 8,
             device: DeviceLike = None) -> SparseMatrix:
    """Build a :class:`SparseMatrix` from COO triplets on ``device``."""
    dev = resolve_device(device)
    i = np.asarray(i, dtype=np.int64)
    j = np.asarray(j, dtype=np.int64)
    v = np.asarray(v, dtype=np.float32)
    n_rows, n_cols = shape

    ridx, rval, rmask, rflat = _pad_axis(n_rows, i, j, v, max_nnz_row,
                                         round_to)
    cidx, cval, cmask, cflat = _pad_axis(n_cols, j, i, v, max_nnz_col,
                                         round_to)

    nnz = v.size
    nnz_pad = max(1, -(-nnz // 128) * 128)
    coo_i = np.zeros((nnz_pad,), dtype=np.int32)
    coo_j = np.zeros((nnz_pad,), dtype=np.int32)
    coo_v = np.zeros((nnz_pad,), dtype=np.float32)
    coo_m = np.zeros((nnz_pad,), dtype=np.float32)
    # padding entries scatter to the one-past-end dump slot
    coo_rp = np.full((nnz_pad,), ridx.size, dtype=np.int64)
    coo_cp = np.full((nnz_pad,), cidx.size, dtype=np.int64)
    coo_i[:nnz], coo_j[:nnz], coo_v[:nnz], coo_m[:nnz] = i, j, v, 1.0
    coo_rp[:nnz], coo_cp[:nnz] = rflat, cflat

    def put(a: np.ndarray, dtype=None) -> torch.Tensor:
        a = a if dtype is None else a.astype(dtype)
        return torch.from_numpy(a).to(dev)

    return SparseMatrix(
        rows=PaddedRows(put(ridx), put(rval), put(rmask), n_cols),
        cols=PaddedRows(put(cidx), put(cval), put(cmask), n_rows),
        coo_i=put(coo_i), coo_j=put(coo_j), coo_v=put(coo_v),
        coo_mask=put(coo_m),
        coo_rpos=put(coo_rp, np.int32), coo_cpos=put(coo_cp, np.int32),
        shape=(n_rows, n_cols),
    )


def from_dense(R: np.ndarray, *, keep_zeros: bool = False,
               round_to: int = 8, device: DeviceLike = None) -> SparseMatrix:
    """A dense matrix as a :class:`SparseMatrix`: every cell observed
    (``keep_zeros=True``, "sparse fully known") or its nonzeros."""
    R = np.asarray(R, dtype=np.float32)
    if keep_zeros:
        i, j = np.meshgrid(np.arange(R.shape[0]), np.arange(R.shape[1]),
                           indexing="ij")
        i, j, v = i.ravel(), j.ravel(), R.ravel()
    else:
        i, j = np.nonzero(R)
        v = R[i, j]
    return from_coo(i, j, v, R.shape, round_to=round_to, device=device)


def random_sparse(key, shape: Tuple[int, int], density: float,
                  rank: int = 4, noise: float = 0.1,
                  binary: bool = False, round_to: int = 8,
                  device: DeviceLike = None):
    """Synthetic planted low-rank sparse matrix (ChEMBL-like benchmark).

    Returns (SparseMatrix train, (i,j,v) test triplets, (U*, V*) truth),
    the same numbers as ``repro.core.sparse.random_sparse``.
    """
    rng = np.random.default_rng(int(key) if np.isscalar(key) else 0)
    n_rows, n_cols = shape
    U = rng.normal(size=(n_rows, rank)).astype(np.float32)
    V = rng.normal(size=(n_cols, rank)).astype(np.float32)
    full = U @ V.T + noise * rng.normal(size=shape).astype(np.float32)
    if binary:
        full = (full > 0).astype(np.float32)

    nnz = int(density * n_rows * n_cols)
    nnz = max(nnz, n_rows + n_cols)  # keep every row/col touched
    flat = rng.choice(n_rows * n_cols, size=nnz, replace=False)
    i, j = np.divmod(flat, n_cols)
    v = full[i, j]
    # 90/10 train/test split
    n_test = max(1, nnz // 10)
    test = (i[:n_test], j[:n_test], v[:n_test])
    tr = slice(n_test, None)
    mat = from_coo(i[tr], j[tr], v[tr], shape, round_to=round_to,
                   device=device)
    return mat, test, (U, V)
