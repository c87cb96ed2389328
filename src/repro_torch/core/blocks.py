"""Multi-block matrix composition (paper Figure 2, GFA).

The counterpart of ``repro/core/blocks.py``.  A model is a set of
*entities* (things with a latent factor matrix) and a set of *blocks*,
each relating two entities through an observed matrix
R_b ~ U_row U_col^T, held as a ``SparseMatrix`` (``core/sparse.py``) or
a ``DenseBlock``.

Where the reference's ``ModelDef`` carries ``use_pallas`` to choose
between kernel and oracle, the port's carries ``device``: the tensors'
device decides the path (``kernels/ops.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device

Prior = Any    # NormalPrior | MacauPrior | SpikeAndSlabPrior
               # | FixedNormalPrior
Noise = Any    # FixedGaussian | AdaptiveGaussian | ProbitNoise


@dataclasses.dataclass(frozen=True)
class DenseBlock:
    """A fully- or densely-observed matrix block.

    ``fully`` marks every cell observed, which lets the factor update
    share one (K, K) Gram across all rows.  Both orientations are held
    (``X``/``mask`` for the row entity's half-sweep, ``XT``/``maskT``
    for the column entity's), as in the reference.  A fully observed
    block's masks are broadcast views of one 1.0 (``expand``): they read
    as the reference's ones and take no memory.
    """

    X: torch.Tensor             # (n_rows, n_cols) f32
    mask: torch.Tensor          # (n_rows, n_cols) f32; ones when fully
    XT: torch.Tensor            # (n_cols, n_rows) f32 == X.T, contiguous
    maskT: torch.Tensor         # (n_cols, n_rows) f32 == mask.T
    fully: bool

    def oriented(self, as_row: bool):
        """(values, mask) with the updating entity along axis 0."""
        if as_row:
            return self.X, self.mask
        return self.XT, self.maskT

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.X.shape)

    @property
    def nnz(self) -> torch.Tensor:
        return self.mask.sum()

    @property
    def device(self) -> torch.device:
        return self.X.device


def dense_block(X, mask=None, device: DeviceLike = None) -> DenseBlock:
    """A :class:`DenseBlock` on ``device`` from host arrays or tensors
    (a tensor already on the device is not copied through the host).  A
    mask that is all ones is treated exactly like ``mask=None``
    (``fully=True``, the shared-Gram path), as the reference does."""
    dev = resolve_device(device)

    def put(a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(device=dev, dtype=torch.float32).contiguous()
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(a, np.float32))).to(dev)

    Xt = put(X)
    XTt = Xt.T.contiguous()
    m = None if mask is None else put(mask)
    if m is None or bool(torch.all(m == 1.0)):
        one = torch.ones((), dtype=torch.float32, device=dev)
        return DenseBlock(Xt, one.expand(Xt.shape), XTt,
                          one.expand(XTt.shape), fully=True)
    return DenseBlock(Xt, m, XTt, m.T.contiguous(), fully=False)


@dataclasses.dataclass(frozen=True)
class EntityDef:
    """Static description of one latent-factor entity."""

    name: str
    n_rows: int
    prior: Prior


@dataclasses.dataclass(frozen=True)
class BlockDef:
    """Static description of one observed block R_b ~ U_row U_col^T."""

    row_entity: int
    col_entity: int
    noise: Noise
    sparse: bool          # SparseMatrix payload vs DenseBlock payload

    def other(self, e: int) -> int:
        return self.col_entity if self.row_entity == e else self.row_entity


@dataclasses.dataclass(frozen=True)
class ModelDef:
    """The full static model graph.

    ``device`` is where the chain's state lives: ``None`` means the
    card, and raises when there is none (pass ``"cpu"`` for the CPU).

    ``bf16_gather``: cast the *fixed* factor to bf16 before the padded
    gather in each half-sweep.  On a sharded mesh the cast happens
    before the all-gather, halving the dominant collective payload;
    the Gram/rhs accumulation still runs in f32 (the conditioning
    values carry ~1e-3 relative noise -- immaterial to a Gibbs chain).
    The reference's flag: one bf16 copy of each other entity's factor
    serves every consumer of an entity update (``gibbs.gather_view``),
    and each consumer reads the bf16 values widened exactly at its
    products, as the reference's compiled sweep does
    (``core/gibbs.py`` says where it still rounds).
    """

    entities: Tuple[EntityDef, ...]
    blocks: Tuple[BlockDef, ...]
    num_latent: int
    device: Any = None
    bf16_gather: bool = False

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    def blocks_touching(self, e: int):
        """[(block_index, True-if-e-is-the-row-entity)]"""
        out = []
        for bi, b in enumerate(self.blocks):
            if b.row_entity == e:
                out.append((bi, True))
            if b.col_entity == e:
                out.append((bi, False))
        return out

    @property
    def entity_names(self) -> Tuple[str, ...]:
        return tuple(e.name for e in self.entities)

    def entity_index(self, entity) -> int:
        """Resolve an entity by name or index, with a naming error."""
        if isinstance(entity, str):
            names = self.entity_names
            if entity not in names:
                raise ValueError(
                    f"unknown entity {entity!r}; entities in this "
                    f"model: {', '.join(names)}")
            return names.index(entity)
        i = int(entity)
        if not 0 <= i < len(self.entities):
            raise ValueError(
                f"entity index {i} out of range; this model has "
                f"{len(self.entities)} entities: "
                f"{', '.join(self.entity_names)}")
        return i
