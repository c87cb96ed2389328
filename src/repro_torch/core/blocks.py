"""Multi-block matrix composition (paper Figure 2).

The counterpart of the ``EntityDef``/``BlockDef``/``ModelDef`` part of
``repro/core/blocks.py``, for sparse blocks.  A model is a set of
*entities* (things with a latent factor matrix) and a set of *blocks*,
each relating two entities through an observed matrix
R_b ~ U_row U_col^T.  ``DenseBlock`` is still to be ported (ROADMAP A2).

Where the reference's ``ModelDef`` carries ``use_pallas`` to choose
between kernel and oracle, the port's carries ``device``: the tensors'
device decides the path (``kernels/ops.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple


from .._device import resolve_device

Prior = Any    # NormalPrior
Noise = Any    # FixedGaussian | AdaptiveGaussian


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
    sparse: bool          # SparseMatrix payload (the only kind ported)

    def other(self, e: int) -> int:
        return self.col_entity if self.row_entity == e else self.row_entity


@dataclasses.dataclass(frozen=True)
class ModelDef:
    """The full static model graph.

    ``device`` is where the chain's state lives: ``None`` means the
    card, and raises when there is none (pass ``"cpu"`` for the CPU).
    """

    entities: Tuple[EntityDef, ...]
    blocks: Tuple[BlockDef, ...]
    num_latent: int
    device: Any = None

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
