"""The assigned input-shape set and arch x shape applicability."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeSpec:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    """None if the (arch, shape) cell runs; else the skip reason.

    long_500k needs sub-quadratic attention: only SSM/hybrid archs run
    it (full-attention archs would need an O(S^2) prefill and an O(S)
    per-token cache that the architecture was never trained for);
    skips are recorded in DESIGN.md §Arch-applicability.
    """
    if shape.name == "long_500k":
        has_ssm = any(s.mixer == "mamba2"
                      for s in cfg.pattern + cfg.prologue)
        if not has_ssm:
            return "full-attention arch: 500k decode skipped (quadratic)"
    return None
